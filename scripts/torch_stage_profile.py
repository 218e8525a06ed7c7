"""Where the time of the port's t128 forward and train step goes, on one GPU.

    python3 scripts/torch_stage_profile.py

Run from the root of a checkout on a host with an NVIDIA GPU, with the
weights and captures of ``chip_smoke.py`` (t128, batch 2, float32, TF32
off).  It measures:

1. per stage of ``NlosPose.forward`` (FeatureExtraction, LCT, normalize,
   UNet, stem, layer1-4, head, soft-argmax), CUDA events around each
   stage, median of 5 forwards; with the kernels and with the plain
   versions, alternating (kernels, plain, kernels, plain);
2. the server over a 9-request burst under ``torch.profiler``: device
   time by kernel, and the device's idle share (1 - busy / wall, busy the
   union of the device kernels' intervals);
3. one t128 train step (``make_train_step``, batch ``make_batch([0, 1])``,
   after one warm-up step) under ``torch.profiler``: the same readings.

Prints both and writes them to ``chiprun_out/torch_stage_profile.json``.
Imports no JAX.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the smoke run's weights and captures)

B = chip_smoke.B


def stage_times(model, lct, meas, batch_chunk):
    """ms per stage of one forward, timed with CUDA events."""
    from hiddenpose_tpu_torch.ops.lct import lct_apply
    from hiddenpose_tpu_torch.ops.normalize import normalize_feature
    from hiddenpose_tpu_torch.ops.softargmax import softmax_integral

    pn = model.pose_net
    b = meas.shape[0]
    events = {}

    def run(name, fn, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        events[name] = (start, end)
        return out

    f = run("feature_extraction", model.feature_extraction, meas)
    ch = f.shape[1]
    v = run("lct", lambda t: lct_apply(t.reshape(b * ch, *t.shape[2:]), lct,
                                       batch_chunk=batch_chunk), f)
    feat = run("normalize", lambda t: normalize_feature(
        t.reshape(b, ch, *t.shape[1:])), v)
    refine = run("unet", model.autoencoder, feat)
    h = run("stem", pn.stem, feat + refine)
    for i in range(1, 5):
        h = run(f"layer{i}", getattr(pn, f"layer{i}"), h)
    hm = run("head", pn.head, h)
    run("softargmax", lambda t: softmax_integral(t.contiguous(), t.shape[1]),
        hm)
    torch.cuda.synchronize()
    return {k: s.elapsed_time(e) for k, (s, e) in events.items()}


def busy_seconds(events) -> float:
    """Length of the union of the device events' [start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in events):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e6  # profiler times are in microseconds


def device_profile(tag, fn):
    """Run ``fn`` under torch.profiler; print and return wall time, device
    busy time, idle share, the 15 kernels with the most device time and the
    12 (op, input shapes) pairs with the most device time of their own."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_seconds(kern)
    by_kernel = {}
    for e in kern:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    total = sum(by_kernel.values())
    print(f"[{tag}] wall {wall:.4f} s, device busy {busy:.4f} s, idle share "
          f"{1 - busy / wall:.4f}, {len(kern)} device events", flush=True)
    for name, ms in top:
        print(f"[{tag}] {ms:10.3f} ms {100 * ms / total:6.2f}%  {name[:90]}")
    by_op = {}
    for e in prof.key_averages(group_by_input_shape=True):
        ms = e.self_device_time_total / 1e3
        if ms > 0 and e.device_type == torch.autograd.DeviceType.CPU:
            by_op[f"{e.key} {e.input_shapes}"] = ms
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
    for name, ms in top_ops:
        print(f"[{tag}] op {ms:10.3f} ms {100 * ms / total:6.2f}%  "
              f"{name[:150]}")
    return dict(wall_s=wall, busy_s=busy, idle_share=1 - busy / wall,
                device_ms_total=total, device_ms_by_kernel=dict(top),
                device_ms_by_op_and_shapes=dict(top_ops))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from hiddenpose_tpu_torch.config import TrainConfig
    from hiddenpose_tpu_torch.data.synthetic import make_batch
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose
    from hiddenpose_tpu_torch.serve import InferenceServer
    from hiddenpose_tpu_torch.train.state import TrainState
    from hiddenpose_tpu_torch.train.step import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = chip_smoke.smi_line()
    cfg, caps = chip_smoke.t128_captures(9)
    sd = chip_smoke.t128_weights(cfg)
    model, lct = build_nlospose(cfg.model, device=dev)
    model.load_state_dict(sd)
    meas = torch.from_numpy(np.stack(caps[:B])).to(dev)

    stages = []
    with torch.inference_mode():
        for flag in (True, False, True, False):
            model.set_use_kernels(flag)
            stage_times(model, lct, meas, cfg.model.lct_batch_chunk)  # warm
            reps = [stage_times(model, lct, meas, cfg.model.lct_batch_chunk)
                    for _ in range(5)]
            med = {k: float(np.median([r[k] for r in reps])) for k in reps[0]}
            stages.append(dict(use_kernels=flag, total_ms=sum(med.values()),
                               ms=med))
            print(f"[stages] use_kernels={flag} total "
                  f"{sum(med.values()):.3f} ms "
                  + json.dumps({k: round(v, 3) for k, v in med.items()}),
                  flush=True)
    del model

    server = InferenceServer(cfg, sd, batch_size=B, dtype="float32",
                             device=dev)
    try:
        server.warmup()
        burst = device_profile("burst", lambda: [
            f.result(timeout=600) for f in [server.submit(c) for c in caps]])
    finally:
        server.close()
    del server

    model, lct = build_nlospose(cfg.model, device=dev)
    model.load_state_dict(sd)
    m = cfg.model
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        [0, 1], m.time_size, m.image_size[0], m.grid_dim, m.heatmap_size[0],
        m.bin_len).items()}
    state = TrainState.create(model, TrainConfig())
    step = make_train_step(model)
    step(state, batch, lct)  # warm-up: cuDNN's algorithm choice
    torch.cuda.synchronize()
    train = device_profile("train", lambda: step(state, batch, lct))
    print(smi, flush=True)

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_stage_profile.json").write_text(json.dumps(dict(
        device=smi, stages=stages, burst=dict(requests=len(caps), **burst),
        train_step=train), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
