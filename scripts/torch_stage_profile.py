"""Where the time of the port's t128 forward, train step and Sformer forward
goes, on one GPU.

    python3 scripts/torch_stage_profile.py [--dtype bfloat16]
    python3 scripts/torch_stage_profile.py --train default [--dtype bfloat16]

Run from the root of a checkout on a host with an NVIDIA GPU, with the
weights and captures of ``chip_smoke.py`` (t128, batch 2, float32, TF32
off).  ``--dtype bfloat16`` measures the bfloat16 model instead
(``Config.with_bf16()``, the servers' default): sections 1 and 2 only, the
stages with its bf16 kernels and plain versions and its server's burst,
and writes ``chiprun_out/torch_stage_profile_bf16.json``.  ``--train
PRECISION`` measures section 3 alone, the train step at that matmul
precision ('default', 'high' or 'highest') for the model of ``--dtype``,
and writes ``chiprun_out/torch_stage_profile_train_{dtype}_{precision}
.json``.  It measures:

1. per stage of ``NlosPose.forward`` (FeatureExtraction, LCT, normalize,
   UNet, stem, layer1-4, head, soft-argmax), CUDA events around each
   stage, median of 5 forwards; with the kernels and with the plain
   versions, alternating (kernels, plain, kernels, plain);
2. the server over a 9-request burst under ``torch.profiler``: device
   time by kernel, and the device's idle share (1 - busy / wall, busy the
   union of the device kernels' intervals);
3. one t128 train step (``make_train_step``, batch ``make_batch([0, 1])``,
   after one warm-up step) under ``torch.profiler``: the same readings,
   its peak memory, and the device time of named pieces by (op, input
   shapes): the stem conv's matrix-product backward (products, patch
   copies, slab adds), the UNet's output conv, and the library backward of
   layer1's 1x1x1 conv1, of the head's last deconv and of the K4 blocks'
   weight gradient; then three forms of the output conv, forward and
   backward, beside each other;
4. one full-width float32 Sformer forward (``chip_smoke.py`` phase 7's
   model, weights and video): per stage (patch embed; per layer LayerNorm,
   qkv, joint-token read, rotary, grouped attention, out projection,
   feed-forward; head; the rest: patchify, head splits, regrouping,
   concatenations, residual adds), CUDA events, median of 5, kernels and
   plain alternating; then the forward under ``torch.profiler``; then the
   bfloat16 mode's stages.

Prints them and writes them to ``chiprun_out/torch_stage_profile.json``.
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
# K4's conv kernel and its weight preparation (csrc/conv3mxu.cu), printed
# by name under the profiler: the preparation is part of every K4 call
K4_KERNELS = ("conv3_tf32x3_kernel", "prep_kernel")
# K2's conv and its weight preparation (csrc/stem_conv.cu), in the burst
STEM_KERNELS = ("stem_conv_tc_kernel", "stem_weights_kernel")
# the bf16 model's kernels: K4-bf16 and K2-bf16 with their weight
# preparations, K1 (one kernel for both types), K3-bf16
BF16_KERNELS = ("conv3_bf16_kernel", "prep_bf16_kernel",
                "stem_conv_bf16_kernel", "stem_weights_bf16_kernel",
                "conv3p_tile_kernel", "maxpool_k3s2p1_bf16_kernel")
# K9's device kernels: the grouped form, the split over the keys (the
# joint-token read) and the pass that combines its chunks.
K9_KERNELS = ("attend_tc_kernel", "attend_tc_split_kernel", "combine_kernel")
# K6's two passes, K7 and K8, by device kernel; K4-bf16's kernel and its
# weight preparation are K4-dx-bf16's in a step at 'default'
TRAIN_KERNELS = K4_KERNELS + ("conv3p_wgrad_partial", "conv3p_wgrad_reduce",
                              "maxpool_k3s2p1_vjp_kernel",
                              "maxpool2_bwd_kernel", "conv3_bf16_kernel",
                              "prep_bf16_kernel", "conv3p_tile_kernel",
                              "maxpool_k3s2p1_bf16_kernel")
# Pieces of the t128 batch-2 train step, by (op, input shapes): a label and
# the substrings a profiler key must hold.  The stem conv's matrix-product
# backward (ops/stem_vjp.py: per sample and depth tap one batched product
# over the 128 planes for dk, one (49 x 64) . (64 x 128^3) product and 49
# slab adds for dx), the UNet's output conv (a broadcast multiply and a
# channel sum, forward and backward), and three library backward ops that
# are read here and ported nowhere.
TRAIN_OPS = {
    "stem dk: patch copies": ("aten::copy_", "[128, 7, 7, 128, 128]"),
    "stem dk: batched products": ("aten::bmm", "[128, 49, 16384]"),
    "stem dk: plane sums": ("aten::sum", "[128, 49, 64]"),
    "stem dx: products": ("aten::mm", "[49, 64], [64, 2097152]"),
    "stem dx: slab adds": ("aten::add_",
                           "[[128, 128, 128], [128, 128, 128]"),
    "output conv, forward and backward": ("[2, 1, 4, 128, 128, 128]",),
    "layer1 1x1x1 conv1 backward (256 -> 64)": (
        "convolution_backward", "[64, 256, 1, 1, 1]"),
    "layer1 1x1x1 conv1 backward (64 -> 64)": (
        "convolution_backward", "[64, 64, 1, 1, 1]"),
    "head's last deconv backward": (
        "convolution_backward", "[2, 256, 32, 32, 32]", "[256, 256, 4, 4, 4]"),
    "K4 blocks' library dk, c64": (
        "convolution_backward", "[64, 64, 3, 3, 3]"),
    "stem conv's library backward (none with the kernels on)": (
        "convolution_backward", "[64, 1, 7, 7, 7]"),
}


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


SFORMER_STAGES = ("patch embed", "layernorm", "qkv", "joint read", "rotary",
                  "grouped attention", "out proj", "feed-forward", "head",
                  "other")


def sformer_stage_times(model, video):
    """ms per stage of one Sformer forward, summed over the layers: every
    timed piece is wrapped in a pair of CUDA events; "other" is the whole
    forward less the pieces."""
    from hiddenpose_tpu_torch.models import sformer as S

    events = []

    def timed(stage, fn):
        def run(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            events.append((stage(*args) if callable(stage) else stage,
                           start, end))
            return out
        return run

    def attend_stage(q, k, v):
        return ("joint read" if q.shape[1] == model.num_joints
                else "grouped attention")

    patched = []

    def patch(obj, name, stage):
        patched.append((obj, name, obj.__dict__.get(name)))
        setattr(obj, name, timed(stage, getattr(obj, name)))

    for name, m in model.named_modules():
        leaf = name.split(".")[-1]
        if name == "patch_embed":
            patch(m, "forward", "patch embed")
        elif name in ("out_ln", "out_proj"):
            patch(m, "forward", "head")
        elif isinstance(m, torch.nn.LayerNorm):
            patch(m, "forward", "layernorm")
        elif leaf == "to_qkv":
            patch(m, "forward", "qkv")
        elif leaf == "to_out":
            patch(m, "forward", "out proj")
        elif isinstance(m, S.GEGLUFeedForward):
            patch(m, "forward", "feed-forward")
        elif isinstance(m, S.JointTokenAttention):
            patch(m, "_attend", attend_stage)
    rotary = S.apply_rotary
    S.apply_rotary = timed("rotary", rotary)
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        S.serve_video(model, video)
        end.record()
        torch.cuda.synchronize()
    finally:
        S.apply_rotary = rotary
        for obj, name, old in patched:
            if old is None:
                delattr(obj, name)
            else:
                setattr(obj, name, old)
    ms = dict.fromkeys(SFORMER_STAGES, 0.0)
    for stage, s, e in events:
        ms[stage] += s.elapsed_time(e)
    total = start.elapsed_time(end)
    ms["other"] = total - sum(ms.values())
    return dict(ms, total=total)


def sformer_profile(dev, smi):
    """Stage table of the full-width Sformer forward (f32 kernels / plain,
    then bf16) and its profile by device kernel."""
    from hiddenpose_tpu_torch.config import t128_config
    from hiddenpose_tpu_torch.models.sformer import build_sformer, serve_video

    cfg = t128_config().model
    weights = chip_smoke.sformer_weights(cfg)
    video = chip_smoke.sformer_videos(dev, seeds=(0,))[0]
    out = {}

    def table(tag, model):
        sformer_stage_times(model, video)  # warm
        reps = [sformer_stage_times(model, video) for _ in range(5)]
        med = {k: float(np.median([r[k] for r in reps])) for k in reps[0]}
        print(f"[sformer stages] {tag} total {med['total']:.3f} ms "
              + json.dumps({k: round(v, 3) for k, v in med.items()}),
              flush=True)
        return med

    model = build_sformer(cfg, device=dev, dtype="float32")
    model.load_state_dict(weights)
    out["f32"] = []
    for flag in (True, False, True, False):
        model.set_use_kernels(flag)
        out["f32"].append(dict(
            use_kernels=flag,
            ms=table(f"f32 use_kernels={flag}", model)))
    model.set_use_kernels(True)
    out["f32_profile"] = device_profile(
        "sformer f32", lambda: serve_video(model, video), also=K9_KERNELS)
    del model
    torch.cuda.empty_cache()
    model = build_sformer(cfg, device=dev, dtype="bfloat16")
    model.load_state_dict(weights)
    out["bf16"] = table("bf16 use_kernels=True", model)
    out["bf16_profile"] = device_profile(
        "sformer bf16", lambda: serve_video(model, video), also=K9_KERNELS)
    print(smi, flush=True)
    return out


def device_profile(tag, fn, also=(), ops_like=None):
    """Run ``fn`` under torch.profiler; print and return wall time, device
    busy time, idle share, the 15 kernels with the most device time and the
    12 (op, input shapes) pairs with the most device time of their own.
    Kernels whose name holds one of ``also`` are printed whatever their
    rank, with their launches and mean time; ``ops_like`` (label ->
    substrings) sums the device time of the (op, input shapes) keys that
    hold every substring."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = chip_smoke.busy_seconds(kern)
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
    named = {}
    for part in also:
        hits = [e for e in kern if part in e.name]
        ms = sum(e.time_range.end - e.time_range.start for e in hits) / 1e3
        named[part] = dict(launches=len(hits), device_ms=ms)
        print(f"[{tag}] {part}: {len(hits)} launches, {ms:.3f} ms, "
              f"{1e3 * ms / max(len(hits), 1):.2f} us each")
    by_op = {}
    for e in prof.key_averages(group_by_input_shape=True):
        ms = e.self_device_time_total / 1e3
        if ms > 0 and e.device_type == torch.autograd.DeviceType.CPU:
            by_op[f"{e.key} {e.input_shapes}"] = ms
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
    for name, ms in top_ops:
        print(f"[{tag}] op {ms:10.3f} ms {100 * ms / total:6.2f}%  "
              f"{name[:150]}")
    pieces = {}
    for label, parts in (ops_like or {}).items():
        hits = {k: v for k, v in by_op.items() if all(p in k for p in parts)}
        pieces[label] = dict(device_ms=sum(hits.values()), keys=len(hits))
        print(f"[{tag}] piece {sum(hits.values()):10.3f} ms in {len(hits)} "
              f"(op, shapes) keys: {label}")
    return dict(wall_s=wall, busy_s=busy, idle_share=1 - busy / wall,
                device_ms_total=total, device_ms_by_kernel=dict(top),
                named_kernels=named, pieces=pieces,
                device_ms_by_op_and_shapes=dict(top_ops))


def train_profile(model, lct, cfg, dev, precision):
    """Section 3: one train step at ``precision`` under the profiler, after
    one warm-up step (cuDNN's algorithm choice), and its peak memory."""
    from hiddenpose_tpu_torch.config import TrainConfig
    from hiddenpose_tpu_torch.data.synthetic import make_batch
    from hiddenpose_tpu_torch.train.state import TrainState
    from hiddenpose_tpu_torch.train.step import make_train_step

    m = cfg.model
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        [0, 1], m.time_size, m.image_size[0], m.grid_dim, m.heatmap_size[0],
        m.bin_len).items()}
    state = TrainState.create(model, TrainConfig())
    step = make_train_step(model, matmul_precision=precision)
    step(state, batch, lct)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    train = device_profile("train", lambda: step(state, batch, lct),
                           also=TRAIN_KERNELS, ops_like=TRAIN_OPS)
    train["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    print(f"[train] {m.compute_dtype} at {precision!r}: peak memory "
          f"{train['peak_memory_bytes'] / 2**30:.3f} GiB", flush=True)
    return train


def out_conv_forms(dev):
    """The UNet's 1x1x1 output conv at (2, 4, 128^3) -> (2, 1, 128^3),
    forward and backward (ms, CUDA events, mean of 5, in turns): the
    broadcast multiply and channel sum the port uses, ``torch.einsum``
    (the reference's form, a batched product with K = 4), and the library
    conv whose backward the port left."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((B, 4, 128, 128, 128), generator=g,
                    device=dev).requires_grad_()
    w = torch.randn((1, 4), generator=g, device=dev).requires_grad_()
    bias = torch.randn((1,), generator=g, device=dev).requires_grad_()
    gy = torch.randn((B, 1, 128, 128, 128), generator=g, device=dev)
    forms = {
        "broadcast multiply + sum": lambda: (
            x.unsqueeze(1) * w[None, :, :, None, None, None]).sum(2),
        "einsum": lambda: torch.einsum("bcdhw,oc->bodhw", x, w),
        "library conv3d": lambda: F.conv3d(x, w[:, :, None, None, None]),
    }
    out = {}
    for _ in range(2):
        for name, fn in forms.items():
            ms = chip_smoke.cuda_ms(lambda: torch.autograd.grad(
                fn() + bias[None, :, None, None, None], (x, w, bias), gy), 5)
            out.setdefault(name, []).append(ms)
    for name, ms in out.items():
        print(f"[out conv] forward + backward, {name}: "
              f"{[round(t, 3) for t in ms]} ms", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose
    from hiddenpose_tpu_torch.serve import InferenceServer

    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--train", choices=("default", "high", "highest"))
    args = ap.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = chip_smoke.smi_line()
    cfg, caps = chip_smoke.t128_captures(9)
    sd = chip_smoke.t128_weights(cfg)
    bf16 = args.dtype == "bfloat16"
    if bf16:
        cfg = cfg.with_bf16()
    model, lct = build_nlospose(cfg.model, device=dev)
    model.load_state_dict(sd)
    if args.train:
        train = train_profile(model, lct, cfg, dev, args.train)
        print(smi, flush=True)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / f"torch_stage_profile_train_{args.dtype}_{args.train}.json"
         ).write_text(json.dumps(dict(device=smi, dtype=args.dtype,
                                      precision=args.train,
                                      train_step=train), indent=1))
        return 0
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

    server = InferenceServer(cfg, sd, batch_size=B, dtype=args.dtype,
                             device=dev)
    try:
        server.warmup()
        burst = device_profile("burst", lambda: [
            f.result(timeout=600) for f in [server.submit(c) for c in caps]],
            also=BF16_KERNELS if bf16 else K4_KERNELS + STEM_KERNELS)
    finally:
        server.close()
    del server
    if bf16:
        print(smi, flush=True)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "torch_stage_profile_bf16.json").write_text(json.dumps(dict(
            device=smi, dtype=args.dtype, stages=stages,
            burst=dict(requests=len(caps), **burst)), indent=1))
        return 0

    model, lct = build_nlospose(cfg.model, device=dev)
    model.load_state_dict(sd)
    train = train_profile(model, lct, cfg, dev, "highest")
    out_conv = out_conv_forms(dev)
    print(smi, flush=True)
    del model
    torch.cuda.empty_cache()
    sformer = sformer_profile(dev, smi)

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_stage_profile.json").write_text(json.dumps(dict(
        device=smi, stages=stages, burst=dict(requests=len(caps), **burst),
        train_step=train, out_conv_forms=out_conv, sformer=sformer),
        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
