"""Smoke test of the PyTorch/CUDA port (hiddenpose_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a host with an NVIDIA H100.  Phases,
each printing what it did; any failure exits non-zero before the result
lines:

1. toolchain: torch, CUDA, the card (compute capability must be 9.0),
   nvcc, and the card's name and power limit from nvidia-smi;
2. build: the four kernels of ``hiddenpose_tpu_torch/csrc`` with nvcc;
3. kernels vs plain: each kernel against its plain PyTorch version at the
   t128 batch-2 shapes of the inference path (TF32 off), error and time;
4. serve: ``InferenceServer(t128_config(), batch_size=2, dtype="float32",
   device="cuda:0")`` answers 9 synthetic captures (a padded tail batch),
   with every kernel's launch count above 0 afterwards, and a capture
   served alone equals the same capture served in a batch;
5. end to end: one batch through the kernels and through the plain
   versions on the same weights; heatmaps and joints must agree.

The comparisons (kernel vs plain, alone vs batched, end to end) run with
``torch.use_deterministic_algorithms(True)``, so a reading does not move
from run to run; every timed run keeps the libraries' default algorithms.

Then one JSON line of per-kernel results, the nvidia-smi line, and the
last line ``{"ok": true, "device": {...}}``.  Detailed per-shape results
go to ``chiprun_out/chip_smoke.json``.  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
B = 2  # the serving batch

# Tolerances, kernel vs plain, both f32 with TF32 off: they differ only in
# summation order, a few ulps of the output scale.  Max-pool selects
# values and must match exactly.
CONV_TOL = 1e-4     # max |kernel - plain| / max |plain|
E2E_HM_TOL = 1e-4   # heatmaps, max |kernel - plain| / max |plain|
# Joints, max abs error in heatmap voxels.  The kernels sum in another
# order than cuDNN: the heatmaps differ by a few 1e-6 of their peak, and
# the peaked soft-argmax turns that into about 1e-3 voxel.  The reading is
# deterministic (same weights, inputs and algorithms every run).
E2E_JOINT_TOL = 1e-2
# Joints, served alone vs in a batch, voxels.  Eval BatchNorm, GroupNorm
# and the FFT are per sample, so with deterministic algorithms a request's
# result does not depend on its batch-mate.
BATCH_TOL = 1e-4


@contextlib.contextmanager
def deterministic():
    """cuDNN's and cuBLAS's deterministic algorithms, for the comparisons
    only.  (cuDNN's default transposed conv, the head's deconvs,
    accumulates with atomics: two runs of one batch differ in the last
    bits of the heatmaps.)"""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_toolchain() -> str:
    from hiddenpose_tpu_torch.ops.kernels import _build

    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    log(f"[1 toolchain] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} capability {cap} count {torch.cuda.device_count()}")
    if cap != (9, 0):
        raise RuntimeError(f"needs compute capability (9, 0), got {cap}")
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    for line in nvcc.stdout.strip().splitlines()[-2:]:
        log("[1 toolchain] " + line)
    smi = smi_line()
    log(f"[1 toolchain] nvidia-smi: {smi}")
    return smi


def phase_build() -> None:
    from hiddenpose_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"[2 build] {len(_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    for line in _build.build_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            log("[2 build] " + line.strip())


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, kernel_fn, plain_fn, iters, exact=False):
    """Error and times (plain, kernel, kernel, plain) of one call shape."""
    with deterministic():
        got = kernel_fn()
        want = plain_fn()
        torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if exact:
        ok = err == 0.0
    else:
        ok = bool(torch.isfinite(got).all()) and err <= CONV_TOL * max(scale,
                                                                       1e-30)
    p1 = cuda_ms(plain_fn, iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, iters)
    res = dict(shape=name, max_abs_err=err, max_abs_ref=scale,
               ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
    log(f"[3 kernels] {name}: max_abs_err {err:.3e} (ref max {scale:.3e}) "
        f"kernel {res['ms']:.4f} ms plain {res['plain_ms']:.4f} ms")
    if not ok:
        raise RuntimeError(f"{name}: kernel disagrees with plain version")
    return res


# K1 call shapes of one t128 forward: (c_in, c_out, extent, pad, act,
# residual, count per forward).  FeatureExtraction at 128^3, then the UNet
# level by level (its convs are followed by GroupNorm: act none).
K1_SHAPES = [
    (1, 1, 128, "edge", "none", False, 1),     # FE conv_in
    (1, 1, 128, "edge", "leaky", False, 2),    # ResConv3D conv1
    (1, 1, 128, "edge", "leaky", True, 2),     # ResConv3D conv2
    (1, 1, 128, "zero", "none", True, 1),      # corner conv + learned branch
    (1, 4, 128, "zero", "none", False, 1),     # UNet conv
    (4, 4, 128, "zero", "none", False, 2),     # conv, dec4
    (4, 8, 64, "zero", "none", False, 1),      # enc1
    (8, 8, 64, "zero", "none", False, 1),
    (8, 16, 32, "zero", "none", False, 1),     # enc2
    (16, 16, 32, "zero", "none", False, 1),
    (16, 32, 16, "zero", "none", False, 1),    # enc3
    (32, 32, 16, "zero", "none", False, 1),
    (32, 32, 8, "zero", "none", False, 2),     # enc4
    (64, 16, 16, "zero", "none", False, 1),    # dec1
    (16, 16, 16, "zero", "none", False, 1),
    (32, 8, 32, "zero", "none", False, 1),     # dec2
    (8, 8, 32, "zero", "none", False, 1),
    (16, 4, 64, "zero", "none", False, 1),     # dec3
    (4, 4, 64, "zero", "none", False, 1),
    (8, 4, 128, "zero", "none", False, 1),     # dec4
]
# K4 call shapes: (width, extent, stride-1 blocks per forward).
K4_SHAPES = [(64, 64, 3), (128, 32, 3), (256, 16, 5)]


def phase_kernels(dev):
    from hiddenpose_tpu_torch.ops import kernels as K

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    rows = {name: [] for name in K.KERNELS}
    for cin, cout, n, pad, act, res, count in K1_SHAPES:
        x = randn(B, cin, n, n, n)
        k = randn(3, 3, 3, cin, cout, scale=(27 * cin) ** -0.5)
        bias = randn(cout, scale=0.1)
        r = randn(B, cout, n, n, n) if res else None
        kw = dict(act=act, pad_mode=pad)
        row = compare(
            f"conv3_planes {cin}->{cout} @{n}^3 {pad} {act}"
            f"{' +residual' if res else ''}",
            lambda: K.conv3_planes(x, k, bias, r, **kw),
            lambda: K.conv3_planes_ref(x, k, bias, r, **kw), iters=20)
        row["per_forward"] = count
        rows["conv3_planes"].append(row)

    x = torch.rand((B, 128, 128, 128, 1), generator=g, device=dev)
    k = randn(7, 7, 7, 1, 64, scale=343 ** -0.5)
    scale = torch.rand(64, generator=g, device=dev) + 0.5
    shift = randn(64, scale=0.1)
    row = compare("stem_conv_raw (2,128^3,1)->(2,128^3,64)",
                  lambda: K.stem_conv_raw(x, k, scale, shift),
                  lambda: K.stem_conv_raw_ref(x, k, scale, shift), iters=5)
    row["per_forward"] = 1
    rows["stem_conv_raw"].append(row)

    # the real pool input: post-ReLU stem output, many exact-zero ties
    y = K.stem_conv_raw(x, k, scale, shift - 0.5)
    zeros = (y == 0).float().mean().item()
    row = compare(f"maxpool3d_k3s2p1 (2,128^3,64) ties ({zeros:.0%} zeros)",
                  lambda: K.maxpool3d_k3s2p1(y),
                  lambda: K.maxpool3d_k3s2p1_ref(y), iters=10, exact=True)
    row["per_forward"] = 1
    rows["maxpool3d_k3s2p1"].append(row)

    for c, n, count in K4_SHAPES:
        x = randn(B, n, n, n, c)
        k = randn(3, 3, 3, c, c, scale=(27 * c) ** -0.5)
        sc = torch.rand(c, generator=g, device=dev) + 0.5
        sh = randn(c, scale=0.1)
        row = compare(f"conv3_mxu c{c}@{n}^3 +bn+relu",
                      lambda: K.conv3_mxu(x, k, sc, sh, relu=True),
                      lambda: K.conv3_mxu_ref(x, k, sc, sh, relu=True),
                      iters=5)
        row["per_forward"] = count
        rows["conv3_mxu"].append(row)
    return rows


def t128_captures(n: int):
    """``n`` synthetic t128 captures (seeds 0..n-1) and the t128 config."""
    from hiddenpose_tpu_torch.config import t128_config
    from hiddenpose_tpu_torch.data.synthetic import make_sample

    cfg = t128_config()
    m = cfg.model
    return cfg, [make_sample(s, m.time_size, m.image_size[0], m.grid_dim,
                             m.heatmap_size[0], m.bin_len)["meas"]
                 for s in range(n)]


def t128_weights(cfg):
    """The port's peaked random weights (seed 1) for ``cfg``."""
    from hiddenpose_tpu_torch.models.nlospose import NlosPose
    from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict

    with torch.device("meta"):  # names and shapes only
        template = NlosPose(cfg.model)
    return peaked_state_dict(template, seed=1)


def phase_serve(dev, smi):
    from hiddenpose_tpu_torch.ops import kernels as K
    from hiddenpose_tpu_torch.serve import InferenceServer

    t0 = time.perf_counter()
    cfg, caps = t128_captures(9)
    log(f"[4 serve] 9 synthetic t128 captures in "
        f"{time.perf_counter() - t0:.1f} s")
    server = InferenceServer(cfg, t128_weights(cfg), batch_size=B,
                             dtype="float32", device=dev)
    try:
        t0 = time.perf_counter()
        server.warmup()
        log(f"[4 serve] warm-up request {time.perf_counter() - t0:.2f} s")

        # closed loop: one request at a time, each served alone (its
        # batch padded with copies of itself)
        lat1 = []
        for c in caps[:5]:
            t0 = time.perf_counter()
            server.infer(c)
            lat1.append(time.perf_counter() - t0)

        before = server.stats()
        K.reset_launch_counts()
        t_sub, t_done = {}, {}
        start = time.perf_counter()
        futs = []
        for i, c in enumerate(caps):
            t_sub[i] = time.perf_counter()
            f = server.submit(c)
            f.add_done_callback(
                lambda _f, i=i: t_done.__setitem__(i, time.perf_counter()))
            futs.append(f)
        results = [f.result(timeout=600)["joints"] for f in futs]
        wall = time.perf_counter() - start
        counts = K.launch_counts()
        stats = {k: v - before[k] for k, v in server.stats().items()
                 if k in ("batches", "padded")}

        for j in results:
            if j.shape != (24, 3) or not np.isfinite(j).all():
                raise RuntimeError(f"bad joints {j.shape}")
        lat = sorted(t_done[i] - t_sub[i] for i in range(len(caps)))
        log(f"[4 serve] {len(caps)} requests in {stats['batches']} batches "
            f"({stats['padded']} padded) in {wall:.3f} s: "
            f"{len(caps) / wall:.3f} volumes/s, p50 latency "
            f"{lat[len(lat) // 2] * 1000:.1f} ms under the burst; closed-loop "
            f"p50 {sorted(lat1)[2] * 1000:.1f} ms  [{smi}]")
        log(f"[4 serve] launch counts over the burst: {counts}")
        if min(counts.values()) <= 0:
            raise RuntimeError(f"a kernel never launched: {counts}")
        per_forward = {
            "conv3_planes": sum(row[-1] for row in K1_SHAPES),
            "stem_conv_raw": 1, "maxpool3d_k3s2p1": 1,
            "conv3_mxu": sum(row[-1] for row in K4_SHAPES)}
        want = {k: v * stats["batches"] for k, v in per_forward.items()}
        if counts != want:
            raise RuntimeError(f"launch counts {counts}, expected {want}")

        # captures 0-4 alone, then all five at once: batches (0, 1),
        # (2, 3) and 4 padded
        with deterministic():
            alone = [server.infer(c)["joints"] for c in caps[:5]]
            batched = [f.result(timeout=600)["joints"]
                       for f in [server.submit(c) for c in caps[:5]]]
        d = float(np.abs(np.stack(batched) - np.stack(alone)).max())
        log(f"[4 serve] captures 0-4 alone vs in batches (deterministic "
            f"algorithms): max |d joints| {d:.3e} voxels (tolerance "
            f"{BATCH_TOL})")
        if d > BATCH_TOL:
            raise RuntimeError("per-request result depends on the batch")
        joints_spread = float(np.ptp(np.stack(results)))
        serve = dict(requests=len(caps), wall_s=wall,
                     volumes_per_s=len(caps) / wall,
                     p50_latency_ms=lat[len(lat) // 2] * 1000,
                     closed_loop_p50_ms=sorted(lat1)[2] * 1000,
                     batches=stats["batches"], padded=stats["padded"],
                     launches=counts, joints_spread_voxels=joints_spread)
    finally:
        server.close()
    return server, caps, serve, counts


def phase_end_to_end(server, caps):
    from hiddenpose_tpu_torch.train.step import make_forward

    model = server.model
    fwd = make_forward(model)
    meas = torch.from_numpy(np.stack(caps[:B])).to(server.device)
    out = {}
    for flag in (True, False):
        model.set_use_kernels(flag)
        ms = cuda_ms(lambda: fwd(meas, server.lct), iters=5)
        with deterministic():
            joints, hm = fwd(meas, server.lct)
        out[flag] = (joints.float(), hm.float(), ms)
    model.set_use_kernels(True)
    jk, hk, ms_k = out[True]
    jp, hp, ms_p = out[False]
    hm_rel = ((hk - hp).abs().max() / hp.abs().max()).item()
    j_abs = (jk - jp).abs().max().item()
    log(f"[5 e2e] heatmaps max rel err {hm_rel:.3e} (tolerance {E2E_HM_TOL}),"
        f" joints max abs err {j_abs:.3e} voxels (tolerance {E2E_JOINT_TOL});"
        f" forward b{B}: kernels {ms_k:.2f} ms, plain {ms_p:.2f} ms;"
        f" heatmap range [{hp.min().item():.3g}, {hp.max().item():.3g}]")
    if not (torch.isfinite(hk).all() and hm_rel <= E2E_HM_TOL
            and j_abs <= E2E_JOINT_TOL):
        raise RuntimeError("kernels and plain versions disagree end to end")
    return dict(hm_max_rel_err=hm_rel, joints_max_abs_err=j_abs,
                forward_ms_kernels=ms_k, forward_ms_plain=ms_p)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke test runs only on a GPU", file=sys.stderr)
        return 2
    # cuBLAS is deterministic only with a fixed workspace; set before the
    # first CUDA call (deterministic() checks for it)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # full f32 for the plain versions and the library convs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda:0")

    smi = phase_toolchain()
    phase_build()
    rows = phase_kernels(dev)
    server, caps, serve, counts = phase_serve(dev, smi)
    e2e = phase_end_to_end(server, caps)

    from hiddenpose_tpu_torch.ops.kernels import KERNELS

    kernels = []
    for name, (_, _, source, replaces) in KERNELS.items():
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name],
            max_abs_err=max(x["max_abs_err"] for x in r),
            # device time of one b2 forward's calls to this kernel
            ms=sum(x["ms"] * x["per_forward"] for x in r),
            plain_ms=sum(x["plain_ms"] * x["per_forward"] for x in r)))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(dict(
        device=smi, kernels=rows, serve=serve, end_to_end=e2e), indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
