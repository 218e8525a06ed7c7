"""Smoke test of the PyTorch/CUDA port (hiddenpose_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a host with an NVIDIA H100.  Phases,
each printing what it did; any failure exits non-zero before the result
lines:

1. toolchain: torch, CUDA, the card (compute capability must be 9.0),
   nvcc, and the card's name and power limit from nvidia-smi;
2. build: the kernels of ``hiddenpose_tpu_torch/csrc`` with nvcc, one
   process per source, all at once;
3. kernels vs plain: each kernel against its plain PyTorch version at the
   t128 batch-2 shapes of the inference path and of the train step
   (TF32 off), error and time;
4. serve: ``InferenceServer(t128_config(), batch_size=2, dtype="float32",
   device="cuda:0")`` answers 9 synthetic captures (a padded tail batch),
   with every serving kernel's launch count as expected afterwards, and a
   capture served alone equals the same capture served in a batch;
5. end to end: one batch through the kernels and through the plain
   versions on the same weights; heatmaps and joints must agree;
6. train: the t128 model at full width in training mode takes 3 Adam
   steps (``make_train_step``) on ``make_batch([0, 1])``, each loss finite,
   with every train-path kernel launched the expected number of times;
   then one step with the kernels and one with the plain versions from
   the same weights and batch must agree in loss, gradients, new running
   statistics and new parameters; beside it, the plain step on a
   measurement moved by 1e-7 shows how far rounding alone moves the
   gradients; last, forward and backward ms and peak memory, kernels and
   plain in turns.

The comparisons of phases 3-5 run with
``torch.use_deterministic_algorithms(True)``, so a reading does not move
from run to run; phase 6's with ``warn_only=True`` (the backward of the
UNet's trilinear resize and replicate pad have no deterministic CUDA
version).  Every timed run keeps the libraries' default algorithms.

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
import warnings
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
# The stem pool's VJP: the kernel sums as the autograd of the plain chain
# does (powers-of-two weights, two-term sums), so it is expected exact;
# the tolerance is the contract's 2 ulp of the largest cotangent.
VJP_ULPS = 2
# Phase 6, one train step with kernels vs with plain versions, same
# weights and batch (the readings of the first chip run are in PERF.md):
TRAIN_LOSS_TOL = 1e-4        # relative, each of the three losses
TRAIN_STATS_TOL = 1e-3       # new running stats, max err / max abs
TRAIN_GRAD_L2_TOL = 0.05     # gradients, relative L2 over each module
TRAIN_PARAM_TOL = 1e-6       # new params where the two gradients agree
TRAIN_SIGN_AGREE = 0.99      # share of large gradient elements of one sign


@contextlib.contextmanager
def deterministic(warn_only: bool = False):
    """cuDNN's and cuBLAS's deterministic algorithms, for the comparisons
    only.  (cuDNN's default transposed conv, the head's deconvs,
    accumulates with atomics: two runs of one batch differ in the last
    bits of the heatmaps.)  ``warn_only`` lets ops that have no
    deterministic CUDA version run as they are, silently."""
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
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


def compare(name, kernel_fn, plain_fn, iters, exact=False, atol=None):
    """Error and times (plain, kernel, kernel, plain) of one call shape.
    The kernel's result must be exact (``exact``), within ``atol``, or
    within CONV_TOL of the plain result's max; a tuple result (dk, db) is
    compared part by part."""
    with deterministic(warn_only=True):
        got = kernel_fn()
        want = plain_fn()
        torch.cuda.synchronize()
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    err = max((g - w).abs().max().item() for g, w in pairs)
    scale = max(w.abs().max().item() for _, w in pairs)
    finite = all(bool(torch.isfinite(g).all()) for g, _ in pairs)
    if exact:
        ok = err == 0.0
    elif atol is not None:
        ok = finite and err <= atol
    else:
        ok = finite and all(
            (g - w).abs().max().item() <= CONV_TOL * max(
                w.abs().max().item(), 1e-30) for g, w in pairs)
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
# residual, count per forward, input needs a gradient in training, bias).
# FeatureExtraction at 128^3, then the UNet level by level (its convs are
# followed by GroupNorm: act none).  In a train step each call also runs
# K6 (dk, db) and, where its input needs a gradient, K5 (dx): the
# measurement fed to conv_in and to the corner conv needs none.
K1_SHAPES = [
    (1, 1, 128, "edge", "none", False, 1, False, True),   # FE conv_in
    (1, 1, 128, "edge", "leaky", False, 2, True, True),   # ResConv3D conv1
    (1, 1, 128, "edge", "leaky", True, 2, True, True),    # ResConv3D conv2
    (1, 1, 128, "zero", "none", True, 1, False, False),   # corner + branch
    (1, 4, 128, "zero", "none", False, 1, True, True),    # UNet conv
    (4, 4, 128, "zero", "none", False, 2, True, True),    # conv, dec4
    (4, 8, 64, "zero", "none", False, 1, True, True),     # enc1
    (8, 8, 64, "zero", "none", False, 1, True, True),
    (8, 16, 32, "zero", "none", False, 1, True, True),    # enc2
    (16, 16, 32, "zero", "none", False, 1, True, True),
    (16, 32, 16, "zero", "none", False, 1, True, True),   # enc3
    (32, 32, 16, "zero", "none", False, 1, True, True),
    (32, 32, 8, "zero", "none", False, 2, True, True),    # enc4
    (64, 16, 16, "zero", "none", False, 1, True, True),   # dec1
    (16, 16, 16, "zero", "none", False, 1, True, True),
    (32, 8, 32, "zero", "none", False, 1, True, True),    # dec2
    (8, 8, 32, "zero", "none", False, 1, True, True),
    (16, 4, 64, "zero", "none", False, 1, True, True),    # dec3
    (4, 4, 64, "zero", "none", False, 1, True, True),
    (8, 4, 128, "zero", "none", False, 1, True, True),    # dec4
]
# K4 call shapes: (width, extent, stride-1 blocks per forward); in a train
# step each block also runs K4-dx once.
K4_SHAPES = [(64, 64, 3), (128, 32, 3), (256, 16, 5)]
# K8: the UNet's four pools, (channels, extent of the pool's input).
POOL2_SHAPES = [(4, 128), (8, 64), (16, 32), (32, 16)]
# Launches of each kernel in one t128 train step, by the shapes above.
TRAIN_PER_STEP = {
    "conv3_planes": sum(r[6] for r in K1_SHAPES),
    "conv3_planes_adjoint": sum(r[6] for r in K1_SHAPES if r[7]),
    "conv3_planes_wgrad": sum(r[6] for r in K1_SHAPES),
    "maxpool3d_k3s2p1": 1, "maxpool3d_k3s2p1_vjp": 1,
    "conv3_mxu": sum(r[2] for r in K4_SHAPES),
    "conv3_mxu_dx": sum(r[2] for r in K4_SHAPES),
    "max_pool2_bwd": len(POOL2_SHAPES), "stem_conv_raw": 0,
}


def phase_kernels(dev):
    from hiddenpose_tpu_torch.ops import kernels as K

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    rows = {name: [] for name in K.KERNELS}
    for cin, cout, n, pad, act, res, count, dx, has_bias in K1_SHAPES:
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
        row["per_forward"] = row["per_step"] = count
        rows["conv3_planes"].append(row)

        dz = randn(B, cout, n, n, n)
        if dx:
            row = compare(
                f"conv3_planes_adjoint {cout}->{cin} @{n}^3 {pad}",
                lambda: K.conv3_planes_adjoint(dz, k, pad_mode=pad),
                lambda: K.conv3_planes_adjoint_ref(dz, k, pad_mode=pad),
                iters=10)
            row["per_step"] = count
            rows["conv3_planes_adjoint"].append(row)
        kw = dict(pad_mode=pad, has_bias=has_bias)
        row = compare(
            f"conv3_planes_wgrad {cin}x{cout} @{n}^3 {pad}"
            f"{' +db' if has_bias else ''}",
            lambda: K.conv3_planes_wgrad(x, dz, **kw),
            lambda: tuple(t for t in K.conv3_planes_wgrad_ref(x, dz, **kw)
                          if t is not None), iters=10)
        row["per_step"] = count
        rows["conv3_planes_wgrad"].append(row)

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
    row["per_forward"] = row["per_step"] = 1
    rows["maxpool3d_k3s2p1"].append(row)

    gy = randn(B, *((n - 1) // 2 + 1 for n in y.shape[1:4]), 64)
    row = compare(
        f"maxpool3d_k3s2p1_vjp (2,128^3,64) ties ({zeros:.0%} zeros)",
        lambda: K.maxpool3d_k3s2p1_vjp(y, gy),
        lambda: K.maxpool3d_k3s2p1_vjp_ref(y, gy), iters=5,
        atol=VJP_ULPS * float(np.spacing(np.float32(gy.abs().max().item()))))
    row["per_step"] = 1
    rows["maxpool3d_k3s2p1_vjp"].append(row)
    del y, gy

    for c, n in POOL2_SHAPES:
        x = torch.relu(randn(B, c, n, n, n))  # GroupNorm + ReLU: ties at 0
        dy = randn(B, c, n // 2, n // 2, n // 2)
        row = compare(f"max_pool2_bwd (2,{c},{n}^3)",
                      lambda: K.max_pool2_bwd(x, dy),
                      lambda: K.max_pool2_bwd_ref(x, dy), iters=10,
                      exact=True)
        row["per_step"] = 1
        rows["max_pool2_bwd"].append(row)

    for c, n, count in K4_SHAPES:
        x = randn(B, n, n, n, c)
        k = randn(3, 3, 3, c, c, scale=(27 * c) ** -0.5)
        sc = torch.rand(c, generator=g, device=dev) + 0.5
        sh = randn(c, scale=0.1)
        row = compare(f"conv3_mxu c{c}@{n}^3 +bn+relu",
                      lambda: K.conv3_mxu(x, k, sc, sh, relu=True),
                      lambda: K.conv3_mxu_ref(x, k, sc, sh, relu=True),
                      iters=5)
        row["per_forward"] = row["per_step"] = count
        rows["conv3_mxu"].append(row)
        row = compare(f"conv3_mxu_dx c{c}@{n}^3",
                      lambda: K.conv3_mxu_dx(x, k),
                      lambda: K.conv3_mxu_dx_ref(x, k), iters=5)
        row["per_step"] = count
        rows["conv3_mxu_dx"].append(row)
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
        per_forward = {
            "conv3_planes": sum(row[6] for row in K1_SHAPES),
            "stem_conv_raw": 1, "maxpool3d_k3s2p1": 1,
            "conv3_mxu": sum(row[2] for row in K4_SHAPES)}
        want = {k: per_forward.get(k, 0) * stats["batches"] for k in counts}
        if counts != want or min(counts[k] for k in K.SERVING) <= 0:
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


def _module(name: str) -> str:
    return name.split(".")[0]


def _train_readings(a, b):
    """How far step result ``a`` is from ``b`` (dicts of loss, grads,
    params, stats by name)."""
    loss = {k: abs(a["loss"][k] - b["loss"][k]) / abs(b["loss"][k])
            for k in b["loss"]}
    grad_l2 = {}
    for mod in sorted({_module(n) for n in b["grads"]}):
        names = [n for n in b["grads"] if _module(n) == mod]
        num = sum(float((a["grads"][n] - b["grads"][n]).double().pow(2).sum())
                  for n in names)
        den = sum(float(b["grads"][n].double().pow(2).sum()) for n in names)
        grad_l2[mod] = (num / den) ** 0.5
    grad_max = sorted(
        ((float((a["grads"][n] - b["grads"][n]).abs().max())
          / max(float(b["grads"][n].abs().max()), 1e-30), n)
         for n in b["grads"]), reverse=True)
    stats = max(float((a["stats"][n] - b["stats"][n]).abs().max())
                / max(float(b["stats"][n].abs().max()), 1e-30)
                for n in b["stats"])
    param_err, agree, total = 0.0, 0, 0
    for n, gb in b["grads"].items():
        ga = a["grads"][n]
        close = ((ga - gb).abs() <= 0.25 * gb.abs()) & (gb.abs() >= 1e-5)
        if close.any():
            param_err = max(param_err, float(
                (a["params"][n] - b["params"][n])[close].abs().max()))
        big = gb.abs() > 1e-2 * gb.abs().max()
        agree += int(((torch.sign(ga) == torch.sign(gb)) & big).sum())
        total += int(big.sum())
    return dict(loss_rel=loss, grad_rel_l2=grad_l2,
                grad_max_rel_worst=grad_max[:3], stats_max_rel=stats,
                param_max_abs=param_err, sign_agree=agree / max(total, 1))


def phase_train(dev, smi):
    """Three Adam steps at t128, then one step with kernels vs plain."""
    from hiddenpose_tpu_torch.config import TrainConfig
    from hiddenpose_tpu_torch.data.synthetic import make_batch
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose
    from hiddenpose_tpu_torch.ops import kernels as K
    from hiddenpose_tpu_torch.train.state import TrainState
    from hiddenpose_tpu_torch.train.step import make_train_step

    from hiddenpose_tpu_torch.config import t128_config

    cfg = t128_config()
    m = cfg.model
    t0 = time.perf_counter()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        [0, 1], m.time_size, m.image_size[0], m.grid_dim, m.heatmap_size[0],
        m.bin_len).items()}
    weights = t128_weights(cfg)
    model, lct = build_nlospose(m, device=dev)
    model.load_state_dict(weights)
    step = make_train_step(model)
    state = TrainState.create(model, TrainConfig())
    log(f"[6 train] t128 model and batch [0, 1] in "
        f"{time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    steps = []
    for i in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(state, batch, lct)
        end.record()
        torch.cuda.synchronize()
        steps.append(dict({k: v.item() for k, v in metrics.items()},
                          ms=start.elapsed_time(end)))
        log(f"[6 train] step {i}: loss {steps[-1]['loss']:.6g} (joint "
            f"{steps[-1]['joint_loss']:.6g}, voxel "
            f"{steps[-1]['voxel_loss']:.6g}) in {steps[-1]['ms']:.2f} ms")
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[6 train] peak memory {peak / 2**30:.3f} GiB; launch counts over "
        f"3 steps: {counts}  [{smi}]")
    want = {k: 3 * TRAIN_PER_STEP[k] for k in counts}
    if counts != want or min(counts[k] for k in K.TRAINING) <= 0:
        raise RuntimeError(f"train launch counts {counts}, expected {want}")
    if not all(np.isfinite(s_[k]) for s_ in steps
               for k in ("loss", "joint_loss", "voxel_loss")):
        raise RuntimeError("a train step's loss is not finite")

    def one_step(use_kernels):
        model.load_state_dict(weights)
        model.set_use_kernels(use_kernels)
        st = TrainState.create(model, TrainConfig())
        with deterministic(warn_only=True):
            met = step(st, batch, lct)
        torch.cuda.synchronize()
        return dict(
            loss={k: v.item() for k, v in met.items()},
            grads={n: p.grad.detach().clone()
                   for n, p in model.named_parameters()},
            params={n: p.detach().clone()
                    for n, p in model.named_parameters()},
            stats={n: b.clone() for n, b in model.named_buffers()
                   if n.endswith(("running_mean", "running_var"))})

    kern = one_step(True)
    plain = one_step(False)
    vs = _train_readings(kern, plain)
    # The step's own conditioning: the plain step again on a measurement
    # moved by 1e-7 (relative), far below the kernels' rounding effects.
    g = torch.Generator(device=dev).manual_seed(0)
    meas = batch["meas"]
    batch["meas"] = meas * (1 + 1e-7 * torch.randn(
        meas.shape, generator=g, device=dev))
    spread = _train_readings(one_step(False), plain)
    batch["meas"] = meas
    del kern, plain
    for name, r in (("kernels vs plain", vs),
                    ("plain vs plain on a 1e-7 moved measurement", spread)):
        log(f"[6 train] {name}: loss rel {r['loss_rel']}; grads rel L2 "
            f"{r['grad_rel_l2']}; grads worst max err/max abs "
            f"{r['grad_max_rel_worst']}; new running stats max rel "
            f"{r['stats_max_rel']:.3e}; new params max abs err where the "
            f"gradients agree {r['param_max_abs']:.3e}; large gradient "
            f"elements of one sign {r['sign_agree']:.5f}")
    ok = (max(vs["loss_rel"].values()) <= TRAIN_LOSS_TOL
          and max(vs["grad_rel_l2"].values()) <= TRAIN_GRAD_L2_TOL
          and vs["stats_max_rel"] <= TRAIN_STATS_TOL
          and vs["param_max_abs"] <= TRAIN_PARAM_TOL
          and vs["sign_agree"] >= TRAIN_SIGN_AGREE)
    log(f"[6 train] tolerances: loss {TRAIN_LOSS_TOL}, grads rel L2 "
        f"{TRAIN_GRAD_L2_TOL}, stats {TRAIN_STATS_TOL}, params "
        f"{TRAIN_PARAM_TOL}, one sign >= {TRAIN_SIGN_AGREE}: "
        f"{'pass' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("train step: kernels and plain versions disagree")

    # Forward (to the model's output) and backward + loss + Adam, by CUDA
    # events, kernels and plain in turns; peak memory of each.
    marks = {}
    hook = model.register_forward_hook(
        lambda *_: marks["fwd"].record())
    timing = {True: [], False: []}
    for use_kernels in (True, False, True, False):
        model.load_state_dict(weights)
        model.set_use_kernels(use_kernels)
        st = TrainState.create(model, TrainConfig())
        for k in ("start", "fwd", "end"):
            marks[k] = torch.cuda.Event(enable_timing=True)
        torch.cuda.reset_peak_memory_stats(dev)
        marks["start"].record()
        step(st, batch, lct)
        marks["end"].record()
        torch.cuda.synchronize()
        timing[use_kernels].append(dict(
            forward_ms=marks["start"].elapsed_time(marks["fwd"]),
            backward_ms=marks["fwd"].elapsed_time(marks["end"]),
            peak_memory_bytes=torch.cuda.max_memory_allocated(dev)))
    hook.remove()
    model.set_use_kernels(True)
    for use_kernels, runs in timing.items():
        log(f"[6 train] {'kernels' if use_kernels else 'plain'}: forward "
            f"{[round(r['forward_ms'], 2) for r in runs]} ms, backward + "
            f"loss + Adam {[round(r['backward_ms'], 2) for r in runs]} ms, "
            f"peak memory {runs[0]['peak_memory_bytes'] / 2**30:.3f} GiB  "
            f"[{smi}]")
    train = dict(steps=steps, peak_memory_bytes=peak, launches=counts,
                 kernels_vs_plain=vs, plain_vs_moved_plain=spread,
                 timing={"kernels": timing[True], "plain": timing[False]})
    return train, counts


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

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log(f"[{name}] phase done in {seconds[name]:.1f} s")
        return out

    smi = timed("1 toolchain", phase_toolchain)
    timed("2 build", phase_build)
    rows = timed("3 kernels", phase_kernels, dev)
    server, caps, serve, serve_counts = timed("4 serve", phase_serve, dev,
                                              smi)
    e2e = timed("5 e2e", phase_end_to_end, server, caps)
    del server
    torch.cuda.empty_cache()
    train, train_counts = timed("6 train", phase_train, dev, smi)

    from hiddenpose_tpu_torch.ops.kernels import KERNELS

    kernels = []
    for name, (_, _, source, replaces) in KERNELS.items():
        r = rows[name]
        per = [x.get("per_step", x.get("per_forward")) for x in r]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            # the serving burst's launches plus the 3 train steps'
            launches=serve_counts[name] + train_counts[name],
            max_abs_err=max(x["max_abs_err"] for x in r),
            # device time of one b2 train step's calls to this kernel (one
            # b2 forward's, for the serving-only stem conv)
            ms=sum(x["ms"] * n for x, n in zip(r, per)),
            plain_ms=sum(x["plain_ms"] * n for x, n in zip(r, per))))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(dict(
        device=smi, seconds=seconds, kernels=rows, serve=serve,
        end_to_end=e2e, train=train), indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
