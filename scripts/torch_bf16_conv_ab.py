"""Time K4-bf16 (``conv3_mxu_bf16``, the bf16 Bottleneck conv), K1-bf16
(``conv3_planes_bf16``, the bf16 FeatureExtraction / UNet conv) and K2-bf16
(``stem_conv_raw_bf16``, the bf16 stem conv) of one or more checkouts of
the port on one GPU, each checkout in a process of its own, in the order
given, at the t128 batch-2 shapes of the bf16 serving path.

    python3 scripts/torch_bf16_conv_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (``.`` for this one).  To compare a
parent with a change on one card, unpack the parent into a git-ignored
directory (``git archive PARENT | tar -x -C build/parent``) and give
``build/parent . . build/parent``.  Each run prints one JSON line: the
card's name and power limit; for each of K4-bf16's three path shapes (with
the bn2 epilogue) and each of K1-bf16's 20 (``chip_smoke.K1_SHAPES``) the
kernel's ms and that of its library call (``F.conv3d`` on the same bf16
tensors, channels-last for K4, on a padded copy for K1), medians of 20
readings of a few launches each, kernel and library in turns, and for K1
the f32 kernel's ms on the same values; the sums over one forward's calls
(11 and 24); K2-bf16 at (2, 128^3) beside ``F.conv3d`` on the same bf16
tensors; each kernel's largest excess over one bf16 ulp of its plain
version (at most 0 passes), whether two calls agree bit for bit, and
K4-bf16's and K2-bf16's f32-output error against float64 beside the
library f32 conv's.
Exits non-zero when a kernel disagrees or a run fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

READINGS = 20
B = 2
K4_SHAPES = [(64, 64, 3), (128, 32, 3), (256, 16, 5)]  # (C, extent, calls)
BF16_ATOL = 2.0 ** -16  # of the largest output, as chip_smoke.py


def cuda_ms(fn, iters):
    import torch

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


def medians(fns, iters):
    """Medians of READINGS readings of each function, taken in turns."""
    import numpy as np

    reads = [[] for _ in fns]
    for _ in range(READINGS):
        for r, fn in zip(reads, fns):
            r.append(cuda_ms(fn, iters))
    return [float(np.median(r)) for r in reads]


def one(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    import torch.nn.functional as F

    from chip_smoke import K1_SHAPES
    from hiddenpose_tpu_torch.ops import kernels as K

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    bf16 = torch.bfloat16
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device=dev).manual_seed(0)
    res = dict(root=root, device=smi, ok=True)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def excess(got, want):
        return K.bf16_ulp_excess(got, want,
                                 BF16_ATOL * want.float().abs().max().item())

    res["conv3_mxu_bf16"] = []
    for c, n, calls in K4_SHAPES:
        x = randn(B, n, n, n, c).to(bf16)
        k = randn(3, 3, 3, c, c, scale=(27 * c) ** -0.5).to(bf16)
        sc = torch.rand(c, generator=g, device=dev) + 0.5
        sh = randn(c, scale=0.1)
        e = dict(scale=sc, shift=sh, relu=True)
        got = K.conv3_mxu_bf16(x, k, **e)
        row = dict(shape=[B, n, n, n, c], calls=calls,
                   ulp_excess=excess(got, K.conv3_mxu_ref(x, k, **e)),
                   repeats=bool(torch.equal(got, K.conv3_mxu_bf16(x, k, **e))))
        x_ncdhw = x.permute(0, 4, 1, 2, 3)
        want64 = F.conv3d(x_ncdhw.double(), k.permute(4, 3, 0, 1, 2).double(),
                          padding=1).permute(0, 2, 3, 4, 1)
        want64 = (want64 * sc.double() + sh.double()).clamp_min(0.0)
        f32 = K.conv3_mxu_bf16(x, k, **e, out_dtype=torch.float32)
        lib32 = K.conv3_mxu_ref(x.float(), k.float(), **e)
        row["err_vs_f64"] = (f32.double() - want64).abs().max().item()
        row["library_f32_err_vs_f64"] = (
            (lib32.double() - want64).abs().max().item())
        del want64, f32, lib32, got
        w = k.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        row["ms"], row["library_ms"] = medians(
            [lambda: K.conv3_mxu_bf16(x, k, **e),
             lambda: F.conv3d(x_ncdhw, w, padding=1)], iters=5)
        row["ratio"] = row["ms"] / row["library_ms"]
        res["ok"] &= (row["ulp_excess"] <= 0.0 and row["repeats"]
                      and row["err_vs_f64"]
                      <= 2 * row["library_f32_err_vs_f64"])
        res["conv3_mxu_bf16"].append(row)
        del x, x_ncdhw
        torch.cuda.empty_cache()
    res["conv3_mxu_bf16_ms"] = sum(r["ms"] * r["calls"]
                                   for r in res["conv3_mxu_bf16"])
    res["conv3_mxu_bf16_library_ms"] = sum(
        r["library_ms"] * r["calls"] for r in res["conv3_mxu_bf16"])

    # K2-bf16: the stem of the serving forward, (2, 128^3), its BN + ReLU
    n = 128
    x = torch.rand((B, n, n, n, 1), generator=g, device=dev).to(bf16)
    k = randn(7, 7, 7, 1, 64, scale=343 ** -0.5).to(bf16)
    sc = torch.rand(64, generator=g, device=dev) + 0.5
    sh = randn(64, scale=0.1)
    got = K.stem_conv_raw_bf16(x, k, sc, sh)
    row = dict(shape=[B, n, n, n, 1], calls=1,
               ulp_excess=excess(got, K.stem_conv_raw_ref(x, k, sc, sh)),
               repeats=bool(torch.equal(got, K.stem_conv_raw_bf16(x, k, sc,
                                                                  sh))))
    x_ncdhw = x.permute(0, 4, 1, 2, 3)
    w = k.permute(4, 3, 0, 1, 2).contiguous()
    want64 = F.conv3d(x_ncdhw.double(), w.double(), padding=3)
    want64 = (want64.permute(0, 2, 3, 4, 1) * sc.double()
              + sh.double()).clamp_min(0.0)
    f32 = K.stem_conv_raw_bf16(x, k, sc, sh, out_dtype=torch.float32)
    lib32 = K.stem_conv_raw_ref(x.float(), k.float(), sc, sh)
    row["err_vs_f64"] = (f32.double() - want64).abs().max().item()
    row["library_f32_err_vs_f64"] = (lib32.double() - want64).abs().max().item()
    del want64, f32, lib32, got
    row["ms"], row["library_ms"] = medians(
        [lambda: K.stem_conv_raw_bf16(x, k, sc, sh),
         lambda: F.conv3d(x_ncdhw, w, padding=3)], iters=5)
    row["ratio"] = row["ms"] / row["library_ms"]
    res["ok"] &= (row["ulp_excess"] <= 0.0 and row["repeats"]
                  and row["err_vs_f64"] <= 2 * row["library_f32_err_vs_f64"])
    res["stem_conv_raw_bf16"] = row
    del x, x_ncdhw
    torch.cuda.empty_cache()

    res["conv3_planes_bf16"] = []
    for cin, cout, n, pad, act, resid, count, _, _ in K1_SHAPES:
        x = randn(B, cin, n, n, n).to(bf16)
        k = randn(3, 3, 3, cin, cout, scale=(27 * cin) ** -0.5)
        bias = randn(cout, scale=0.1)
        r = randn(B, cout, n, n, n).to(bf16) if resid else None
        kw = dict(act=act, pad_mode=pad)
        got = K.conv3_planes_bf16(x, k, bias, r, **kw)
        row = dict(shape=[B, cin, cout, n, pad, act, resid], calls=count,
                   ulp_excess=excess(got, K.conv3_planes_ref(x, k, bias, r,
                                                             **kw)),
                   repeats=bool(torch.equal(
                       got, K.conv3_planes_bf16(x, k, bias, r, **kw))))
        x32 = x.float()
        r32 = r.float() if resid else None
        xp = F.pad(x, (1,) * 6, mode="replicate" if pad == "edge"
                   else "constant")
        w = k.permute(4, 3, 0, 1, 2).to(bf16).contiguous()
        row["ms"], row["library_ms"], row["f32_ms"] = medians(
            [lambda: K.conv3_planes_bf16(x, k, bias, r, **kw),
             lambda: F.conv3d(xp, w, bias.to(bf16)),
             lambda: K.conv3_planes(x32, k, bias, r32, **kw)], iters=5)
        res["ok"] &= row["ulp_excess"] <= 0.0 and row["repeats"]
        res["conv3_planes_bf16"].append(row)
        del x, x32, xp, r, r32, got
    torch.cuda.empty_cache()
    for key in ("ms", "library_ms", "f32_ms"):
        res[f"conv3_planes_bf16_{key}"] = sum(
            r[key] * r["calls"] for r in res["conv3_planes_bf16"])
    return res


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        res = one(sys.argv[2])
        print(json.dumps(res), flush=True)
        return 0 if res["ok"] else 1
    roots = sys.argv[1:] or ["."]
    rc = 0
    for root in roots:
        p = subprocess.run([sys.executable, __file__, "--one", root],
                           capture_output=True, text=True)
        sys.stdout.write(p.stdout)
        if p.returncode:
            sys.stderr.write(p.stderr[-4000:])
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
