"""Time K2 (the stem conv, ``stem_conv_raw``) and K8 (the UNet pool's
backward, ``max_pool2_bwd``) of one or more checkouts of the port on one
GPU, each checkout in a process of its own, in the order given, at the
t128 batch-2 shapes of the main path.

    python3 scripts/torch_stem_pool_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (``.`` for this one).  To compare a
parent with a change on one card, unpack the parent into a git-ignored
directory (``git archive PARENT | tar -x -C build/parent``) and give
``build/parent . . build/parent``.  Each run prints one JSON line: the
card's name and power limit, K2's ms at (2, 128^3) and that of its library
call (``F.conv3d`` of the channels-last view, padding 3: the conv alone),
each K8 shape's ms and that of the library backward (autograd of
``F.max_pool3d``), medians of 20 readings of a few launches each, kernel
and library in turns, and each kernel's max error against its plain
version (K8 must be exact).  Exits non-zero when a kernel disagrees or a
run fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

READINGS = 20
POOL2_SHAPES = [(4, 128), (8, 64), (16, 32), (32, 16)]  # (C, extent), B 2
B = 2


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


def medians(kernel_fn, library_fn, iters):
    """Medians of READINGS readings of each, taken in turns."""
    import numpy as np

    k, lib = [], []
    for _ in range(READINGS):
        k.append(cuda_ms(kernel_fn, iters))
        lib.append(cuda_ms(library_fn, iters))
    return float(np.median(k)), float(np.median(lib))


def one(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    import torch.nn.functional as F

    from hiddenpose_tpu_torch.ops import kernels as K

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device=dev).manual_seed(0)
    res = dict(root=root, device=smi)

    x = torch.rand((B, 128, 128, 128, 1), generator=g, device=dev)
    k = torch.randn((7, 7, 7, 1, 64), generator=g, device=dev) * 343 ** -0.5
    scale = torch.rand(64, generator=g, device=dev) + 0.5
    shift = torch.randn(64, generator=g, device=dev) * 0.1
    got = K.stem_conv_raw(x, k, scale, shift)
    want = K.stem_conv_raw_ref(x, k, scale, shift)
    err = (got - want).abs().max().item() / want.abs().max().item()
    del got, want
    x_ncdhw = x.permute(0, 4, 1, 2, 3)
    w = k.permute(4, 3, 0, 1, 2).contiguous()
    ms, lib = medians(lambda: K.stem_conv_raw(x, k, scale, shift),
                      lambda: F.conv3d(x_ncdhw, w, padding=3), iters=3)
    res["stem_conv_raw"] = dict(ms=ms, library_ms=lib, max_rel_err=err)
    del x, x_ncdhw
    torch.cuda.empty_cache()

    res["max_pool2_bwd"] = []
    for c, n in POOL2_SHAPES:
        xp = torch.relu(torch.randn((B, c, n, n, n), generator=g, device=dev))
        dy = torch.randn((B, c, n // 2, n // 2, n // 2), generator=g,
                         device=dev)
        exact = torch.equal(K.max_pool2_bwd(xp, dy),
                            K.max_pool2_bwd_ref(xp, dy))
        xg = xp.clone().requires_grad_()
        pooled = F.max_pool3d(xg, 2)
        ms, lib = medians(
            lambda: K.max_pool2_bwd(xp, dy),
            lambda: torch.autograd.grad(pooled, xg, dy, retain_graph=True),
            iters=10)
        res["max_pool2_bwd"].append(dict(shape=[B, c, n, n, n], ms=ms,
                                         library_ms=lib, exact=exact))
    res["max_pool2_bwd_ms"] = sum(r["ms"] for r in res["max_pool2_bwd"])
    res["ok"] = err <= 1e-4 and all(r["exact"] for r in res["max_pool2_bwd"])
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
