"""Time diagnostic builds of K2-bf16 (``csrc/stem_conv_bf16.cu``, the bf16
serving stem) on one GPU, each made from a source by text substitution, at
the serving shape (2, 128^3) with the BN + ReLU epilogue.

    python3 scripts/torch_stem_conv_bf16_diag.py [--source PATH] [VARIANT ...]

``--source`` names the ``stem_conv_bf16.cu`` to start from (default: this
checkout's); an earlier checkout's (unpacked with ``git archive PARENT |
tar -x -C build/parent``) may hold the word-pair design (the halo staged
as 32-bit words of two W neighbours, A from registers, m64n64k16), whose
variants are ``WORD_PAIR_VARIANTS``, told apart by the ``wgmma_bf16_ss``
call the current design makes.  Each variant is compiled by nvcc on its
own into ``build/diag_stem/`` (all at once, against the headers beside the
source) and called through its C entry points on the same tensors, after
its own weight preparation; the unchanged build is also held to the plain
version (one bf16 ulp).  The variants leave out or change one part of the
work, so their times say what each part costs (a variant's result is
wrong by design):

- current design: ``stages5`` (five f32 partials a plane, not two),
  ``ring10`` (ten planes in flight, not twelve), ``dchunk128`` (work units
  128 planes deep, not 64), ``no_mma`` (no wgmma), ``no_stores`` (the
  epilogue's tensor-map stores left out), ``no_loads`` (the producers
  stage constants, no global loads), and without the MMAs also:
  ``no_mma_no_stores``, ``no_mma_no_loads``, ``no_mma_no_epilogue`` (only
  the last plane's epilogue), ``no_mma_no_producer`` (the producer warps
  only hand the slots over: no loads, no expanded rows);
- the word-pair design: ``no_mma``, ``no_fadd``, ``no_loads`` (the halo
  from constants), ``no_sync`` (no block barrier after a plane).  Without
  its stores the compiler drops the whole computation: no such variant.

Prints one JSON line: the card's name and power limit, the source, per
variant its ms (the median of 20 readings of 5 launches) and its
registers, and ``fill_ms``, the time ``Tensor.fill_`` takes to write the
same 537 MB output: the write rate this card reaches.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hiddenpose_tpu_torch.ops import kernels as K  # noqa: E402
from hiddenpose_tpu_torch.ops.kernels import _build  # noqa: E402

OUT = ROOT / "build" / "diag_stem"
READINGS = 20
N = 128  # the serving volume, batch 2

NO_MMA = [("        wgmma_bf16_ss(part,", "        if (0) wgmma_bf16_ss(part,")]
NO_STORES = [("        tma_store(&omap,", "        if (0) tma_store(&omap,")]
NO_LOADS = [("? __ldg(xb + ((int64_t)p * H + gh) * W + gw)", "? (uint16_t)1")]
NO_BUILDS = [("        for (int i = 0; i < PROD_ROWS; ++i) {",
              "        for (int i = 0; i < 0; ++i) {")]
NO_EPILOGUE = [("        if (eb >= 0) epilogue();  // the last plane's",
                "        // the last plane's")]
VARIANTS = {
    "shipped": [],
    "stages5": [("constexpr int STAGES = 2;", "constexpr int STAGES = 5;")],
    "ring10": [("constexpr int RING = 12;", "constexpr int RING = 10;")],
    "dchunk128": [("constexpr int DCHUNK = 64;", "constexpr int DCHUNK = 128;")],
    "no_mma": NO_MMA,
    "no_stores": NO_STORES,
    "no_loads": NO_LOADS,
    "no_mma_no_stores": NO_MMA + NO_STORES,
    "no_mma_no_loads": NO_MMA + NO_LOADS,
    "no_mma_no_epilogue": NO_MMA + NO_EPILOGUE,
    "no_mma_no_producer": NO_MMA + NO_LOADS + NO_BUILDS,
}
WORD_PAIR_ADD = ("for (int i = 0; i < 32; ++i) acc[i] = kd ? acc[i] + part[i] "
           ": part[i];")
WORD_PAIR_VARIANTS = {
    "shipped": [],
    "no_mma": [("          wgmma_bf16(part, aj,",
                "          if (0) wgmma_bf16(part, aj,")],
    "no_fadd": [(WORD_PAIR_ADD, "acc[0] += part[0];")],
    "no_loads": [("? (uint32_t)__ldg(xb + ((int64_t)p * H + gh) * W + gw)",
                  "? 1u")],
    "no_sync": [("      __syncthreads();  // plane d + 4 is staged",
                 "      // plane d + 4 is staged")],
}


def build(src, name, subs):
    text = src.read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} not in {src}")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}.cu"
    cu.write_text(text)
    return subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
         str(src.parent), str(cu), "-o", str(OUT / f"lib{name}.so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def cuda_ms(fn, iters=5):
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", type=Path,
                    default=ROOT / "hiddenpose_tpu_torch" / "csrc"
                    / "stem_conv_bf16.cu")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args()
    src = args.source.resolve()
    table = (VARIANTS if "wgmma_bf16_ss" in src.read_text()
             else WORD_PAIR_VARIANTS)
    names = args.variants or list(table)
    procs = {n: build(src, n, table[n]) for n in names}
    fwd, prep, regs = {}, {}, {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(log, file=sys.stderr)
            return 1
        regs[n] = [ln.strip() for ln in log.splitlines()
                   if "registers" in ln]
        lib = ctypes.CDLL(str(OUT / f"lib{n}.so"))
        for name, table_ in (("hp_stem_conv_bf16_fwd", fwd),
                             ("hp_stem_conv_bf16_prep", prep)):
            fn = getattr(lib, name)
            fn.argtypes = _build.SIGNATURES[name]
            fn.restype = ctypes.c_int
            table_[n] = fn
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    x = torch.rand((2, N, N, N, 1), generator=g, device=dev).bfloat16()
    k = (torch.randn((7, 7, 7, 1, 64), generator=g, device=dev)
         * 343 ** -0.5).bfloat16()
    sc = torch.rand(64, generator=g, device=dev) + 0.5
    sh = torch.randn(64, generator=g, device=dev) * 0.1
    wp = torch.empty(7 * 4 * 2 * 8 * 8 * 8, device=dev, dtype=torch.bfloat16)
    out = torch.empty((2, N, N, N, 64), device=dev, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream

    def run(n):
        err = prep[n](k.data_ptr(), wp.data_ptr(), stream)
        err = err or fwd[n](x.data_ptr(), wp.data_ptr(), sc.data_ptr(),
                            sh.data_ptr(), out.data_ptr(), 2, N, N, N, 1, 0,
                            stream)
        if err:
            raise RuntimeError(f"{n}: launch failed: {err}")

    res = dict(device=smi, source=str(src), shape=[2, N, N, N], regs=regs)
    if "shipped" in names:
        run("shipped")
        want = K.stem_conv_raw_ref(x, k, sc, sh)
        res["ulp_excess"] = K.bf16_ulp_excess(
            out, want, 2.0 ** -16 * want.float().abs().max().item())
        del want
    reads = {n: [] for n in names}
    for _ in range(READINGS):
        for n in names:
            reads[n].append(cuda_ms(lambda: run(n)))
    res["ms"] = {n: float(np.median(r)) for n, r in reads.items()}
    res["fill_ms"] = float(np.median([cuda_ms(lambda: out.fill_(1.0))
                                      for _ in range(READINGS)]))
    print(json.dumps(res), flush=True)
    return 0 if res.get("ulp_excess", 0.0) <= 0.0 else 1


if __name__ == "__main__":
    sys.exit(main())
