"""Time diagnostic builds of K4-bf16 (``csrc/conv3mxu_bf16.cu``) on one GPU,
each made from the shipped source by text substitution, at the three
shapes of the bf16 serving path (c64 @64^3, c128 @32^3, c256 @16^3, batch
2, the bn2 epilogue).

    python3 scripts/torch_conv3mxu_bf16_diag.py [VARIANT ...]

Each variant is compiled by nvcc on its own into ``build/diag/`` (all at
once) and called through its C entry point on the same tensors; the
shipped build is also held to the plain version (one bf16 ulp). The
variants change or leave out one part of the work, so their times say what
each part costs: ``no_mma`` (no wgmma), ``no_lds`` (A from constants, not
shared memory), ``no_copies`` (no copies into the stages: they stay as
they are), ``no_fadd`` (no f32 add of the partials), ``one_tile`` (a block
a tile, not persistent blocks). Prints one JSON line: the
card's name and power limit and, per variant, the ms of each shape
(medians of 20 readings of 5 launches; the weights' layout included, as in
the wrapper's call).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hiddenpose_tpu_torch.ops.kernels import _build  # noqa: E402
from hiddenpose_tpu_torch.ops.kernels import conv3mxu as k4  # noqa: E402

SRC = ROOT / "hiddenpose_tpu_torch" / "csrc" / "conv3mxu_bf16.cu"
OUT = ROOT / "build" / "diag"
SHAPES = [(64, 64), (128, 32), (256, 16)]  # (channels, extent), batch 2
READINGS = 20

ACC_ADD = ("#pragma unroll\n"
           "    for (int i = 0; i < 32; ++i) acc[i] += psum[i];")
VARIANTS = {
    "shipped": [],
    "no_mma": [("        wgmma_bf16(psum, a0,", "        if (0) wgmma_bf16(psum, a0,"),
               ("        wgmma_bf16(psum, a1,", "        if (0) wgmma_bf16(psum, a1,")],
    "no_lds": [
        ("L[i] = *reinterpret_cast<const uint4*>(as + (i * hp + kw) * BK);",
         "L[i] = make_uint4(i, kw, hp, 2);")],
    "no_copies": [
        ("mbar_expect(bar, a_bytes + B_STAGE * 2);", "mbar_expect(bar, 0);"),
        ("      tma_load(", "      if (0) tma_load("),
        ("      bulk_load(", "      if (0) bulk_load(")],
    "no_fadd": [(ACC_ADD, "    acc[0] += psum[0];")],
    "one_tile": [("const int grid = (int)(tiles < sms ? tiles : sms);",
                  "const int grid = (int)tiles;")],
}


def build(name, subs):
    text = SRC.read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} not in the source")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"{name}.cu"
    src.write_text(text)
    return subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
         str(SRC.parent), str(src), "-o", str(OUT / f"lib{name}.so")],
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
    names = sys.argv[1:] or list(VARIANTS)
    procs = {n: build(n, VARIANTS[n]) for n in names}
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(log, file=sys.stderr)
            return 1
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"{n}: {regs[:1]}", file=sys.stderr)
        lib = ctypes.CDLL(str(OUT / f"lib{n}.so"))
        fn = lib.hp_conv3_mxu_bf16_fwd
        fn.argtypes = _build.SIGNATURES["hp_conv3_mxu_bf16_fwd"]
        fn.restype = ctypes.c_int
        libs[n] = fn
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    res = dict(device=smi, shapes=SHAPES, ms={n: [] for n in names})
    for c, n in SHAPES:
        x = torch.randn((2, n, n, n, c), generator=g, device=dev).bfloat16()
        k = (torch.randn((3, 3, 3, c, c), generator=g, device=dev)
             * (27 * c) ** -0.5).bfloat16()
        sc = torch.rand(c, generator=g, device=dev) + 0.5
        sh = torch.randn(c, generator=g, device=dev) * 0.1
        wp = k4.prepare_weights_bf16(k)
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream
        ints = _build.int_args(2, n, n, n, c, c, 1, 0, *k4.bf16_tile(n, n),
                               0)

        def run(fn):
            err = fn(x.data_ptr(), k.data_ptr(), wp.data_ptr(),
                     sc.data_ptr(), sh.data_ptr(), out.data_ptr(), ints,
                     stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")

        if "shipped" in libs:
            run(libs["shipped"])
            want = k4.conv3_mxu_ref(x, k, sc, sh, relu=True)
            excess = _build_excess(out, want)
            res.setdefault("ulp_excess", []).append(excess)
        reads = {n_: [] for n_ in names}
        for _ in range(READINGS):
            for n_ in names:
                reads[n_].append(cuda_ms(lambda: run(libs[n_])))
        for n_ in names:
            res["ms"][n_].append(float(np.median(reads[n_])))
    print(json.dumps(res), flush=True)
    return 0


def _build_excess(got, want):
    from hiddenpose_tpu_torch.ops.kernels import bf16_ulp_excess

    return bf16_ulp_excess(got, want,
                           2.0 ** -16 * want.float().abs().max().item())


if __name__ == "__main__":
    sys.exit(main())
