"""Where the time of K9 (``hiddenpose_tpu_torch/csrc/attn.cu``) goes, on one
GPU: diagnostic builds of the shipped source, each made by a text
substitution, timed at the Sformer's shapes.

    python3 scripts/torch_attn_diag.py

Run from the root of a checkout on a host with an NVIDIA H100 and ``nvcc``.
No profiler that reads a kernel's pipes runs everywhere, so the kernel is
taken apart instead.  The builds (results of all but ``shipped`` and the
arithmetic variants are wrong on purpose; only their times are read):

* ``shipped``: the source as it is;
* ``no products``: every ``wgmma`` left out (the softmax, the operand splits
  and the staging alone);
* ``no staging``: the next tile's loads, splits and stores left out;
* ``no products, no staging``: the softmax and p's split alone;
* ``no softmax``: max, exponentials and sums left out;
* ``products only``: no softmax and no staging;
* arithmetic variants that give right results: ``cvt.rna splits`` (the
  TF32 rounding by ``cvt.rna.tf32.f32`` instead of two integer
  instructions), ``exp2f`` (the library function instead of
  ``ex2.approx.ftz``), ``p v in 1 / 2 / 4 rounds`` (``PV_ROUNDS``).

Shapes: the grouped attention of one full-width Sformer layer,
(1024, 1024, 1048, 32), in the three dtype pairs, and the joint-token read
(8, 24, 131096, 32) in float32.  Prints ms per call (mean of 5 after a
warm-up, two passes over the builds) and writes
``chiprun_out/torch_attn_diag.json``.  Imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hiddenpose_tpu_torch.ops.kernels import _build  # noqa: E402

SHAPES = [((1024, 1024, 1048, 32), torch.float32, torch.float32),
          ((1024, 1024, 1048, 32), torch.float32, torch.bfloat16),
          ((1024, 1024, 1048, 32), torch.bfloat16, torch.bfloat16),
          ((8, 24, 131096, 32), torch.float32, torch.float32)]


def _sub(text, old, new, count=1):
    if text.count(old) < count:
        raise RuntimeError(f"attn.cu no longer holds {old!r}")
    return text.replace(old, new)


def no_products(s):
    out, n = re.subn(r'asm volatile\(\s*"\{\\n\.reg \.pred p;.*?\);\n', ";\n",
                     s, flags=re.S)
    if n != 4:
        raise RuntimeError(f"expected 4 wgmma wrappers, found {n}")
    return out


def no_staging(s):
    s = _sub(s, "if (more) load_tile(k0 + TKT, st);", ";")
    s = _sub(s, "if (more) store_tile(slot ^ 1, st);", ";")
    return _sub(s, "if (more && !wg_live) store_tile(slot ^ 1, st);", ";")


def no_softmax(s):
    a = s.index("      // the online softmax of the tile, rows g (x)")
    b = s.index("      // p v into fresh partials")
    return s[:a] + "      const float sc0 = 1.f, sc1 = 1.f;\n" + s[b:]


def cvt_splits(s):
    return _sub(
        s, "  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;",
        '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : '
        '"f"(v));\n  return r;')


def library_exp2(s):
    a = s.index("  float y;\n  asm(\"ex2.approx.ftz.f32")
    b = s.index("  return y;\n", a) + len("  return y;\n")
    return s[:a] + "  return exp2f(x);\n" + s[b:]


def rounds(n):
    return lambda s: _sub(s, "constexpr int PV_ROUNDS = 8;",
                          f"constexpr int PV_ROUNDS = {n};")


VARIANTS = {
    "shipped": lambda s: s,
    "no products": no_products,
    "no staging": no_staging,
    "no products, no staging": lambda s: no_staging(no_products(s)),
    "no softmax": no_softmax,
    "products only": lambda s: no_staging(no_softmax(s)),
    "cvt.rna splits": cvt_splits,
    "exp2f": library_exp2,
    "p v in 1 round": rounds(1),
    "p v in 2 rounds": rounds(2),
    "p v in 4 rounds": rounds(4),
}


def build(out_dir: Path) -> dict:
    """One nvcc per variant, all at once; name -> shared library."""
    src = (_build.CSRC / "attn.cu").read_text()
    nvcc = _build.find_nvcc()
    procs, libs = {}, {}
    for i, (name, edit) in enumerate(VARIANTS.items()):
        cu = out_dir / f"attn_{i}.cu"
        cu.write_text(edit(src))
        libs[name] = out_dir / f"attn_{i}.so"
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", str(cu), "-o",
             str(libs[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name!r}:\n{log[-3000:]}")
    return libs


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
    if not torch.cuda.is_available():
        print("torch_attn_diag: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    out_dir = _build.BUILD_DIR.parent / "attn_diag"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build(out_dir)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    g = torch.Generator(device=dev).manual_seed(0)
    data = []
    for (b, lq, lk, dh), qdt, vdt in SHAPES:
        q = (torch.randn(b, lq, dh, device=dev, generator=g)
             * dh ** -0.5).to(qdt)
        k = torch.randn(b, lk, dh, device=dev, generator=g).to(qdt)
        v = torch.randn(b, lk, dh, device=dev, generator=g).to(vdt)
        data.append((q, k, v, torch.empty(b, lq, dh, device=dev, dtype=vdt)))

    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    results = {name: [] for name in VARIANTS}
    for _ in range(2):
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            lib.hp_attend_plan.argtypes = [L] + [I] * 3
            lib.hp_attend_fwd.argtypes = [P] * 5 + [L] + [I] * 5 + [P]
            row = []
            for (q, k, v, out), ((b, lq, lk, dh), qdt, vdt) in zip(data,
                                                                   SHAPES):
                splits = lib.hp_attend_plan(b, lq, lk, dh)
                ws = torch.empty(splits * b * lq * (dh + 2), device=dev)

                def run():
                    err = lib.hp_attend_fwd(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), ws.data_ptr(), b, lq, lk, dh,
                        int(qdt == torch.bfloat16),
                        int(vdt == torch.bfloat16),
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                row.append(cuda_ms(run))
            results[name].append(row)
            print(f"{name:>24}: " + " | ".join(f"{t:.4f}" for t in row)
                  + " ms", flush=True)
    print("columns: " + "; ".join(
        f"{s} q/k {str(a)[6:]} v {str(b)[6:]}" for s, a, b in SHAPES))
    print(smi)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_attn_diag.json").write_text(json.dumps(dict(
        device=smi, shapes=[str(s) for s in SHAPES], ms=results), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
