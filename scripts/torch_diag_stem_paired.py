"""Probe the operations the stem conv kernels rely on, one CUDA kernel each.

    python3 scripts/torch_diag_stem_paired.py

Run from the root of a checkout on a host with an NVIDIA GPU.  The port's
counterpart of ``scripts/tpu_diag_stem_paired.py``: where that script
isolated the lowered op of the TPU's paired-lane stem kernel that
mis-computed, this one checks the same four operations as hand-written CUDA
kernels (``hiddenpose_tpu_torch/csrc/diag_probes.cu``), each against the
numpy / torch expression the TPU script compares with, on the same inputs:

  A.   the paired im2col store as tensor-map box loads, some at lanes that
       are not 16-byte aligned, each stored by a tensor-map box (exact);
  B.   a lane-half read of a (512, 128) tile by tensor-map boxes under the
       128-byte swizzle, its transpose in shared memory, tensor-map stores
       (exact);
  C.   the f32 FMA matrix product (512, 1024) @ (1024, 128), against
       ``torch.matmul`` with TF32 off (relative error <= 1e-5);
  C64. the same at N = 64.

Prints the largest error of each probe.  Unlike the TPU script it exits
non-zero when a probe fails or cannot run (no GPU, no nvcc, a launch
error).  Imports no JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

DOT_TOL = 1e-5  # max |kernel - matmul| / max |matmul|, f32 both sides


def probe_inputs(dev):
    """The TPU script's inputs (same seeds), on ``dev``."""
    from hiddenpose_tpu_torch.ops.kernels import probes

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    rng = np.random.RandomState(2)
    a = rng.randn(512, 1024) * 0.1
    b = rng.rand(1024, 128)
    return dict(
        x_a=t(np.random.RandomState(0).rand(*probes.X_SHAPE)),
        x_b=t(np.random.RandomState(1).rand(512, 128)),
        a=t(a), b=t(b), b64=t(b[:, :64]))


def run_probes(dev) -> list:
    """Run the four probes on ``dev``; a list of dicts (probe, kernel, err,
    tol, ok), printed as they come."""
    from hiddenpose_tpu_torch.ops.kernels import probes

    torch.backends.cuda.matmul.allow_tf32 = False  # matmul is the comparator
    inp = probe_inputs(dev)
    results = []

    def report(probe, kernel, err, tol):
        ok = bool(np.isfinite(err)) and err <= tol
        results.append(dict(probe=probe, kernel=kernel, err=err, tol=tol,
                            ok=ok))
        print(f"{probe}: max err {err:.3e} (limit {tol:g})"
              + ("" if ok else "  <-- FAILED"), flush=True)

    got = probes.probe_im2col(inp["x_a"])
    want = probes.probe_im2col_ref(inp["x_a"])
    report("A im2col store", "probe_im2col",
           (got - want).abs().max().item(), 0.0)

    lo, hi = probes.probe_slice_transpose(inp["x_b"])
    wlo, whi = probes.probe_slice_transpose_ref(inp["x_b"])
    report("B slice+transpose", "probe_slice_transpose",
           max((lo - wlo).abs().max().item(), (hi - whi).abs().max().item()),
           0.0)

    for probe, b in (("C f32 dot N=128", inp["b"]),
                     ("C64 f32 dot N=64", inp["b64"])):
        got = probes.probe_dot_f32(inp["a"], b)
        want = probes.probe_dot_f32_ref(inp["a"], b)
        report(probe, "probe_dot_f32",
               ((got - want).abs().max() / want.abs().max()).item(), DOT_TOL)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device: the probes are CUDA kernels",
              file=sys.stderr)
        return 2
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    results = run_probes(torch.device("cuda:0"))
    failed = [r["probe"] for r in results if not r["ok"]]
    print("diag done: "
          + (f"FAILED {failed}" if failed else "all probes pass"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
