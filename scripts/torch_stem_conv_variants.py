"""Time diagnostic variants of K2 (``csrc/stem_conv.cu``) on one GPU.

    python3 scripts/torch_stem_conv_variants.py [NAME ...]

Each variant is the shipped source with a few text substitutions (below),
written in place of it, built anew (the library's name hashes the sources)
and called through the wrapper at the serving shape, (2, 128^3) -> 64
channels; the source is restored at the end.  One JSON line a variant:
the card's name and power limit, the median ms of 10 readings of 3
launches, the max error against the plain version over its max, and
ptxas's register, spill and wgmma lines for the source.
Exits non-zero when a variant that computes the conv disagrees with it.
"""

from __future__ import annotations

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

SOURCE = _build.CSRC / "stem_conv.cu"
# The kd stages in a pipeline: stage kd + 1's MMAs are issued before stage
# kd's are waited for, into a second partial from a second set of A
# registers, so that a warpgroup's adds and loads overlap its own MMAs.
PIPELINED = [
    ("float acc[32], part[32];", "float acc[32], part[2][32];"),
    ("for (int i = 0; i < 32; ++i) part[i] = 0.f;",
     "for (int i = 0; i < 32; ++i) part[0][i] = part[1][i] = 0.f;"),
    ("uint32_t ahi[8][2], alo[8][2];",
     "uint32_t ahi[2][8][2], alo[2][8][2];"),
    ("""#pragma unroll 1
      for (int kd = 0; kd < K; ++kd) {
        load_a(d, kd, ahi, alo);
        issue(kd, ahi, alo, part);
        wgmma_wait();
        add(part, kd);
      }""", """load_a(d, 0, ahi[0], alo[0]);
#pragma unroll
      for (int kd = 0; kd < K; ++kd) {
        issue(kd, ahi[kd & 1], alo[kd & 1], part[kd & 1]);
        if (kd > 0) {
          wgmma_wait<1>();
          add(part[(kd - 1) & 1], kd - 1);
        }
        if (kd + 1 < K)
          load_a(d, kd + 1, ahi[(kd + 1) & 1], alo[(kd + 1) & 1]);
      }
      wgmma_wait<0>();
      add(part[(K - 1) & 1], K - 1);"""),
]
# The resident weights plus the L2 reads that streaming them would cost:
# each stage, after its MMAs are issued, the block reads that kd's B (hi and
# lo, 28 KB) from device memory once, spread over its threads, and folds
# the values into the output times 0.  A lower bound on a form that streams
# B a kd at a time through a ring instead of keeping all of it resident.
B_READS = [
    ("  uint32_t ahi[8][2], alo[8][2];\n",
     "  uint32_t ahi[8][2], alo[8][2];\n  float sink = 0.f;\n"),
    ("    wgmma_commit();\n  };", """    wgmma_commit();
    const float4* const sb =
        reinterpret_cast<const float4*>(wp) + kd * K * 2 * B_PART / 4;
    for (int i = tid; i < K * 2 * B_PART / 4; i += NT) {
      const float4 v = __ldg(sb + i);
      sink += v.x + v.y + v.z + v.w;
    }
  };"""),
    ("for (int i = 0; i < 32; ++i) acc[i] = kd ? acc[i] + p[i] : p[i];",
     "for (int i = 0; i < 32; ++i) acc[i] = kd ? acc[i] + p[i] : p[i];\n"
     "    acc[0] += sink * 0.f;"),
]
# name -> (substitutions, computes the conv)
VARIANTS = {
    "shipped": ([], True),
    "pipelined": (PIPELINED, True),
    "b_reads": (B_READS, True),
    "dchunk16": ([("constexpr int DCHUNK = 32;",
                   "constexpr int DCHUNK = 16;")], True),
    "dchunk64": ([("constexpr int DCHUNK = 32;",
                   "constexpr int DCHUNK = 64;")], True),
    # the output stores cut (kept alive behind a test that never holds)
    "no_store": ([("__stcs(reinterpret_cast<float4*>(o + 16 * p), v);",
                   "if (v.x == 1234.5f) "
                   "__stcs(reinterpret_cast<float4*>(o + 16 * p), v);")],
                 False),
}


def cuda_ms(fn, iters):
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
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((2, 128, 128, 128, 1), generator=g, device=dev)
    k = torch.randn((7, 7, 7, 1, 64), generator=g, device=dev) * 343 ** -0.5
    scale = torch.rand(64, generator=g, device=dev) + 0.5
    shift = torch.randn(64, generator=g, device=dev) * 0.1
    want = K.stem_conv_raw_ref(x, k, scale, shift)
    shipped = SOURCE.read_text()
    rc = 0
    try:
        for name in names:
            subs, computes = VARIANTS[name]
            src = shipped
            for old, new in subs:
                if old not in src:
                    raise RuntimeError(f"{name}: {old!r} is not in the source")
                src = src.replace(old, new)
            SOURCE.write_text(src)
            _build.reset()
            _build.build_log = ""  # stays empty if this source was built before
            got = K.stem_conv_raw(x, k, scale, shift)
            err = ((got - want).abs().max() / want.abs().max()).item()
            del got
            ms = float(np.median([cuda_ms(
                lambda: K.stem_conv_raw(x, k, scale, shift), 3)
                for _ in range(10)]))
            ok = err <= 1e-4 or not computes
            rc |= not ok
            # ptxas's lines for the conv kernel: registers, spills, and
            # any note that it serialized the MMAs
            log = _build.build_log.partition("== stem_conv.cu")[2]
            ptxas = [line.strip()
                     for line in log.split("\n== ")[0].splitlines()
                     if "registers" in line or "spill" in line
                     or "wgmma" in line]
            print(json.dumps(dict(variant=name, device=smi, ms=ms,
                                  max_rel_err=err, ok=ok,
                                  nvcc_s=_build.build_seconds,
                                  ptxas=ptxas)), flush=True)
    finally:
        SOURCE.write_text(shipped)
    return rc


if __name__ == "__main__":
    sys.exit(main())
