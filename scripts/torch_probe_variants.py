"""Time diagnostic variants of probes A and B (``csrc/diag_probes.cu``) on
one GPU.

    python3 scripts/torch_probe_variants.py

Each build is the shipped source with two constants substituted, A's boxes
a block (``BOXES_PER_BLOCK``) and B's x rows a tile (``TR``), written in
place of it and built anew (the library's name hashes the sources); the
source is restored at the end.  Under each build A runs at each of its
channels a box (``probes.IM2COL_CIN_PER_BOX``, set for the run) and B at
the probe's (512, 128) and at (70, 36) and (33, 2), which take its thread
paths.  One JSON line a (build, probe, shape): the card's name and power
limit, whether the result is the plain version's exactly, the blocks of a
launch, and the launch's device time and host times
(``torch_probe_times.time_launch``).  Exits non-zero when a variant is not
exact.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch_diag_stem_paired as diag  # noqa: E402
import torch_probe_times as ptimes  # noqa: E402
from hiddenpose_tpu_torch.ops.kernels import _build, probes  # noqa: E402

SOURCE = _build.CSRC / "diag_probes.cu"
# (A's boxes a block, B's tile rows, A's channels a box under that build);
# the first is the shipped source
BUILDS = [(2, 32, (2, 4)), (4, 64, (2, 4)), (8, 128, (1,)), (1, 32, (8,))]
B_SHAPES = ((512, 128), (70, 36), (33, 2))


def substituted(shipped: str, per_block: int, tile_rows: int) -> str:
    src = shipped
    for old, new in (("constexpr int BOXES_PER_BLOCK = 2;",
                      f"constexpr int BOXES_PER_BLOCK = {per_block};"),
                     ("constexpr int TR = 32; ",
                      f"constexpr int TR = {tile_rows}; ")):
        if src.count(old) != 1:
            raise RuntimeError(f"{old!r} is not once in the source")
        src = src.replace(old, new)
    return src


def main() -> int:
    dev = torch.device("cuda:0")
    smi = ptimes.smi_line()
    inp = diag.probe_inputs(dev)
    x = inp["x_a"]
    g = torch.Generator(device=dev).manual_seed(0)
    xs = {s: inp["x_b"] if s == (512, 128) else
          torch.rand(s, generator=g, device=dev) for s in B_SHAPES}
    want_a = probes.probe_im2col_ref(x)
    shipped = SOURCE.read_text()
    shipped_cin = probes.IM2COL_CIN_PER_BOX
    rc = 0
    try:
        for per_block, tile_rows, cins in BUILDS:
            SOURCE.write_text(substituted(shipped, per_block, tile_rows))
            _build.reset()
            runs = [("A", (8, 8, 8, 128), cin) for cin in cins]
            runs += [("B", s, None) for s in B_SHAPES]
            for probe, shape, cin in runs:
                if probe == "A":
                    probes.IM2COL_CIN_PER_BOX = cin
                    probes._plan_on.clear()
                    call, want = (lambda: probes.probe_im2col(x)), (want_a,)
                    blocks = len(probes.im2col_plan()[1]) // per_block
                    plan = dict(cin_per_box=cin, boxes_per_block=per_block)
                else:
                    t = xs[shape]
                    call = (lambda t=t: probes.probe_slice_transpose(t))
                    want = probes.probe_slice_transpose_ref(t)
                    blocks = 2 * -(-shape[1] // 64) * -(-shape[0] // tile_rows)
                    plan = dict(tile_rows=tile_rows,
                                paths=probes.slice_transpose_paths(*shape))
                entry, args, got = ptimes.recorded_launch(call)
                got = (got,) if probe == "A" else got
                exact = all(torch.equal(a, b) for a, b in zip(got, want))
                rc |= not exact
                print(json.dumps(dict(
                    probe=probe, shape=shape, device=smi, exact=exact,
                    blocks=blocks, build_s=_build.build_seconds, **plan,
                    **ptimes.time_launch(entry, args, dev))), flush=True)
    finally:
        SOURCE.write_text(shipped)
        probes.IM2COL_CIN_PER_BOX = shipped_cin
        probes._plan_on.clear()
    return rc


if __name__ == "__main__":
    sys.exit(main())
