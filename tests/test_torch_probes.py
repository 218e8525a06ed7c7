"""The plain versions of the four stem probes
(``hiddenpose_tpu_torch/ops/kernels/probes.py``) against the numpy
expressions that ``scripts/tpu_diag_stem_paired.py`` compares its Pallas
kernels with, on the probe's own inputs.  On a CPU tensor each wrapper runs
its plain version; the CUDA kernels are held against these on the GPU
(``tests/test_torch_kernels_cuda.py``, ``scripts/torch_diag_stem_paired.py``).
The gathers are exact; the product is held to 1e-5 of its largest value,
the TPU script's own limit.  The CUDA kernels' copy plans are applied here
with numpy slicing: A's tensor-map boxes (``probes.im2col_plan``) and B's
tiles with their swizzled transpose, as the kernels derive them."""

import re

import numpy as np
import pytest
import torch

from hiddenpose_tpu_torch.ops.kernels import KERNELS, PROBES, _build, probes
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

CIN, TD, TH = 8, 4, 4
NC = TD // 2 * TH


def test_im2col_plain_version_is_the_tpu_script_loop():
    x = np.random.RandomState(0).rand(CIN, TD + 4, TH + 4, 128).astype(
        np.float32)
    want = np.zeros((80, NC, 128), np.float32)
    for ah in range(2):
        for aw in range(5):
            off = (ah * 5 + aw) * CIN
            for dd in range(TD):
                d2, lsb = dd // 2, dd % 2
                want[off:off + CIN, d2 * TH:(d2 + 1) * TH,
                     lsb * 64:(lsb + 1) * 64] = \
                    x[:, ah + dd, ah:ah + TH, aw:aw + 64]
    got = probes.probe_im2col(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    # the closed form the CUDA kernel gathers by
    r, col, lane = 3 * CIN + 5, 6, 70  # ah 0, aw 3, cin 5; d2 1, h 2; lsb 1
    assert got[r, col, lane] == x[5, 0 + 2 * 1 + 1, 0 + 2, 3 + 6]
    with pytest.raises(ValueError):
        probes.probe_im2col(torch.zeros(8, 8, 8, 64))


def _tpu_script_im2col(x):
    """scripts/tpu_diag_stem_paired.py:45-82's expected patches."""
    want = np.zeros((80, NC, 128), np.float32)
    for ah in range(2):
        for aw in range(5):
            off = (ah * 5 + aw) * CIN
            for dd in range(TD):
                d2, lsb = dd // 2, dd % 2
                want[off:off + CIN, d2 * TH:(d2 + 1) * TH,
                     lsb * 64:(lsb + 1) * 64] = \
                    x[:, ah + dd, ah:ah + TH, aw:aw + 64]
    return want


def _cu_constant(name):
    """A constant of csrc/diag_probes.cu, as the kernels are built."""
    src = (_build.CSRC / "diag_probes.cu").read_text()
    (value,) = re.findall(rf"constexpr int {name} = (\d+);", src)
    return int(value)


def test_im2col_box_plan_is_the_tpu_script_loop():
    """A's boxes applied as the kernel does: each box of x loaded from the
    16-byte boundary below its lane start (lane & ~3), 4 lanes wider, at
    its coordinates on x's map (row, plane, channel), shifted by lane & 3,
    and written at its coordinates on the patches' (lane, row, sub-tile,
    patch row).  Every box lies inside both tensors (no zero fill, no
    clipping), every patch element is written once, and the result is the
    TPU script's, exactly.  The plan's lane starts include ones that are
    not 16-byte aligned."""
    x = np.random.RandomState(0).rand(*probes.X_SHAPE).astype(np.float32)
    box, coords = probes.im2col_plan()
    bl, br, bp, bc = box
    out = np.full((80, NC // TH, TH, 128), np.nan, np.float32)
    writes = np.zeros(out.shape, np.int32)
    for lane, row, plane, c, olane, orow, sub, prow in coords.tolist():
        lane0 = lane & ~3  # the load's start and width, lanes
        assert lane0 + bl + 4 <= 128 and row + br <= TH + 4
        assert plane + bp <= TD + 4 and c + bc <= CIN
        assert olane + bl <= 128 and orow + br <= TH
        assert sub + bp <= NC // TH and prow + bc <= 80
        dst = (slice(prow, prow + bc), slice(sub, sub + bp),
               slice(orow, orow + br), slice(olane, olane + bl))
        loaded = x[c:c + bc, plane:plane + bp, row:row + br,
                   lane0:lane0 + bl + 4]
        out[dst] = loaded[..., lane - lane0:lane - lane0 + bl]
        writes[dst] += 1
    assert (writes == 1).all()
    got = out.reshape(80, NC, 128)
    np.testing.assert_array_equal(got, _tpu_script_im2col(x))
    np.testing.assert_array_equal(
        got, probes.probe_im2col_ref(torch.from_numpy(x)).numpy())
    # the kernel's limits: a block's boxes each on an mbarrier, 48 KB of
    # load and store slots, each rounded to 128 bytes, from a 128-byte
    # boundary; at least 40 blocks, several boxes in flight in each
    per_block = _cu_constant("BOXES_PER_BLOCK")

    def slot(lanes):
        return -(-4 * lanes * br * bp * bc // 128) * 128

    assert len(coords) % per_block == 0
    assert len(coords) // per_block >= 40 and per_block > 1
    assert 128 + per_block * (slot(bl + 4) + slot(bl)) <= 48 * 1024
    assert (4 * bl) % 16 == 0
    assert sorted({lane % 4 for lane in coords[:, 0]}) == [0, 1, 2, 3]


def _swz(row, piece):
    """Byte offset of 16-byte piece ``piece`` of 128-byte row ``row`` under
    the 128-byte swizzle (csrc/diag_probes.cu ``swz``)."""
    return row * 128 + 16 * (piece ^ (row % 8))


def _transpose_threads(tile_rows):
    """B's threads: (sub-tile, rb, cb) of each, rows 4 rb.. and columns
    4 cb.. of its 32 x 32 sub-tile."""
    tid = np.arange(2 * tile_rows)
    q, rb = tid // 8 % 8, tid % 8
    return tid // 64, rb, rb ^ q


def test_slice_transpose_swizzle_has_no_bank_conflict():
    """Each phase of 8 threads of B's 16-byte reads and writes touches 8
    distinct 16-byte bank groups, and the threads cover every 4 x 4 block
    of the tile once."""
    tile_rows = _cu_constant("TR")
    s, rb, cb = _transpose_threads(tile_rows)
    assert len({(a, b, c) for a, b, c in zip(s, rb, cb)}) == 2 * tile_rows
    for p in range(0, 2 * tile_rows, 8):
        for k in range(4):
            reads = {_swz(32 * s[i] + 4 * rb[i] + k, cb[i]) // 16 % 8
                     for i in range(p, p + 8)}
            writes = {_swz(4 * cb[i] + k, rb[i]) // 16 % 8
                      for i in range(p, p + 8)}
            assert len(reads) == 8 and len(writes) == 8


@pytest.mark.parametrize("shape", [(512, 128), (70, 36), (64, 6), (33, 2)])
def test_slice_transpose_tile_plan(shape):
    """B's blocks as the kernel derives them from its index, applied with
    numpy, at the probe's shape and at shapes that take its thread paths
    (``slice_transpose_paths``; the tiles and the transpose are the same on
    every path): each loads the box of 32 columns x ``tile_rows`` rows of
    its half at (z * N/2 + c0, r0) (zeros past x's edge, as a tensor map
    fills them) into the swizzled tile, its threads transpose their 4 x 4 blocks into
    the swizzled 32 x 32 store boxes, and each box lands in lo or hi at
    (r0 + 32 s, c0), clipped to the tensor.  The result is the plain
    version's, exactly, with every element written once."""
    m, n = shape
    half = n // 2
    tile_rows = _cu_constant("TR")
    x = np.random.RandomState(1).rand(m, n).astype(np.float32)
    outs = [np.full((half, m), np.nan, np.float32) for _ in range(2)]
    writes = [np.zeros((half, m), np.int32) for _ in range(2)]
    s_, rb_, cb_ = _transpose_threads(tile_rows)
    grid = (-(-half // 32), -(-m // tile_rows), 2)
    for z in range(grid[2]):
        for by in range(grid[1]):
            for bx in range(grid[0]):
                c0, r0 = 32 * bx, tile_rows * by
                box = np.zeros((tile_rows, 32), np.float32)
                part = x[r0:r0 + tile_rows, z * half + c0:z * half + c0 + 32]
                box[:part.shape[0], :part.shape[1]] = part
                a = np.zeros(tile_rows * 32, np.float32)  # the swizzled tile
                for r in range(tile_rows):
                    for p in range(8):
                        a[_swz(r, p) // 4:_swz(r, p) // 4 + 4] = \
                            box[r, 4 * p:4 * p + 4]
                b = np.zeros(tile_rows * 32, np.float32)  # the store boxes
                for s, rb, cb in zip(s_, rb_, cb_):
                    v = np.stack([a[_swz(32 * s + 4 * rb + k, cb) // 4:][:4]
                                  for k in range(4)])
                    for j in range(4):
                        at = (s * 4096 + _swz(4 * cb + j, rb)) // 4
                        b[at:at + 4] = v[:, j]
                for s in range(tile_rows // 32):
                    if r0 + 32 * s >= m:
                        break
                    sub = np.stack([
                        np.concatenate([b[(s * 4096 + _swz(j, p)) // 4:][:4]
                                        for p in range(8)])
                        for j in range(32)])  # (x column, x row)
                    rows = min(32, half - c0)
                    cols = min(32, m - r0 - 32 * s)
                    dst = (slice(c0, c0 + rows),
                           slice(r0 + 32 * s, r0 + 32 * s + cols))
                    outs[z][dst] = sub[:rows, :cols]
                    writes[z][dst] += 1
    lo, hi = probes.probe_slice_transpose_ref(torch.from_numpy(x))
    np.testing.assert_array_equal(outs[0], lo.numpy())
    np.testing.assert_array_equal(outs[1], hi.numpy())
    assert all((w == 1).all() for w in writes)
    assert probes.slice_transpose_paths(m, n) == (n % 8 == 0, m % 4 == 0)


@pytest.mark.parametrize("shape", [(512, 128), (70, 36)])
def test_slice_transpose_plain_version(shape):
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    lo, hi = probes.probe_slice_transpose(torch.from_numpy(x))
    half = shape[1] // 2
    np.testing.assert_array_equal(lo.numpy(), x[:, :half].T)
    np.testing.assert_array_equal(hi.numpy(), x[:, half:].T)
    assert lo.is_contiguous() and hi.is_contiguous()
    with pytest.raises(ValueError):
        probes.probe_slice_transpose(torch.zeros(4, 5))


@pytest.mark.parametrize("n", [128, 64])
def test_dot_plain_version(n):
    rng = np.random.RandomState(2)
    a = (rng.randn(512, 1024) * 0.1).astype(np.float32)
    b = rng.rand(1024, 128).astype(np.float32)[:, :n].copy()
    got = probes.probe_dot_f32(torch.from_numpy(a), torch.from_numpy(b))
    want = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= 1e-5
    with pytest.raises(ValueError):
        probes.probe_dot_f32(torch.zeros(4, 5), torch.zeros(4, 5))


def test_probes_are_registered_and_refuse_other_devices():
    assert set(PROBES) <= set(KERNELS)
    for name in PROBES:
        assert KERNELS[name][2] == "hiddenpose_tpu_torch/csrc/diag_probes.cu"
        assert KERNELS[name][3].startswith("scripts/tpu_diag_stem_paired.py:")
    with pytest.raises(ValueError, match="unsupported device"):
        probes.probe_slice_transpose(torch.zeros(4, 4, device="meta"))
    x = torch.zeros(4, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        probes.probe_slice_transpose(x)
