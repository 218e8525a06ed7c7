"""The four probe kernels of the stem kernels' building blocks.

Replace the four ``pl.pallas_call``s of ``scripts/tpu_diag_stem_paired.py``
(``check_a`` ``:57``, ``check_b`` ``:89``, ``check_c`` ``:109`` and
``:126``).  On the TPU they isolated which lowered op of the paired-lane
stem kernel mis-computed; here each is a tiny hand-written CUDA kernel
(``csrc/diag_probes.cu``) that isolates, on an exact case, an operation the
stem kernels use today (``csrc/stem_conv_bf16.cu``'s tensor-map copies on
mbarriers and swizzled tiles, ``csrc/stem_conv.cu``'s f32 products), held
against the numpy / torch expression the TPU script compares with:

* A, :func:`probe_im2col`: the paired im2col store, x (8, 8, 8, 128) ->
  patches (80, 8, 128), as tensor-map (TMA) box loads of x and box stores
  of the patches (:func:`im2col_plan`); a box whose lane start is not
  16-byte aligned, which the copy engine refuses, as a halo load meets it,
  is loaded from the aligned lane below, 4 lanes wider, and shifted in
  shared memory; exact;
* B, :func:`probe_slice_transpose`: (M, N) -> ``x[:, :N/2].T`` and
  ``x[:, N/2:].T``, tiles loaded by tensor-map boxes under the 128-byte
  swizzle, transposed in shared memory through the swizzle's bank map,
  stored by tensor-map boxes; exact;
* C and C64, :func:`probe_dot_f32`: a float32 SIMT FMA tiled matrix
  product (no TF32) at N = 128 and N = 64, against ``torch.matmul``: small
  output tiles that fill the card, k-slices by ``cp.async``, partial sums
  added in a fixed order (two calls agree bit for bit); its launch is no
  slower than the library's.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.  ``scripts/torch_diag_stem_paired.py`` runs
them on the GPU; ``scripts/torch_probe_times.py`` times them.
"""

from __future__ import annotations

import numpy as np
import torch

from hiddenpose_tpu_torch.ops.kernels import _build

# The probe's fixed geometry (scripts/tpu_diag_stem_paired.py:36-37).
CIN, TD, TH = 8, 4, 4
NC = TD // 2 * TH          # 8 paired columns
ROWS = 2 * 5 * CIN         # (ah, aw, cin) rows of the patch matrix
X_SHAPE = (CIN, TD + 4, TH + 4, 128)

# A's boxes hold 2 channels (the kernel takes 2 boxes a block: 80 blocks),
# chosen by device time on the H100 among the plans of
# scripts/torch_probe_variants.py (PERF.md §6, probe A).
IM2COL_CIN_PER_BOX = 2


def _dispatch(name, x, ref, launch, wrapper):
    """Plain version on the CPU, the kernel on CUDA, else raise."""
    _build.no_grad_inputs(name, x, use="torch.no_grad()")
    if x.device.type == "cpu":
        return ref()
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    out = launch()
    wrapper.launches += 1
    return out


def probe_im2col_ref(x):
    """Plain version: the slice-assignment loop of the TPU script."""
    want = torch.zeros((ROWS, NC, 128), dtype=x.dtype, device=x.device)
    for ah in range(2):
        for aw in range(5):
            off = (ah * 5 + aw) * CIN
            for dd in range(TD):
                d2, lsb = dd // 2, dd % 2
                want[off:off + CIN, d2 * TH:(d2 + 1) * TH,
                     lsb * 64:(lsb + 1) * 64] = \
                    x[:, ah + dd, ah:ah + TH, aw:aw + 64]
    return want


def im2col_plan():
    """A's copies: ``(box, coords)``.

    ``box`` is the shape (innermost first) of every box: (64 lanes, TH
    rows, 1 plane, ``IM2COL_CIN_PER_BOX`` channels) of x seen as (128, XH,
    XD, CIN), and the same box of the patches seen as (128, TH, NC / TH,
    80).  ``coords`` (int32, a row a box) holds each box's coordinates on
    x's map (lane aw, row ah, plane ah + dd, channel c) and on the patches'
    (lane 64 lsb, row 0, sub-tile d2, patch row (5 ah + aw) CIN + c), for
    each (ah, aw, dd = 2 d2 + lsb) piece.  The kernel loads each box from
    lane ``aw & ~3``, 4 lanes wider, and shifts it by ``aw & 3`` in shared
    memory."""
    rows = []
    for ah in range(2):
        for aw in range(5):
            for dd in range(TD):
                d2, lsb = divmod(dd, 2)
                for c in range(0, CIN, IM2COL_CIN_PER_BOX):
                    rows.append((aw, ah, ah + dd, c,
                                 64 * lsb, 0, d2, (ah * 5 + aw) * CIN + c))
    return (64, TH, 1, IM2COL_CIN_PER_BOX), np.array(rows, np.int32)


_plan_on = {}  # A's plan on each device: (coords tensor, box as C ints)


def probe_im2col(x):
    """x (8, 8, 8, 128) float32, 16-byte aligned -> patches (80, 8, 128):
    row (ah*5 + aw)*8 + cin, sub-tile row d2*4 + h, lane half lsb*64 + w
    holds ``x[cin, ah + 2*d2 + lsb, ah + h, aw + w]``."""
    _build.check(x, "x", shape=X_SHAPE, device=x.device, aligned=True)

    def launch():
        if x.device not in _plan_on:
            box, coords = im2col_plan()
            _plan_on[x.device] = (torch.from_numpy(coords).to(x.device),
                                  _build.int_args(*box))
        coords, box = _plan_on[x.device]
        out = torch.empty((ROWS, NC, 128), device=x.device,
                          dtype=torch.float32)
        _build.launch("hp_probe_im2col", x.data_ptr(), out.data_ptr(), box,
                      coords.data_ptr(), len(coords), device=x.device)
        return out

    return _dispatch("probe_im2col", x, lambda: probe_im2col_ref(x), launch,
                     probe_im2col)


probe_im2col.launches = 0


def probe_slice_transpose_ref(x):
    half = x.shape[1] // 2
    return x[:, :half].T.contiguous(), x[:, half:].T.contiguous()


def slice_transpose_paths(m: int, n: int):
    """(x by TMA, lo and hi by TMA) for an (m, n) x: a tensor map needs
    its rows' stride in multiples of 16 bytes (4 n for x, 4 m for lo and
    hi) and a box's first column on a 16-byte boundary (hi's tiles start at
    column n / 2 of x)."""
    return n % 8 == 0, m % 4 == 0


def probe_slice_transpose(x):
    """x (M, N) float32, 16-byte aligned, N even -> (``x[:, :N/2].T``,
    ``x[:, N/2:].T``), each (N/2, M).

    The shape decides each side's path (:func:`slice_transpose_paths`): x's
    tiles arrive by tensor-map boxes where N % 8 == 0, else each thread
    loads elements; lo's and hi's leave by tensor-map boxes where M % 4 ==
    0, else each thread stores elements.  Both sides go through the same
    swizzled shared-memory tiles and the same transpose, in one kernel.
    The probe's (512, 128) runs on tensor maps end to end; (64, 6) stores
    by them and loads by threads; (70, 36) and (33, 2) do neither."""
    if x.dim() != 2 or x.shape[1] % 2:
        raise ValueError(f"x must be (M, N) with N even, got {tuple(x.shape)}")
    _build.check(x, "x", device=x.device, aligned=True)
    m, n = x.shape

    def launch():
        lo = torch.empty((n // 2, m), device=x.device, dtype=torch.float32)
        hi = torch.empty_like(lo)
        tma_in, tma_out = slice_transpose_paths(m, n)
        _build.launch("hp_probe_slice_transpose", x.data_ptr(), lo.data_ptr(),
                      hi.data_ptr(), m, n, int(tma_in), int(tma_out),
                      device=x.device)
        return lo, hi

    return _dispatch("probe_slice_transpose", x,
                     lambda: probe_slice_transpose_ref(x), launch,
                     probe_slice_transpose)


probe_slice_transpose.launches = 0


def probe_dot_f32_ref(a, b):
    """Plain version: ``torch.matmul`` (full float32 where TF32 is off)."""
    return torch.matmul(a, b)


def probe_dot_f32(a, b):
    """a (M, K) @ b (K, N), float32 FMA, f32 accumulation -> (M, N)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a (M, K) and b (K, N) expected, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    _build.check(a, "a", device=a.device)
    _build.check(b, "b", device=a.device)
    _build.no_grad_inputs("probe_dot_f32", b, use="torch.no_grad()")
    m, k = a.shape
    n = b.shape[1]

    def launch():
        out = torch.empty((m, n), device=a.device, dtype=torch.float32)
        _build.launch("hp_probe_dot_f32", a.data_ptr(), b.data_ptr(),
                      out.data_ptr(), m, k, n, device=a.device)
        return out

    return _dispatch("probe_dot_f32", a, lambda: probe_dot_f32_ref(a, b),
                     launch, probe_dot_f32)


probe_dot_f32.launches = 0
