"""K1 (``hiddenpose_tpu_torch/ops/kernels/conv3p.py``) against the JAX
package's Pallas stencil kernel, run in interpret mode on the CPU.

On the CPU the port's wrapper runs its plain version (pad + ``F.conv3d`` +
epilogue); the CUDA kernel itself is compared with that plain version on
the GPU by ``tests/test_torch_kernels_cuda.py``.  Inputs are made with
numpy from fixed seeds and handed to both.  Tolerance: both sides are f32
with f32 accumulation and differ only in summation order; 1e-5 absolute
and relative for unit-scale data.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hiddenpose_tpu.ops.pallas.conv3p import conv3_planes as jax_conv3_planes
from hiddenpose_tpu.ops.pallas.conv3p import conv3_planes_xla
import chip_smoke
from hiddenpose_tpu_torch.ops.kernels import _build
from hiddenpose_tpu_torch.ops.kernels import conv3_planes, conv3_planes_ref
from hiddenpose_tpu_torch.ops.kernels import conv3p as conv3p_mod
from hiddenpose_tpu_torch.ops.kernels.conv3p import (
    TilePlan,
    conv3_planes_tiled_ref,
    tile_plan,
)

SHAPE = (2, 8, 8, 16)  # (B, D, H, W), as the JAX kernel's own tests use

CASES = [
    # (cin, cout, pad_mode, act, residual, pre_relu)
    (1, 1, "edge", "none", False, None),
    (1, 1, "edge", "leaky", True, None),
    (1, 1, "zero", "none", True, None),
    (2, 3, "zero", "relu", False, None),
    (3, 2, "edge", "relu", True, True),
    (4, 4, "zero", "leaky", False, False),
    (4, 8, "zero", "leaky", True, True),
    (8, 4, "edge", "none", False, False),
]


def _inputs(cin, cout, residual, pre_relu, seed=0):
    rng = np.random.RandomState(seed)
    b, d, h, w = SHAPE
    arrs = {
        "x": rng.randn(b, cin, d, h, w),
        "kernel": rng.randn(3, 3, 3, cin, cout) / np.sqrt(27 * cin),
        "bias": rng.randn(cout) * 0.1,
        "residual": rng.randn(b, cout, d, h, w) if residual else None,
        "pre_scale": rng.rand(cin) + 0.5 if pre_relu is not None else None,
        "pre_shift": rng.randn(cin) * 0.1 if pre_relu is not None else None,
    }
    return {k: None if v is None else v.astype(np.float32)
            for k, v in arrs.items()}


@pytest.mark.parametrize("cin,cout,pad_mode,act,residual,pre_relu", CASES)
def test_conv3_planes_matches_jax(cin, cout, pad_mode, act, residual,
                                  pre_relu):
    """Against the Pallas kernel (interpret mode) and the JAX package's
    reference semantics ``conv3_planes_xla``.

    One known difference: with zero padding AND a pre-affine the Pallas
    kernel applies the affine to the zero-filled depth-halo planes too, so
    its first and last output planes see pre(0) where
    ``conv3_planes_xla`` (and its own docstring: pad the pre-affined
    input with zeros) see 0.  The port follows the documented semantics,
    so for those cases the Pallas comparison covers the interior planes
    and ``conv3_planes_xla`` the whole volume."""
    a = _inputs(cin, cout, residual, pre_relu)
    kw = dict(act=act, pad_mode=pad_mode, pre_relu=pre_relu)
    jargs = [None if v is None else jnp.asarray(v) for v in a.values()]
    got = conv3_planes(
        *[None if v is None else torch.from_numpy(v) for v in a.values()],
        **kw).numpy()
    pallas = np.asarray(jax_conv3_planes(*jargs, interpret=True, **kw))
    planes = (slice(1, -1) if pad_mode == "zero" and pre_relu is not None
              else slice(None))
    np.testing.assert_allclose(got[:, :, planes], pallas[:, :, planes],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(conv3_planes_xla(*jargs, **kw)),
                               rtol=1e-5, atol=1e-5)


def test_leaky_slope_applies_after_residual():
    """act(conv + residual): a residual that flips the sign of the sum must
    flip which side of the leaky slope the output lands on."""
    x = torch.zeros((1, 1, 3, 3, 3))
    k = torch.zeros((3, 3, 3, 1, 1))
    bias = torch.tensor([1.0])
    res = torch.full((1, 1, 3, 3, 3), -3.0)
    got = conv3_planes(x, k, bias, res, act="leaky")
    torch.testing.assert_close(got, torch.full_like(res, -0.4))


def test_pre_affine_precedes_zero_padding():
    """Zero padding pads pre(x), so a pre-shift never leaks into the
    border taps: an all-ones kernel over a constant input whose affine
    image is 1 counts exactly the in-volume taps."""
    x = torch.zeros((1, 1, 3, 3, 3))
    k = torch.ones((3, 3, 3, 1, 1))
    got = conv3_planes(x, k, pre_scale=torch.tensor([1.0]),
                       pre_shift=torch.tensor([1.0]), pre_relu=False)
    assert got[0, 0, 1, 1, 1] == 27.0   # centre: every tap inside
    assert got[0, 0, 0, 0, 0] == 8.0    # corner: 2 x 2 x 2 taps inside


def test_wrapper_validates_input():
    x = torch.zeros((1, 2, 4, 4, 4))
    k = torch.zeros((3, 3, 3, 2, 2))
    with pytest.raises(ValueError):
        conv3_planes(x, k[..., :1, :])                  # C_in mismatch
    with pytest.raises(ValueError):
        conv3_planes(x.transpose(3, 4), k)              # not contiguous
    with pytest.raises(TypeError):
        conv3_planes(x.double(), k.double())            # not float32
    with pytest.raises(ValueError):
        conv3_planes(x, k, act="gelu")
    with pytest.raises(ValueError):
        conv3_planes(x, k, residual=torch.zeros((1, 2, 4, 4, 5)))


def test_non_cpu_tensor_never_takes_the_plain_path():
    """Only a CPU tensor runs the plain version: any other device launches
    the kernel (CUDA) or raises, here on the meta device."""
    x = torch.zeros((1, 1, 4, 4, 4), device="meta")
    k = torch.zeros((3, 3, 3, 1, 1), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv3_planes(x, k)


def test_plain_version_is_what_the_cpu_wrapper_runs():
    a = _inputs(2, 3, True, True, seed=3)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in a.items()}
    n = conv3_planes.launches
    got = conv3_planes(*t.values(), act="relu", pre_relu=True)
    assert conv3_planes.launches == n  # a CPU call launches no kernel
    assert torch.equal(
        got, conv3_planes_ref(*t.values(), act="relu", pre_relu=True))


# K1's tile walk (``csrc/conv3p_tile.cuh``) written out in plain PyTorch:
# ``tile_plan`` cuts a call into blocks, ``conv3_planes_tiled_ref`` walks
# them.  The kernel itself is held to the plain version on the GPU.

# (b, source channels, destination channels, d, h, w): the 20 call shapes
# of a t128 batch-2 forward as K1 sees them and as K5 does (roles
# swapped), then ragged ones
PLAN_SHAPES = sorted({
    (chip_smoke.B, *chans, n, n, n)
    for cin, cout, n, *_ in chip_smoke.K1_SHAPES
    for chans in ((cin, cout), (cout, cin))})
PLAN_SHAPES += [(1, 1, 1, 1, 1, 1), (1, 3, 5, 5, 6, 7), (1, 5, 3, 9, 17, 33),
                (1, 20, 12, 9, 17, 33), (2, 12, 20, 2, 2, 2),
                (1, 2, 7, 1, 40, 9), (3, 300, 2, 4, 4, 100)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_tile_plan_covers_every_output_once_and_fits_the_card(shape):
    b, src, dst, d, h, w = shape
    p = tile_plan(*shape)
    assert p.tw == (32 if w > 16 else 16) and p.th == p.thr * p.r
    # the channel block pads dst least (and is 1 only for one channel)
    forms = conv3p_mod.TILE_FORMS
    assert (p.cb, p.r) in forms + ((1, 4),) and (p.cb == 1) == (dst == 1)
    assert dst == 1 or -(-dst // p.cb) * p.cb == min(
        -(-dst // cb) * cb for cb, _ in forms)
    # every voxel of every (batch, channel block) lies in exactly one
    # block, and the channel blocks cover dst with no empty one
    tiles, dchunks, bgroups = p.grid(b, dst, d, h, w)
    groups = bgroups // b
    assert bgroups == b * groups and (groups - 1) * p.cb < dst <= groups * p.cb
    count = torch.zeros((d, h, w), dtype=torch.int8)
    tiles_w = -(-w // p.tw)
    for tile in range(tiles):
        h0, w0 = tile // tiles_w * p.th, tile % tiles_w * p.tw
        for dc in range(dchunks):
            count[dc * p.chunk:(dc + 1) * p.chunk, h0:h0 + p.th,
                  w0:w0 + p.tw] += 1
    assert bool((count == 1).all())
    # and no tile or D run is empty
    assert (tiles // tiles_w - 1) * p.th < h and (dchunks - 1) * p.chunk < d
    # a block fits the card, and a unit's channels split evenly
    assert p.threads <= conv3p_mod.TILE_MAX_THREADS and p.threads % 16 == 0
    assert p.smem_bytes(src) <= conv3p_mod.TILE_MAX_SMEM
    assert 1 <= p.splits <= min(src, p.r * p.cb) and p.wres in (0, 1)
    assert p.cg == src or (p.cg % p.splits == 0 and p.cg < src)
    assert p.wres or p.cg < src
    # at least 128 blocks wherever one plane and one thread row a block
    # would give that many
    most = b * -(-dst // p.cb) * -(-h // p.r) * -(-w // p.tw) * d
    blocks = tiles * dchunks * bgroups
    assert blocks >= min(most, conv3p_mod.TILE_BLOCKS)
    assert p.chunk >= 1 and p.thr >= 1


def test_tile_plan_fills_the_card_at_the_path_shapes():
    """Each of the path's shapes gets at least 128 blocks, and the narrow
    convs at 128^3 get blocks that hold only the channels they have."""
    for shape in PLAN_SHAPES[:-7]:
        p = tile_plan(*shape)
        tiles, dchunks, bgroups = p.grid(shape[0], *shape[2:])
        assert tiles * dchunks * bgroups >= 128, shape
    assert tile_plan(2, 1, 1, 128, 128, 128).cb == 1
    assert tile_plan(2, 8, 4, 128, 128, 128).cb == 4
    assert tile_plan(2, 32, 32, 16, 16, 16).splits > 1


TILED_CASES = [
    # (cin, cout, (d, h, w), pad_mode, act, residual, pre_relu, plan)
    (1, 1, (1, 1, 1), "zero", "none", False, None, None),
    (1, 1, (1, 1, 1), "edge", "leaky", True, None, None),
    (2, 3, (2, 2, 2), "zero", "relu", True, True, None),
    (2, 3, (2, 2, 2), "edge", "none", False, False, None),
    (3, 5, (5, 6, 7), "zero", "leaky", True, None, None),
    (3, 5, (5, 6, 7), "edge", "relu", False, True, None),
    (1, 1, (9, 17, 33), "edge", "leaky", True, None,
     TilePlan(32, 1, 4, 2, 1, 4, 1, 1)),
    (5, 3, (9, 17, 33), "zero", "none", True, True,
     TilePlan(32, 4, 4, 2, 2, 3, 4, 1)),
    (20, 12, (5, 6, 7), "zero", "leaky", True, None,
     TilePlan(16, 4, 4, 1, 4, 2, 20, 1)),
    (20, 12, (5, 6, 7), "edge", "leaky", True, None,
     TilePlan(16, 4, 4, 2, 4, 5, 8, 0)),
    # forced plans: channel groups of 2 with 2 splits, D runs of 2; one
    # plane and thread row a block with 4 splits; all of D in one block
    (3, 5, (9, 17, 33), "zero", "none", False, False,
     TilePlan(16, 4, 4, 2, 2, 2, 2, 1)),
    (5, 9, (7, 9, 12), "edge", "leaky", True, None,
     TilePlan(16, 8, 2, 1, 4, 1, 4, 0)),
    (4, 4, (6, 20, 40), "zero", "relu", True, True,
     TilePlan(32, 4, 4, 1, 1, 6, 4, 1)),
    (4, 1, (6, 20, 40), "edge", "none", False, None,
     TilePlan(32, 1, 4, 2, 4, 3, 4, 1)),
]


@pytest.mark.parametrize("cin,cout,dhw,pad_mode,act,residual,pre_relu,plan",
                         TILED_CASES)
def test_tiled_ref_matches_plain(cin, cout, dhw, pad_mode, act, residual,
                                 pre_relu, plan):
    """The tile walk (halo planes, D runs, channel units, split fold,
    ragged tiles) computes the plain version's function: 1e-5 of the
    output's max, the two differing in summation order only."""
    rng = np.random.RandomState(7)
    b = 2 if dhw[2] < 30 else 1
    x = torch.from_numpy(rng.randn(b, cin, *dhw).astype(np.float32))
    k = torch.from_numpy((rng.randn(3, 3, 3, cin, cout)
                          / np.sqrt(27 * cin)).astype(np.float32))
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32))
    res = (torch.from_numpy(rng.randn(b, cout, *dhw).astype(np.float32))
           if residual else None)
    pre = ()
    if pre_relu is not None:
        pre = (torch.from_numpy((rng.rand(cin) + 0.5).astype(np.float32)),
               torch.from_numpy(rng.randn(cin).astype(np.float32)))
    kw = dict(act=act, pad_mode=pad_mode, pre_relu=pre_relu)
    want = conv3_planes_ref(x, k, bias, res, *pre, **kw)
    got = conv3_planes_tiled_ref(x, k, bias, res, *pre, plan=plan, **kw)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_tiled_ref_pre_affine_precedes_zero_padding():
    """As ``test_pre_affine_precedes_zero_padding``, through the tile walk:
    the halo of a zero-padded volume stays 0 under a pre-shift."""
    x = torch.zeros((1, 1, 3, 3, 3))
    k = torch.ones((3, 3, 3, 1, 1))
    got = conv3_planes_tiled_ref(x, k, pre_scale=torch.tensor([1.0]),
                                 pre_shift=torch.tensor([1.0]),
                                 pre_relu=False)
    assert got[0, 0, 1, 1, 1] == 27.0 and got[0, 0, 0, 0, 0] == 8.0


@pytest.mark.parametrize("splits,values,want", [
    (4, (1e8, 1.0, -1e8, 1.0), 1.0),
    (4, (1.0, 1e8, 1.0, -1e8), 0.0),
    (2, (1e8, 1.0, -1e8, 1.0), 2.0),
])
def test_split_fold_adds_in_split_order(splits, values, want):
    """Four channels through the centre tap, where f32 gives
    1e8 + 1 == 1e8.  Four thread groups, one channel each, added in group
    order: ((1e8 + 1) - 1e8) + 1 = 1, and ((1 + 1e8) + 1) - 1e8 = 0 for
    the other arrangement.  Two groups take channels (0, 2) and (1, 3):
    (1e8 - 1e8) + (1 + 1) = 2.  Another fold order would give another of
    0, 1, 2."""
    x = torch.tensor(values).view(1, 4, 1, 1, 1)
    k = torch.zeros((3, 3, 3, 4, 1))
    k[1, 1, 1] = 1.0
    plan = TilePlan(16, 1, 4, 1, splits, 1, 4, 1)
    got = conv3_planes_tiled_ref(x, k, plan=plan)
    assert got.item() == want
    assert torch.equal(got, conv3_planes_tiled_ref(x, k, plan=plan))


def test_library_name_hashes_the_shared_headers(tmp_path, monkeypatch):
    """K1 and K5 live in ``conv3p_tile.cuh``: an edit to it (or to any
    header the sources share) must give the library another name, or a
    stale build would be loaded."""
    for name in _build.SOURCES + _build.HEADERS:
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._digest()
    assert "conv3p_tile.cuh" in _build.HEADERS
    for name in _build.HEADERS:
        with open(tmp_path / name, "a") as f:
            f.write("// edited\n")
        after = _build._digest()
        assert after != before
        before = after
