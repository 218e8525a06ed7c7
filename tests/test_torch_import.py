"""Checkpoint-converter parity: torch reference modules vs imported flax.

Ground truth is the ACTUAL reference implementation at ``/root/reference``
(imported with its unavailable heavy deps stubbed — yacs/torchvision/cv2 are
only touched at module import, never by the module trees under test).  Each
test randomises a torch module (params + BN running stats), runs its eval
forward, converts the ``state_dict`` through
``hiddenpose_tpu.utils.torch_import`` and asserts the flax forward matches
numerically.  This is the strongest possible evidence that importing the
released HiddenPose weights reproduces the reference network — MPJPE parity
(BASELINE.md) then only depends on the (golden-tested) LCT physics layer.
"""

import os
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hiddenpose_tpu.utils.torch_import import (
    convert_feature_extraction,
    convert_posenet,
    convert_state_dict,
    convert_unet,
    _Taker,
)
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

REF = "/root/reference"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference checkout not mounted"
)


def _import_reference():
    """Import the reference torch modules with stub deps (module-scope
    imports only; the NN classes use none of the stubbed symbols)."""
    if REF not in sys.path:
        sys.path.insert(0, REF)
    for name in (
        "yacs", "yacs.config", "torchsummary", "cv2",
        "torchvision", "torchvision.transforms",
        "torchvision.transforms.functional", "torchvision.models",
        "torchvision.models.resnet",
    ):
        if name not in sys.modules:
            mod = types.ModuleType(name)
            mod.__path__ = []  # mark as package for submodule imports
            sys.modules[name] = mod
    import importlib

    class _CfgNode(dict):
        def __getattr__(self, k):
            return self[k]

        def __setattr__(self, k, v):
            self[k] = v

    sys.modules["yacs"].config = sys.modules["yacs.config"]
    sys.modules["yacs.config"].CfgNode = _CfgNode
    sys.modules["torchsummary"].summary = lambda *a, **k: None
    sys.modules["torchvision"].transforms = sys.modules[
        "torchvision.transforms"
    ]
    sys.modules["torchvision.transforms"].functional = sys.modules[
        "torchvision.transforms.functional"
    ]
    # unet3d imports the dataloader+config at module level; both import cv2
    # (stubbed above) — if they pull more, stub lazily via a dummy module.
    try:
        fe = importlib.import_module("models.feature_extraction")
    except ModuleNotFoundError as e:  # pragma: no cover
        pytest.skip(f"reference import failed: {e}")
    unet = importlib.import_module("unet.unet3d")
    pn = importlib.import_module("models.posenet3d_50")
    return fe, unet, pn


def _randomize(module, seed: int):
    """Deterministic nontrivial params + running stats."""
    import torch

    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.from_numpy(
                (rng.randn(*p.shape) * 0.1).astype(np.float32)
            ))
        for name, buf in module.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(
                    (rng.randn(*buf.shape) * 0.1).astype(np.float32)
                ))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(
                    (rng.rand(*buf.shape) * 0.5 + 0.5).astype(np.float32)
                ))
    module.eval()
    return module


def _sd(module, prefix):
    return {
        f"{prefix}.{k}": v.numpy() for k, v in module.state_dict().items()
    }


def test_feature_extraction_parity():
    import torch

    fe_mod, _, _ = _import_reference()
    tm = _randomize(
        fe_mod.FeatureExtraction(basedim=1, in_channels=1, stride=1), seed=0
    )
    x = np.random.RandomState(1).rand(1, 1, 8, 16, 16).astype(np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x)).numpy()

    from hiddenpose_tpu.models.blocks import FeatureExtraction

    take = _Taker(_sd(tm, "feature_extraction"))
    params = convert_feature_extraction(take)
    assert not take.leftovers()

    ours = FeatureExtraction(basedim=1, stride=1)
    got = ours.apply(
        {"params": params}, jnp.asarray(x.transpose(0, 2, 3, 4, 1)), False
    )
    got = np.asarray(got).transpose(0, 4, 1, 2, 3)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_unet_parity():
    import torch

    _, unet_mod, _ = _import_reference()
    tm = _randomize(unet_mod.UNet3d(1, 4), seed=2)
    x = np.random.RandomState(3).rand(1, 1, 16, 16, 16).astype(np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x)).numpy()

    from hiddenpose_tpu.models.unet3d import UNet3d

    take = _Taker(_sd(tm, "autoencoder"))
    params = convert_unet(take)
    assert not take.leftovers()

    got = UNet3d(in_channels=1, n_channels=4).apply(
        {"params": params}, jnp.asarray(x.transpose(0, 2, 3, 4, 1)), False
    )
    got = np.asarray(got).transpose(0, 4, 1, 2, 3)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.slow
def test_posenet_parity():
    import torch

    _, _, pn_mod = _import_reference()
    tm = _randomize(pn_mod.get_pose_net_50(), seed=4)
    x = np.random.RandomState(5).rand(1, 1, 16, 16, 16).astype(np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x)).numpy()

    from hiddenpose_tpu.models.posenet3d import PoseNet3D

    take = _Taker(_sd(tm, "pose_net"))
    params, stats = convert_posenet(take)
    assert not take.leftovers()

    got = PoseNet3D(num_joints=24).apply(
        {"params": params, "batch_stats": stats},
        jnp.asarray(x.transpose(0, 2, 3, 4, 1)),
        train=False,
    )
    got = np.asarray(got).transpose(0, 4, 1, 2, 3)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


@pytest.mark.slow
def test_full_state_dict_round_trip():
    """Converting a full NlosPose state_dict fills our variable tree exactly:
    same structure, same shapes, no unconsumed reference keys."""
    import torch

    fe_mod, unet_mod, pn_mod = _import_reference()
    sd = {}
    sd.update(_sd(
        fe_mod.FeatureExtraction(basedim=1, in_channels=1, stride=1),
        "feature_extraction",
    ))
    sd.update(_sd(unet_mod.UNet3d(1, 4), "autoencoder"))
    sd.update(_sd(pn_mod.get_pose_net_50(), "pose_net"))

    tree = convert_state_dict(sd)

    from hiddenpose_tpu.config import Config
    from hiddenpose_tpu.models.nlospose import build_nlospose

    cfg = Config().tiny(16)
    model, lct = build_nlospose(cfg.model)
    meas = jnp.zeros((1, 1, 16, 16, 16), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), meas, lct)

    def paths(t):
        return {
            "/".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]
        }

    # The tiny config differs from t128 only in SPATIAL size — the param
    # tree (all conv kernels / norms) is size-independent, so structure and
    # shapes must match exactly.
    want_p = paths(variables["params"])
    got_p = paths(tree["params"])
    assert got_p == want_p
    want_s = paths(variables["batch_stats"])
    got_s = paths(tree["batch_stats"])
    assert got_s == want_s


def _import_reference_nlospose():
    """Import the composed reference model.  `models/NlosPose.py` pulls in
    `models/posenet.py`, whose module scope does
    `from torchvision.models.resnet import BasicBlock, Bottleneck` — the
    2D path we never instantiate — so the stub gets placeholder classes."""
    fe_mod, unet_mod, pn_mod = _import_reference()
    import importlib

    resnet_stub = sys.modules["torchvision.models.resnet"]
    resnet_stub.BasicBlock = type("BasicBlock", (), {})
    resnet_stub.Bottleneck = type("Bottleneck", (), {})
    from hiddenpose_tpu.utils.torch_fft_shim import install

    install()  # torch.rfft/ifft (legacy API) for feature_propagation.py:228,235

    # `LCT._parpareparam` ends with an unconditional `todev('cuda', 1)`
    # (feature_propagation.py:109); coerce every todev to CPU (the CPU-only
    # torch here has no CUDA, and NlosPose re-calls todev with cfg.DEVICE).
    fp_mod = importlib.import_module("models.feature_propagation")
    if not getattr(fp_mod.LCT, "_cpu_patched", False):
        orig_todev = fp_mod.LCT.todev

        def todev_cpu(self, dev, dnum):
            return orig_todev(self, "cpu", dnum)

        fp_mod.LCT.todev = todev_cpu
        fp_mod.LCT._cpu_patched = True
    return importlib.import_module("models.NlosPose")


def _ref_cfg(size: int):
    """Minimal cfg exposing exactly the fields `NlosPose.__init__` reads
    (`/root/reference/models/NlosPose.py:17-47`), at the test scale."""
    from yacs.config import CfgNode  # the stub dict-node installed above

    cfg = CfgNode()
    cfg["MODEL"] = CfgNode()
    m = cfg["MODEL"]
    m["TIME_SIZE"] = size
    m["IMAGE_SIZE"] = [size, size]
    m["BASEDIM"] = 1
    m["IN_CHANNELS"] = 1
    m["WALL_SIZE"] = 2.0
    m["BIN_LEN"] = 0.01 * (512 // size)  # Config.tiny scaling
    m["DNUM"] = 1
    m["NUM_JOINTS"] = 24
    m["PRETRAIN_AUTOENCODER"] = False
    m["BACKBONE"] = "posenet3d_50"
    cfg["DEVICE"] = "cpu"
    return cfg


def _full_forward_parity(size: int):
    """One measurement through the COMPOSED reference forward
    (`models/NlosPose.py:49-59`: FE → LCT → normalize → UNet → posenet)
    vs hiddenpose_tpu with converted weights — the stage-composition link
    the per-module tests cannot cover."""
    import torch

    nlospose_mod = _import_reference_nlospose()
    tm = _randomize(nlospose_mod.NlosPose(_ref_cfg(size)), seed=6)
    meas = (
        np.random.RandomState(7).rand(1, 1, size, size, size).astype(np.float32)
    )
    with torch.no_grad():
        want_hm, want_refine = tm(torch.from_numpy(meas))
    want_hm, want_refine = want_hm.numpy(), want_refine.numpy()

    tree = convert_state_dict(
        {k: v.numpy() for k, v in tm.state_dict().items()}
    )

    from hiddenpose_tpu.config import Config
    from hiddenpose_tpu.models.nlospose import build_nlospose
    from hiddenpose_tpu.ops.softargmax import softmax_integral

    cfg = Config().tiny(size)
    model, lct = build_nlospose(cfg.model)
    got_hm, got_refine = model.apply(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]},
        jnp.asarray(meas), lct, False,
    )
    got_hm, got_refine = np.asarray(got_hm), np.asarray(got_refine)

    assert got_hm.shape == want_hm.shape
    assert got_refine.shape == want_refine.shape
    # What the losses/eval consume: soft-argmax joints (utils/criterion.py:129)
    # must agree to well under a heatmap voxel.
    j_got = np.asarray(softmax_integral(jnp.asarray(got_hm), 24)).reshape(-1, 3)
    j_want = np.asarray(
        softmax_integral(jnp.asarray(want_hm), 24)
    ).reshape(-1, 3)
    errs = {
        "hm_max_rel": float(
            np.abs(got_hm - want_hm).max() / np.abs(want_hm).max()
        ),
        "refine_max_rel": float(
            np.abs(got_refine - want_refine).max() / np.abs(want_refine).max()
        ),
        "joints_max_abs_vox": float(np.abs(j_got - j_want).max()),
    }
    # Heatmap logits: compositions of f32 FFT physics + BN-eval convs; the
    # per-module tolerances (2e-3 posenet) compound through five stages.
    assert errs["hm_max_rel"] < 5e-3, errs
    assert errs["refine_max_rel"] < 5e-3, errs
    assert errs["joints_max_abs_vox"] < 0.05, errs
    return errs


def test_full_forward_parity_t32():
    _full_forward_parity(32)


@pytest.mark.slow
def test_full_forward_parity():
    """VERDICT r3 #2: composed-forward parity at t=h=w=64."""
    _full_forward_parity(64)
