"""K6 (the weight gradient of the UNet's 3^3 conv, ``conv3_planes_wgrad``)
on the CPU against the JAX package's Pallas wgrad in interpret mode, as
the JAX package's own tests call it: the plain version the CPU wrapper
runs sums in another order, so it is held within 1e-5 of the output's
max.  The other train kernels are ``test_torch_train_kernels.py``'s.

The Pallas side runs in a process of its own (``torch_pallas_wgrad.py``),
on the same inputs: in a pytest worker that had run other JAX tests
before (``tests/test_conv3p.py`` and ``tests/test_conv3d_fast.py`` in one
process reproduce it), JAX's read of these programs from its persistent
compilation cache ended in a segmentation fault, and pytest-xdist under
``--dist loadfile`` then ran nothing more until the time limit.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hiddenpose_tpu_torch.ops import kernels as K
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

TESTS = Path(__file__).resolve().parent
PALLAS_CASES = [  # (cin, cout, d, h, w): H % 8 == 0, W <= 128
    (1, 1, 4, 8, 16), (1, 4, 4, 8, 16), (4, 4, 4, 8, 16), (4, 8, 2, 8, 8),
    (8, 4, 2, 8, 8),
]
PAD_MODES = ["zero", "edge"]


def _np(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _inputs(cin, cout, d, h, w):
    rng = np.random.RandomState(cin * 10 + cout + 1)
    return _np(rng, 2, cin, d, h, w), _np(rng, 2, cout, d, h, w)


@pytest.fixture(scope="module")
def pallas_wgrad(tmp_path_factory):
    """(dk, db) of every case and pad mode from the Pallas wgrad."""
    tmp = tmp_path_factory.mktemp("pallas_wgrad")
    cases = {}
    for i, case in enumerate(PALLAS_CASES):
        cases[f"x{i}"], cases[f"dz{i}"] = _inputs(*case)
    np.savez(tmp / "in.npz", pad_modes=np.array(PAD_MODES), **cases)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(TESTS.parent)] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    r = subprocess.run([sys.executable, str(TESTS / "torch_pallas_wgrad.py"),
                        str(tmp / "in.npz"), str(tmp / "out.npz")],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = np.load(tmp / "out.npz")
    return {(case, pad): (out[f"dk{i}_{pad}"], out[f"db{i}_{pad}"])
            for i, case in enumerate(PALLAS_CASES) for pad in PAD_MODES}


@pytest.mark.parametrize("pad_mode", PAD_MODES)
@pytest.mark.parametrize("cin,cout,d,h,w", PALLAS_CASES)
def test_wgrad_ref_matches_pallas(pallas_wgrad, cin, cout, d, h, w,
                                  pad_mode):
    if cin * cout > 32:
        pytest.skip("the Pallas wgrad takes cin * cout <= 32")
    x, dz = _inputs(cin, cout, d, h, w)
    dk_w, db_w = pallas_wgrad[((cin, cout, d, h, w), pad_mode)]
    dk, db = K.conv3_planes_wgrad(torch.from_numpy(x), torch.from_numpy(dz),
                                  pad_mode=pad_mode)
    for got, want in ((dk, dk_w), (db, db_w)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
