"""The port's entry points default to the GPU: without one and without an
explicit ``device="cpu"`` they raise a clear error and never carry on on
the CPU; with ``device="cpu"`` they work."""

import pytest
import torch

from hiddenpose_tpu_torch import resolve_device
from hiddenpose_tpu_torch.config import Config
from hiddenpose_tpu_torch.models.nlospose import build_nlospose
from hiddenpose_tpu_torch.models.sformer import build_sformer
from hiddenpose_tpu_torch.models.timesformer import build_timesformer
from hiddenpose_tpu_torch.ops.lct import make_lct_params
from hiddenpose_tpu_torch.serve import InferenceServer

CFG = Config().tiny(16)
TS_KW = dict(dim=16, num_frames=2, image_size=8, patch_size=4, channels=1,
             depth=1, heads=2, dim_head=8)


def _server(**kw):
    srv = InferenceServer(CFG, batch_size=1, **kw)
    srv.close()
    return srv.device


ENTRY_POINTS = {
    "build_nlospose": lambda **kw: next(
        build_nlospose(CFG.model, **kw)[0].parameters()).device,
    "InferenceServer": _server,
    "make_lct_params": lambda **kw: make_lct_params(16, 16, 0.04,
                                                    **kw).mtx.device,
    "build_sformer": lambda **kw: next(
        build_sformer(CFG.model, **kw).parameters()).device,
    "build_timesformer": lambda **kw: next(
        build_timesformer(**TS_KW, **kw).parameters()).device,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_gpu(name):
    build = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert build().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()
    assert build(device="cpu").type == "cpu"


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_device("cuda:0")
