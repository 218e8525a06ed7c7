"""The plain reference against the program, on the CPU at a small size,
on the same seeded weights and captures; and the inputs against the
program's own synthetic data."""

import numpy as np
import pytest
import torch

from hpbench import inputs, program
from hpbench.generators import serving
from hpbench.reference import lct as ref_lct
from hpbench.reference import model as ref
from hpbench.reference import train as ref_train


def pair(cfg, seed=5):
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose

    w = inputs.peaked_weights(serving.template(cfg), seed, "cpu")
    pm, plct = build_nlospose(program.port_config(cfg).model, device="cpu")
    pm.load_state_dict(w)
    rm = ref.NlosPose(cfg)
    rm.load_state_dict(w)
    return pm, plct, rm, ref_lct.LCT(cfg["model"], "cpu"), w


@pytest.mark.parametrize("name", ["nlospose-t128", "nlospose2d-t128"])
def test_eval_forward_matches_the_program(config, name):
    cfg = config(name, 16)
    pm, plct, rm, rlct, _ = pair(cfg)
    x = inputs.captures([1, 2], cfg["model"], "cpu")
    with torch.no_grad():
        ha, ra = pm.eval()(x, plct)
        hb, rb = ref.forward(rm, x, rlct)
    assert (ra - rb).abs().max() <= 1e-5 * rb.abs().max()
    assert (ha - hb).abs().max() <= 1e-5 * hb.abs().max()


def test_first_train_step_matches_the_program(config):
    # at 32^3 (at 16^3 layer4's BatchNorm sees 2 values a channel and the
    # step is chaotic); the program at 'highest', full f32 like the
    # reference
    cfg = config("nlospose-t128", 32)
    cfg["train"]["matmul_precision"] = "highest"
    pm, plct, rm, rlct, w = pair(cfg)
    batch = inputs.batch([11, 12], cfg["model"], "cpu")
    _, lct, state, step = program.train_step(cfg, w, "cpu")
    got = float(step(state, batch, lct)["loss"])
    losses, *_ = ref_train.train_steps(rm, rlct, [batch],
                                         cfg["train"]["lr"])
    assert got == pytest.approx(losses[0], rel=1e-5)


def test_lct_constants_match_the_numpy_golden_reference():
    from hiddenpose_tpu_torch.ops.lct_reference import lct_numpy

    rng = np.random.RandomState(0)
    meas = rng.rand(16, 16, 16).astype(np.float32)
    model = {"time_size": 16, "image_size": [16, 16], "bin_len": 0.32,
             "wall_size": 2.0, "mode": "lct", "material": "diffuse"}
    got = ref_lct.LCT(model, "cpu")(torch.from_numpy(meas)[None])[0]
    want = lct_numpy(meas, 0.32)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_render_matches_the_programs_synthetic_sample():
    from hiddenpose_tpu_torch.data.synthetic import make_sample

    want = make_sample(7, 32, 32, 32, 16, 0.16)
    got = inputs.render(inputs.scatterers(inputs.pose(7)), 32, 32, 0.16,
                        "cpu")
    np.testing.assert_allclose(got.numpy(), want["meas"][0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(inputs.heatmap_joints(inputs.pose(7), 16),
                               want["joints"], rtol=1e-6)


def test_inputs_are_the_same_for_the_same_seed():
    a = inputs.captures(inputs.sub_seeds(2 ** 31 + 5, 2), {
        "time_size": 16, "image_size": [16, 16], "bin_len": 0.32,
        "wall_size": 2.0}, "cpu")
    b = inputs.captures(inputs.sub_seeds(2 ** 31 + 5, 2), {
        "time_size": 16, "image_size": [16, 16], "bin_len": 0.32,
        "wall_size": 2.0}, "cpu")
    assert torch.equal(a, b)
