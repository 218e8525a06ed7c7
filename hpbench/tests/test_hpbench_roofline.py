"""The roofline arithmetic against the bound column of PERF.md's kernel
table (one t128 serving forward or train step at batch 2, the bf16
rows), and the union of device intervals."""

import json
from pathlib import Path

import pytest

from hpbench import roofline

CFG = json.loads((Path(__file__).resolve().parents[1] / "configs"
                  / "nlospose-t128.json").read_text())
M, A = CFG["model"], CFG["architecture"]


def ms(calls):
    return sum(roofline.bound_s(f, p, b) for f, p, b in calls) * 1e3


def test_k1_bf16_bound_of_a_forward():
    # all 24 stencil convs of a forward in K1-bf16's form (bf16 volumes,
    # f32 weights, bias and sums)
    calls = []
    for cin, cout, e, res, _, _ in roofline.k1_rows(M, A):
        flop, nbytes = roofline.k1_call(cin, cout, e, res, True, 2, 2, 2)
        calls.append((flop, "f32", nbytes))
    assert len(calls) == 24
    assert ms(calls) == pytest.approx(0.399, abs=5e-4)


@pytest.mark.parametrize("wrapper,want", [
    ("stem_conv_raw_bf16", 0.186), ("maxpool3d_k3s2p1_bf16", 0.180),
    ("conv3_mxu_bf16", 0.674)])
def test_serving_kernel_bounds(wrapper, want):
    calls = [c[1:] for c in roofline.serve_calls(M, A, 2) if c[0] == wrapper]
    assert ms(calls) == pytest.approx(want, abs=5e-4)


def test_k4_dx_bf16_bound_of_a_step():
    calls = [c[1:] for c in roofline.train_calls(M, A, 2)
             if c[0] == "conv3_mxu_dx_bf16"]
    assert len(calls) == 11
    assert ms(calls) == pytest.approx(0.674, abs=5e-4)


def test_launches_per_unit():
    serve, _ = roofline.per_unit(roofline.serve_calls(M, A, 8))
    assert serve == {"conv3_planes": 1, "conv3_planes_bf16": 23,
                     "stem_conv_raw_bf16": 1, "maxpool3d_k3s2p1_bf16": 1,
                     "conv3_mxu_bf16": 11}
    train, _ = roofline.per_unit(roofline.train_calls(M, A, 2))
    assert train == {"conv3_planes": 48, "conv3_planes_wgrad": 24,
                     "conv3_planes_adjoint": 22, "max_pool2_bwd": 4,
                     "maxpool3d_k3s2p1": 1, "maxpool3d_k3s2p1_vjp": 1,
                     "conv3_mxu_dx_bf16": 11}


@pytest.mark.parametrize("stage_remat,remat_stem", [
    (False, False), (True, True), (False, True)])
def test_train_launches_follow_the_remat_flags(stage_remat, remat_stem):
    # a recompute launches K1 (stage_remat) or K3 (posenet_remat_stem)
    # again; posenet_remat recomputes the library's conv2 forward at
    # 'default', which launches no kernel of the program
    m = dict(M, stage_remat=stage_remat, posenet_remat_stem=remat_stem,
             posenet_remat=True)
    train, _ = roofline.per_unit(roofline.train_calls(m, A, 2))
    assert train["conv3_planes"] == 24 * (1 + stage_remat)
    assert train["maxpool3d_k3s2p1"] == 1 + remat_stem
    assert train["conv3_mxu_dx_bf16"] == 11


def test_busy_seconds_is_the_union():
    assert roofline.busy_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert roofline.busy_seconds([]) == 0


def test_kernel_name():
    assert roofline.kernel_name(
        "void conv3p_tile_kernel<4, 8>(Args)") == "conv3p_tile_kernel"
    assert roofline.kernel_name("prep_bf16_kernel(unsigned short const*)") \
        == "prep_bf16_kernel"
