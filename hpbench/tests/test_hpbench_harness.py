"""The harness on the CPU: every cell resolves by name, BENCHMARK.json keeps
to its contract, a run without a card fails, a run's last line has the
contract's keys and loads no JAX, and the check comes out false when the
timed path is broken underneath (an answer altered; a train step that
leaves its state unchanged or drops half its batch) or when the plain
reference in a lower precision takes the program's place.  The runs here
are at a small size (``conftest.small``); runs on the card are marked
``cuda``."""

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from hpbench import faults, harness
from hpbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def line_of(stdout: str):
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    return json.loads(lines[-1]) if lines else None


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_by_name(cell):
    c = harness.resolve(cell)
    for fn in ("setup", "window", "release", "check"):
        assert callable(getattr(c.generator, fn))
    assert c.per_layer and any(m["name"] != "setup_s" for m in c.end_to_end)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    for m in c.per_layer:
        assert callable(c.readers[m["name"]].read)
    assert set(c.config["limits"]) and c.config["model"]["backbone"]


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["hpbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("hpbench/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] \
            == c["reduced"]
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (ROOT / "hpbench" / "traffic" / f"{w['traffic']}.json").exists()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "hpbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not any(ln.startswith("{") for ln in p.stdout.splitlines())


def run(config, cell, trace=False, seconds=1.0, seed=2 ** 31 + 7, size=16):
    c = harness.resolve(cell)
    return harness.run_cell(c, seed, seconds, trace, "cpu",
                            time.perf_counter(), config=config(
                                c.config_name, size))


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_has_the_contract_keys(config, trace):
    cell = "serve-sat-nlospose-t128"
    line = run(config, cell, trace)
    want = LINE_KEYS | ({"breakdown"} if trace else set())
    assert set(line) == want and list(line)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    c = harness.resolve(cell)
    declared = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(line["metrics"]) <= declared
    if not trace:
        assert set(line["metrics"]) == declared
    assert line["correct"] is True and line["failed"] == 0
    json.dumps(line)


def test_a_run_loads_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, '.');"
        "from hpbench import harness;"
        "from hpbench.tests.conftest import small;"
        "c = harness.resolve('serve-sat-nlospose-t128');"
        "harness.run_cell(c, 3, 0.5, False, 'cpu', time.perf_counter(),"
        " config=small(c.config, 16));"
        "print(harness.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "hiddenpose_tpu_torch_x", sys)
    assert "hiddenpose_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hiddenpose_tpu.config", sys)
    assert "hiddenpose_tpu.config" in harness.forbidden_modules()


def test_an_altered_answer_is_not_correct(config):
    with faults.planted("altered"):
        line = run(config, "serve-sat-nlospose-t128")
    assert line["correct"] is False
    got = line["checks"]["joint_err_median_per_sd"]
    assert got["value"] > got["limit"]


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(config, fault):
    # at 32^3: at 16^3 layer4's BatchNorm sees 2 values a channel
    with faults.planted(fault) if fault else contextlib.nullcontext():
        line = run(config, "train-nlospose-t128", seconds=0.5, size=32)
    assert line["correct"] is (fault is None), line["checks"]
    if fault == "half_batch":       # the sample left out reads 1
        assert line["checks"]["refine_gap_worst_sample"]["value"] == 1.0


def small_cell(config, cell, size):
    c = harness.resolve(cell)
    return dataclasses.replace(c, config=config(c.config_name, size))


@pytest.mark.parametrize("cell,size,fault", [
    ("serve-sat-nlospose-t128", 16, "altered"),
    ("train-nlospose-t128", 32, "half_batch")])
def test_calibrate_judges_a_fault_by_the_cells_limits(config, cell, size,
                                                      fault):
    from hpbench import calibrate

    c = small_cell(config, cell, size)
    kind = "train" if "train" in cell else "serve"
    got = calibrate.reading(c, 7, 0.5, False, fault, kind, device="cpu")
    assert got["correct"] is False
    assert set(got["checks"]) == set(c.config["limits"][kind])
    assert set(got["numbers"]) >= set(got["checks"])
    if kind == "train":     # calibrate reads the directions as well
        assert {"grad_dir_gap_median", "change_dir_gap_median"} <= set(
            got["numbers"])
    assert not harness.judge([(k, v["value"], v["limit"])
                              for k, v in got["checks"].items()])


def test_the_serving_control_reads_far_from_the_program(config):
    # the float8 reference in the program's place against the bf16
    # program, at a small size
    from hpbench import calibrate

    c = harness.resolve("serve-sat-nlospose-t128")
    r = harness.Run(c, 11, "cpu", False, config(c.config_name, 16))
    control = calibrate.serve_control(r)["joint_err_median_per_sd"]
    program = run(config, "serve-sat-nlospose-t128", seed=11)[
        "checks"]["joint_err_median_per_sd"]["value"]
    assert control > 3 * program


def test_the_train_control_reads_far_from_the_program(config):
    from hpbench import calibrate

    c = harness.resolve("train-nlospose-t128")
    r = harness.Run(c, 11, "cpu", False, config(c.config_name, 32))
    control = calibrate.train_control(r)["bn_stats_gap_median"]
    program = run(config, "train-nlospose-t128", seconds=0.5, seed=11,
                  size=32)["checks"]["bn_stats_gap_median"]["value"]
    assert control > 3 * program


def test_the_open_loop_schedule_is_the_same_for_every_seed():
    from hpbench.generators import serve_open

    a = serve_open.schedule(43.0, 20.0, 20)
    assert np.array_equal(a, serve_open.schedule(43.0, 20.0, 20))
    assert abs(len(a[a < 20.0]) / 20.0 - 43.0) < 5.0


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(
        [sys.executable, "-m", "hpbench.run", "--workload", CELLS[0],
         "--seed", "5", "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    assert line_of(p.stdout)["correct"] is True


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_the_cells_limits(cell):
    # the plain reference one precision lower, at the cell's own size
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(
        [sys.executable, "-m", "hpbench.calibrate", "--workload", cell,
         "--seeds", "2147483721", "--control"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    assert line_of(p.stdout)["correct"] is False
