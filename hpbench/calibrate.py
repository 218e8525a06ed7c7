"""Readings that set the limits of a cell's correctness checks: the
program's numbers over many seeds, and the control's and the faults' over
a few, in one process.  The benchmark's own runs never run this.

    python3 -m hpbench.calibrate --workload <cell> --seeds 1,2,3 \
        [--seconds 3] [--control | --fault half_batch]

Without ``--control`` or ``--fault``: one run of the cell a seed (a short
window, then the cell's own check).  With ``--fault <kind>``
(``faults.py``: ``unchanged`` or ``half_batch`` for a train cell,
``altered`` for a serving cell): the same run with that fault planted in
the program.  With ``--control``: the plain reference put in the
program's place, its products rounded to the precision below the
configuration's (bfloat16 serving: float8 e4m3; the float32 step at
TF32: bfloat16), held by the same numbers against the float32 reference.
Every reading is judged against the cell's own limits, as a benchmark
run is: one JSON line a reading, with ``correct`` and each compared number
beside its limit under ``checks``, and under ``numbers`` every number the
check reads (a train cell's gradient and change directions too).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from hpbench import faults, harness, inputs  # noqa: E402
from hpbench.generators import serving, train_steps  # noqa: E402

CONTROL = {"serve": "float8", "train": "bfloat16"}
SERVE_NUMBERS = ["joint_err_median_per_sd", "joint_err_median_voxels"]
TRAIN_NUMBERS = [f"loss_rel_step{i}" for i in (1, 2, 3)] + [
    "voxel_loss_rel_step1", "refine_gap_worst_sample", "bn_stats_gap_worst",
    "bn_stats_gap_median"] + [
    f"{w}_{k}_gap_{s}" for w in ("grad", "change")
    for k, s in (("norm", "worst"), ("norm", "median"), ("dir", "median"))]


def serve_control(run) -> dict:
    n = int(run.traffic["pool"])
    wseed, _, *cseeds = inputs.sub_seeds(run.seed, 2 + n)
    run.weights = inputs.peaked_weights(serving.template(run.config), wseed,
                                        run.device)
    run.pool_seeds = cseeds
    want, sd = serving.reference_joints(run)
    got, _ = serving.reference_joints(run, CONTROL["serve"])
    return {"joint_err_median_per_sd": serving.joint_gap(
        enumerate(got), want, sd),
            "joint_err_median_voxels": serving.joint_gap(enumerate(got),
                                                         want)}


def train_control(run) -> dict:
    cfg = run.config
    bsz = int(cfg["train"]["batch_size"])
    n = int(run.traffic["batches"])
    wseed, *bseeds = inputs.sub_seeds(run.seed, 1 + n * bsz)
    run.weights = inputs.peaked_weights(serving.template(cfg), wseed,
                                        run.device)
    run.batch_seeds = [bseeds[i * bsz:(i + 1) * bsz] for i in range(n)]
    (run.losses, run.voxel_losses, first, run.stats, change,
     run.refine) = train_steps.reference_steps(run, CONTROL["train"])
    run.grad_norms = {k: float(g.norm()) for k, g in first.items()}
    run.change_norms = {k: float(c.norm()) for k, c in change.items()}
    run.grads, run.changes = first, change
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return train_steps.gaps(run, *train_steps.reference_steps(run))


def reading(cell, seed: int, seconds: float, control: bool, fault,
            kind: str, device: str = "cuda") -> dict:
    """One reading of ``cell`` on ``seed``, judged against the cell's
    limits."""
    limits = cell.config["limits"][kind]
    if control:
        run = harness.Run(cell, seed, device, False)
        nums = train_control(run) if kind == "train" else serve_control(run)
        checks = [(k, nums[k], lim) for k, lim in limits.items()]
        return {"reading": f"control {CONTROL[kind]}",
                "correct": harness.judge(checks), "numbers": nums,
                "checks": {k: {"value": v, "limit": lim}
                           for k, v, lim in checks}}
    every = dict.fromkeys(TRAIN_NUMBERS if kind == "train"
                          else SERVE_NUMBERS, float("inf"))
    config = dict(cell.config, limits={kind: dict(every, **limits)})
    keep, train_steps.KEEP_TENSORS = train_steps.KEEP_TENSORS, True
    try:
        with faults.planted(fault) if fault else contextlib.nullcontext():
            line = harness.run_cell(cell, seed, seconds, False, device,
                                    time.perf_counter(), config=config)
    finally:
        train_steps.KEEP_TENSORS = keep
    return {"reading": fault or "program", "correct": line["correct"],
            "numbers": {k: v["value"] for k, v in line["checks"].items()},
            "checks": {k: line["checks"][k] for k in limits},
            "metrics": {k: v["value"] for k, v in line["metrics"].items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None,
                   choices=faults.TRAIN + faults.SERVE)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.resolve(args.workload)
    kind = "train" if cell.traffic["generator"] == "train_steps" else "serve"
    if args.fault and args.fault not in (faults.TRAIN if kind == "train"
                                         else faults.SERVE):
        p.error(f"a {kind} cell cannot have the fault {args.fault}")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = reading(cell, seed, args.seconds, args.control, args.fault,
                      kind)
        print(json.dumps(dict({"workload": args.workload, "seed": seed},
                              **out, seconds=time.perf_counter() - t0)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
