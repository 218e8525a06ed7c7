"""Train steps back to back: the program's train step on a pool of
batches made from the seed, its losses read on the host every
``read_every`` steps.

Set-up builds one train state and drives it through its first three
steps, on three different batches, through the same step function that
the window calls; those steps are the warm-up and what the check holds
against the reference.  The window then runs steps on the pool in turn
until ``seconds`` have passed, and ``train_samples_per_s`` is the samples
of every step it launched over the time to the closing synchronise.
Traffic file: ``{"generator": "train_steps", "batches": n, "read_every":
n}``; the batch size is the configuration's.

The check: the reference (``reference/train.py``, float32, TF32 off)
takes the same three steps from the same weights and batches.  Read:
each step's loss (relative); the first step's refined volume (the
model's second output, made before any BatchNorm), each sample's relative
L2 gap, a sample the program did not make reading 1; the first step's
BatchNorm batch statistics, each layer's relative gap; the first
gradient, as the program's Adam holds it after one step (first moment /
(1 - b1)), and each parameter's change over the three steps, both by
norm: the gap between the program's norm and the reference's over the
reference's norm of that parameter or of the median parameter,
whichever is larger.  Parameters whose reference gradient is under a
thousandth of the median's (a conv's bias before a norm: its gradient is
round-off) are left out of both.  The configuration's limits name the
numbers compared.  With ``KEEP_TENSORS`` (``calibrate``) the gradient's
and the change's directions are read too: each parameter's relative L2
gap.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hpbench import inputs, program, roofline
from hpbench.generators import serving
from hpbench.reference import lct as ref_lct
from hpbench.reference import model as ref
from hpbench.reference import train as ref_train

CHECKED_STEPS = 3
B1 = 0.9
# parameters whose reference gradient norm is under this share of the
# median parameter's are left out of the comparison
ROUNDOFF = 1e-3
# keep the program's first gradients and changes whole, to read their
# directions (calibrate sets it; a benchmark run keeps norms only)
KEEP_TENSORS = False


def setup(run) -> None:
    cfg = run.config
    bsz = int(cfg["train"]["batch_size"])
    n = int(run.traffic["batches"])
    wseed, *bseeds = inputs.sub_seeds(run.seed, 1 + n * bsz)
    run.weights = inputs.peaked_weights(serving.template(cfg), wseed,
                                        run.device)
    run.batch_seeds = [bseeds[i * bsz:(i + 1) * bsz] for i in range(n)]
    run.batches = [inputs.batch(s, cfg["model"], run.device)
                   for s in run.batch_seeds]
    model, lct, state, step = program.train_step(cfg, run.weights,
                                                 run.device)
    run.model, run.program = model, (state, step, lct)
    run.batch_size = bsz
    run.calls_per_unit = roofline.train_calls(cfg["model"],
                                              cfg["architecture"], bsz)
    run.peak = "tf32"
    names = {p: k for k, p in model.named_parameters()}
    losses, voxels = [], []

    def keep_refine(mod, args, out):
        run.refine = out[1].detach().clone()

    # the whole model's forward runs once a step (a recompute calls parts)
    hook = model.register_forward_hook(keep_refine)
    for i in range(CHECKED_STEPS):
        m = step(state, run.batches[i], lct)
        losses.append(float(m["loss"]))
        voxels.append(float(m["voxel_loss"]))
        if i == 0:
            hook.remove()
            run.stats = ref_train.running_stats(model)
            # a parameter the optimizer holds no moment of reads 0
            first = program.optimizer_first_moments(state)
            norms = torch.stack([first[p].norm() if p in first else
                                 torch.zeros((), device=run.device)
                                 for p in names]).tolist()
            run.grad_norms = {names[p]: v / (1 - B1)
                              for p, v in zip(names, norms)}
            if KEEP_TENSORS:
                run.grads = {names[p]: (first[p] / (1 - B1)).cpu()
                             if p in first else torch.zeros(p.shape)
                             for p in names}
    changes = torch.stack([(p.detach() - run.weights[k]).norm()
                           for k, p in model.named_parameters()]).tolist()
    run.change_norms = dict(zip((k for k, _ in model.named_parameters()),
                                changes))
    if KEEP_TENSORS:
        run.changes = {k: (p.detach() - run.weights[k]).cpu()
                       for k, p in model.named_parameters()}
    run.losses, run.voxel_losses = losses, voxels
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        run.setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()


def window(run, seconds: float) -> None:
    state, step, lct = run.program
    every = int(run.traffic["read_every"])
    bad, n = 0, 0
    run.open_window()
    run.window["open"] = dict(launches=program.launch_counts())
    t0 = time.perf_counter()
    while True:
        m = step(state, run.batches[(CHECKED_STEPS + n) % len(run.batches)],
                 lct)
        n += 1
        if n % every == 0 and not np.isfinite(float(m["loss"])):
            bad += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    run.window["end"] = dict(launches=program.launch_counts())
    run.close_window()
    if run.device.type == "cuda":
        run.window["peak_bytes"] = torch.cuda.max_memory_allocated()
    run.window.update(
        values={"train_samples_per_s": n * run.batch_size / (t1 - t0)},
        seconds=t1 - t0, units=n, attempted=n, failed=bad)


def release(run) -> None:
    run.program = run.model = None


def stats_gaps(run, stats) -> list:
    """For each BatchNorm of the first step, the larger of the relative
    L2 gaps of its batch mean and batch variance (worked out from the
    running statistics before and after the step) from the reference's."""
    out = []
    for k in stats:
        if not k.endswith("running_mean"):
            continue
        worst = 0.0
        for part in (k, k[:-len("mean")] + "var"):
            before = run.weights[part]
            want = stats[part] - 0.9 * before
            got = run.stats[part] - 0.9 * before
            worst = max(worst, float((got - want).norm() / want.norm()))
        out.append(worst)
    return out


def sample_gaps(mine, want) -> list:
    """Each sample's relative L2 gap of ``mine`` from ``want`` (batch
    first); a sample ``mine`` lacks reads 1, a shape that differs
    otherwise inf."""
    if mine is None or tuple(mine.shape[1:]) != tuple(want.shape[1:]):
        return [float("inf")] * want.shape[0]
    return [float((mine[i] - want[i]).norm() / want[i].norm())
            if i < mine.shape[0] else 1.0 for i in range(want.shape[0])]


def direction_gaps(run, mine, want, kept) -> dict:
    """Each kept parameter's relative L2 gap of ``mine`` (on the host)
    from ``want``: the median, and the median of each top-level module."""
    gap = {k: float((mine[k].to(want[k].device) - want[k]).norm()
                    / want[k].norm()) for k in kept}
    out = {"median": float(np.median(list(gap.values())))}
    for top in sorted({k.split(".")[0] for k in kept}):
        out[top] = float(np.median([v for k, v in gap.items()
                                    if k.split(".")[0] == top]))
    return out


def gaps(run, losses, voxels, first, stats, change, refine) -> dict:
    """The program's readings against the reference's ``losses``, voxel
    losses ``voxels``, first gradients ``first``, BatchNorm statistics
    ``stats``, ``change``s and first refined volume ``refine``: each
    step's loss gap and the first step's voxel loss gap (relative); the
    refined volume's worst sample; of the gradient norms and the change
    norms the gap of the worst parameter and of the median one (each over
    the larger of the reference's norm of that parameter and of the
    median parameter); of the first step's BatchNorm statistics the gap
    of the worst layer and of the median one; and, where the run kept
    them, the median parameter's direction gaps."""
    g_ref = {k: float(g.norm()) for k, g in first.items()}
    med = float(np.median(list(g_ref.values())))
    kept = [k for k, v in g_ref.items() if v >= ROUNDOFF * med]
    c_ref = {k: float(change[k].norm()) for k in kept}
    cmed = float(np.median(list(c_ref.values())))
    out = {f"loss_rel_step{i + 1}": abs(a - b) / abs(b)
           for i, (a, b) in enumerate(zip(run.losses, losses))}
    out["voxel_loss_rel_step1"] = (abs(run.voxel_losses[0] - voxels[0])
                                   / abs(voxels[0]))
    per_sample = sample_gaps(getattr(run, "refine", None), refine)
    out["refine_gap_worst_sample"] = max(per_sample)
    bn = stats_gaps(run, stats)
    out["bn_stats_gap_worst"] = max(bn)
    out["bn_stats_gap_median"] = float(np.median(bn))
    for what, mine, ref_, m in (("grad", run.grad_norms, g_ref, med),
                                ("change", run.change_norms, c_ref, cmed)):
        gap = {k: abs(mine[k] - ref_[k]) / max(ref_[k], m) for k in kept}
        out[f"{what}_norm_gap_worst"] = max(gap.values())
        out[f"{what}_norm_gap_median"] = float(np.median(list(gap.values())))
        worst = sorted(kept, key=lambda k: -gap[k])[:3]
        run.note(f"largest {what} norm gaps: " + ", ".join(
            f"{k} {mine[k]:.6g} against {ref_[k]:.6g}" for k in worst))
    for what, mine, want in (("grad", "grads", first),
                             ("change", "changes", change)):
        if hasattr(run, mine):
            d = direction_gaps(run, getattr(run, mine), want, kept)
            out[f"{what}_dir_gap_median"] = d.pop("median")
            run.note(f"{what} direction gaps, median by module: {d}")
    run.note(f"{len(kept)} of {len(g_ref)} parameters compared; losses "
             f"{run.losses} against {losses}; refine by sample "
             f"{per_sample}; " + ", ".join(
                 f"{k} {v:.6g}" for k, v in out.items()))
    return out


def reference_steps(run, precision: str = "float32"):
    """The reference's three steps from the run's weights on the run's
    first batches (made again from their seeds)."""
    cfg = run.config
    batches = [inputs.batch(s, cfg["model"], run.device)
               for s in run.batch_seeds[:CHECKED_STEPS]]
    with ref_lct.no_tf32():
        m = ref.NlosPose(cfg).to(run.device)
        m.load_state_dict(run.weights)
        lct = ref_lct.LCT(cfg["model"], run.device)
        out = ref_train.train_steps(m, lct, batches, float(cfg["train"]["lr"]),
                                    ref_train.rounded(precision))
        del m, lct
    return out


def check(run) -> list:
    """[(name, number, limit)] for each number the configuration limits."""
    run.batches = None
    got = gaps(run, *reference_steps(run))
    return [(k, got[k], lim)
            for k, lim in run.config["limits"]["train"].items()]


def flop_per_step(run) -> int:
    """FLOP of one train step's forward and backward at the configured
    batch, counted on the plain reference on the meta device."""
    cfg = run.config
    m = cfg["model"]
    b = int(cfg["train"]["batch_size"])
    with torch.device("meta"):
        net = ref.NlosPose(cfg)
        lct = ref_lct.LCT(m, "meta")
        x = torch.empty(b, m["in_channels"], m["time_size"], *m["image_size"])
        vol = torch.empty(b, 1, m["grid_dim"], m["grid_dim"], m["grid_dim"])
        j = torch.empty(b, 3 * m["num_joints"])

    def step():
        hm, refine = ref.forward(net, x, lct, training=True)
        loss = (ref_train.joint_loss(hm, j, torch.ones_like(j))
                + ref_train.voxel_loss(refine, vol))
        torch.autograd.grad(loss, list(net.parameters()))

    return roofline.count_flop(step)
