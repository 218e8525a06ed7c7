"""One data-parallel x tensor-parallel train step of NlosPose over several
GPUs, held against the same step on one GPU.

    python scripts/torch_dp_tp_step.py [--n 4] [--n-model 2] [--size 128]
    python scripts/torch_dp_tp_step.py --device cpu --size 16   # gloo

Starts ``--n`` ranks (one process a GPU, NCCL; or gloo processes on the
CPU with ``--device cpu``) as a ('data', 'model') mesh of
(n / n_model, n_model): each 'data' rank takes 2 samples of a seeded
global batch (``data/synthetic.py::make_batch``), every weight with at
least 256 output channels is stored as this rank's slice over 'model' with
its Adam moments (``parallel/sharding_rules.py::apply_tp``), and the step
is the port's data-parallel step (``train/step.py``) at 'highest', with
the peaked weights of ``chip_smoke.py``'s train phases.  Rank 0 then
gathers the new parameters, running statistics and first Adam moments
(0.1 x the gradients) whole, runs the same step on its own GPU without a
mesh on the whole batch, and holds the first against the second at
``chip_smoke.py``'s train-step limits (TRAIN_*: loss 1e-4 relative,
gradients 0.05 relative L2 a module, statistics 1e-3 of their max, new
parameters 1e-6 where the gradients agree, 99% of large gradient elements
of one sign), both under deterministic algorithms; the gradients' limit
is twice the one-GPU step's own largest distance from itself under a
1e-7 move of the measurement (three seeds) where that is larger (``MOVE``, ``SPREAD``: the 'data'
ranks sum the BatchNorm moments and gradients in another order).  It also times two more mesh steps and the one-GPU step at
one rank's batch and at the whole batch (CUDA events), and reads each
rank's peak memory.

Prints the readings as one JSON line (and writes them to ``--out``);
exits 1 when a limit is missed or a rank fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

RESULT = "dp_tp_step result: "
PER_RANK = 2  # samples a 'data' rank: the t128 train phases' batch
# the gradients' limit: TRAIN_GRAD_L2_TOL, or SPREAD x the one-GPU step's
# own distance from itself on a measurement moved by MOVE (relative), if
# that is larger (a reduction in another order moves a step as far)
MOVE = 1e-7
SPREAD = 2.0


def _config(size):
    from hiddenpose_tpu_torch.config import default_config, t128_config

    return t128_config() if size == 128 else default_config().tiny(size)


def _batch(m, n, dev):
    from hiddenpose_tpu_torch.data.synthetic import make_batch

    return {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        list(range(n)), m.time_size, m.image_size[0], m.grid_dim,
        m.heatmap_size[0], m.bin_len).items()}


def _ms(fn, dev):
    """(ms, fn()): CUDA events on the GPU, the host's clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, out
    return cs._event_ms(fn)


def _reference(cfg, weights, whole, dev):
    """The step without a mesh on the whole batch (its result as
    ``chip_smoke.py::_step_result`` reads it), and on the GPU its median ms at one rank's batch and at
    the whole batch."""
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose
    from hiddenpose_tpu_torch.train.step import make_train_step

    from hiddenpose_tpu_torch.config import TrainConfig
    from hiddenpose_tpu_torch.train.state import TrainState

    model, lct = build_nlospose(cfg.model, device=dev)
    step = make_train_step(model, "highest")

    def one(batch):
        model.load_state_dict(weights)
        state = TrainState.create(model, TrainConfig())
        with cs.deterministic(warn_only=True):
            met = step(state, batch, lct)
        return dict(
            loss={k: v.item() for k, v in met.items()},
            grads={n: p.grad.detach().clone()
                   for n, p in model.named_parameters()},
            params={n: p.detach().clone()
                    for n, p in model.named_parameters()},
            stats={n: b.clone() for n, b in model.named_buffers()
                   if n.endswith(("running_mean", "running_var"))})

    ref = one(whole)
    spread = []
    for seed in range(3):
        g = torch.Generator(device=dev).manual_seed(seed)
        moved = whole["meas"] * (1 + MOVE * torch.randn(
            whole["meas"].shape, generator=g, device=dev))
        spread.append(cs._train_readings(one(dict(whole, meas=moved)), ref))
    ms = {}
    if dev.type == "cuda":
        part = {k: v[:PER_RANK] for k, v in whole.items()}
        for name, b in (("rank_batch", part), ("whole_batch", whole)):
            ms[name], ms[name + "_peak_bytes"] = cs._median_step_ms(
                step, model, weights, b, lct)
    return ref, spread, ms


def rank_main(rank, world, port, n_model, size, device):
    import torch.distributed as dist

    from hiddenpose_tpu_torch.config import TrainConfig
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose
    from hiddenpose_tpu_torch.parallel import distributed
    from hiddenpose_tpu_torch.parallel.mesh import (
        make_mesh,
        replicate,
        shard_batch,
    )
    from hiddenpose_tpu_torch.parallel.sharding_rules import (
        _sharded,
        apply_tp,
        full_optimizer_state_dict,
        full_state_dict,
    )
    from hiddenpose_tpu_torch.train.state import TrainState
    from hiddenpose_tpu_torch.train.step import make_train_step

    # as chip_smoke.py::run: cuBLAS deterministic (a fixed workspace, set
    # before the first CUDA call), full f32 for the library convs
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = distributed.local_device(device)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, device=device)
    try:
        mesh = make_mesh(world // n_model, n_model)
        cfg = _config(size)
        weights = cs.t128_weights(cfg)
        whole = _batch(cfg.model, PER_RANK * mesh.n_data, dev)
        batch = shard_batch(mesh, whole)
        model, lct = build_nlospose(cfg.model, device=dev)
        model.load_state_dict(weights)
        state = TrainState.create(model, TrainConfig())
        replicate(mesh, state)
        apply_tp(model, mesh, state.optimizer)
        step = make_train_step(model, "highest", mesh=mesh)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        with cs.deterministic(warn_only=True):
            first_ms, met = _ms(lambda: step(state, batch, lct), dev)
        # collectives over 'model': every rank gathers
        sd = full_state_dict(model)
        opt = full_optimizer_state_dict(model, state.optimizer)
        names = model._tp_plain_names
        # copies: the timed steps below update the tensors in place
        got = dict(
            loss={k: float(v) for k, v in met.items()},
            grads={n: opt["state"][i]["exp_avg"] / 0.1  # Adam's b1 0.9
                   for i, n in enumerate(names)},
            params={n: sd[n].clone() for n in names},
            stats={n: b.clone() for n, b in sd.items()
                   if n.endswith(("running_mean", "running_var"))})
        step_ms = [_ms(lambda: step(state, batch, lct), dev)[0]
                   for _ in range(2)]
        out = {"rank": rank, "mesh": [mesh.n_data, mesh.n_model],
               "device": str(dev), "tp_sharded": len(list(_sharded(model))),
               "first_step_ms": first_ms, "step_ms": step_ms,
               "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None)}
        del model, state, opt
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if rank == 0:
            ref, spread, ms = _reference(cfg, weights, whole, dev)
            r = cs._train_readings(got, ref)
            grad_lim = max(cs.TRAIN_GRAD_L2_TOL, SPREAD * max(
                max(x["grad_rel_l2"].values()) for x in spread))
            limits = dict(loss=cs.TRAIN_LOSS_TOL, grads=cs.TRAIN_GRAD_L2_TOL,
                          stats=cs.TRAIN_STATS_TOL, params=cs.TRAIN_PARAM_TOL,
                          sign_agree=cs.TRAIN_SIGN_AGREE)
            ok = (max(r["loss_rel"].values()) <= limits["loss"]
                  and max(r["grad_rel_l2"].values()) <= grad_lim
                  and r["stats_max_rel"] <= limits["stats"]
                  and r["param_max_abs"] <= limits["params"]
                  and r["sign_agree"] >= limits["sign_agree"])
            stats_worst = sorted(
                ((float((got["stats"][n] - b).abs().max())
                  / max(float(b.abs().max()), 1e-30), n)
                 for n, b in ref["stats"].items()), reverse=True)[:3]
            limits["grads"] = grad_lim
            out.update(readings=r, stats_max_rel_worst=stats_worst,
                       one_gpu_vs_moved=spread, limits=limits, ok=ok,
                       one_gpu=ms)
        peaks = [None] * mesh.size
        dist.all_gather_object(peaks, out["peak_bytes"])
        out["peak_bytes"] = peaks
        return out
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=4)
    p.add_argument("--n-model", type=int, default=2)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                 "dp_tp_step.json"))
    p.add_argument("--timeout", type=float, default=900.0)
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--world", type=int, default=None)
    p.add_argument("--port", type=int, default=None)
    args = p.parse_args(argv)
    if args.rank is not None:
        out = rank_main(args.rank, args.world, args.port, args.n_model,
                        args.size, args.device)
        if args.rank == 0:
            print(RESULT + json.dumps(out, default=str), flush=True)
        return 0

    from hiddenpose_tpu_torch import resolve_device
    from hiddenpose_tpu_torch.parallel.distributed import free_port

    device = resolve_device(args.device)
    if args.n % args.n_model:
        raise SystemExit(f"--n {args.n} does not divide by --n-model "
                         f"{args.n_model}")
    if device.type == "cuda":
        if args.n > torch.cuda.device_count():
            raise SystemExit(f"{args.n} ranks need {args.n} GPUs, this host "
                             f"has {torch.cuda.device_count()}")
        from hiddenpose_tpu_torch.ops.kernels import _build

        _build.library()  # one build, which the ranks then load
        print(cs.smi_line(), flush=True)
    port = free_port()
    procs = []
    for rank in range(args.n):
        env = dict(os.environ, LOCAL_RANK=str(rank))
        if device.type == "cpu":
            env.setdefault("OMP_NUM_THREADS", "1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(rank),
             "--world", str(args.n), "--port", str(port), "--n-model",
             str(args.n_model), "--size", str(args.size), "--device",
             device.type], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=args.timeout)[0].decode(
                errors="replace"))
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
            proc.communicate()
        print(f"ranks still running after {args.timeout} s", flush=True)
        return 1
    if any(proc.returncode for proc in procs):
        for r, (proc, o) in enumerate(zip(procs, outs)):
            print(f"--- rank {r} (rc {proc.returncode}):\n{o[-6000:]}")
        return 1
    line = next(ln for ln in outs[0].splitlines() if ln.startswith(RESULT))
    result = json.loads(line[len(RESULT):])
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
