"""Graft entry points: a single-device forward and a multi-rank dry run.

The port's counterpart of the root ``__graft_entry__.py`` (which drives
the JAX package):

* :func:`entry` returns ``(fn, example_args)``: the NlosPose forward
  (measurement (B, 1, T, H, W) -> joints (B, 72) and heatmaps) at
  ``HP_ENTRY_SIZE`` (default 64) on the GPU, or on the CPU when asked;
* :func:`dryrun_multichip` starts ``n`` ranks and runs one full train
  step over their ('data', 'model') mesh at tiny(16): data x tensor
  parallel (``n_model = 2`` when ``n >= 4`` and even), then, with
  ``n_model > 1``, the same step with the LCT's FFT cube sharded over
  'model' (``ops/lct.py::lct_apply_sharded``).  The ranks are processes
  of their own: NCCL over the visible GPUs (one a rank, so ``n`` may not
  exceed them), or gloo on the CPU with ``device="cpu"``.  It keeps the
  JAX dry run's checks, a finite loss and the sharded-LCT step's loss
  within 0.1 x max(1, |loss|) of the other's, and raises when a rank
  fails; it never shrinks ``n``.

    python -m hiddenpose_tpu_torch.graft_entry [N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from hiddenpose_tpu_torch import resolve_device
from hiddenpose_tpu_torch.parallel.distributed import free_port

RESULT = "dryrun_multichip result: "
SIZE = 16  # the dry run's grid (tiny(16)), as the JAX one's


def entry(device="cuda"):
    """(fn, example_args): ``fn(model, meas, lct) -> (pred_joints (B, 72),
    heatmaps (B, 24, T/2, H/2, W/2))``, the serving forward of the
    flagship NlosPose at ``HP_ENTRY_SIZE`` (default 64; the architecture
    is the same at every size), with its seeded weights, a seeded
    measurement and the LCT constants on ``device`` (the GPU by default;
    raises without one unless ``device="cpu"``)."""
    from hiddenpose_tpu_torch.config import default_config
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose
    from hiddenpose_tpu_torch.train.step import make_forward

    device = resolve_device(device)
    size = int(os.environ.get("HP_ENTRY_SIZE", "64"))
    cfg = default_config().tiny(size)
    model, lct = build_nlospose(cfg.model, device=device, seed=410)
    meas = torch.from_numpy(np.random.RandomState(410).rand(
        1, 1, size, size, size).astype(np.float32)).to(device)

    def fn(model, meas, lct):
        return make_forward(model)(meas, lct)

    return fn, (model, meas, lct)


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 600.0) -> dict:
    """Run :func:`_rank` on ``n_devices`` ranks (see the module's
    docstring); returns rank 0's readings: the mesh, the step's loss and
    the sharded-LCT step's (NaN without 'model' ranks)."""
    device = resolve_device(device)
    if n_devices < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")
    if device.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip({n_devices}) needs {n_devices} "
                         f"GPUs, this host has {torch.cuda.device_count()}")
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = []
    for rank in range(n_devices):
        env_r = dict(env, LOCAL_RANK=str(rank))
        if device.type == "cpu":  # the ranks share the host's cores
            env_r.setdefault("OMP_NUM_THREADS", "1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "hiddenpose_tpu_torch.graft_entry",
             "--rank", str(rank), "--world", str(n_devices), "--port",
             str(port), "--device", device.type],
            env=env_r, cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode(
                errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise RuntimeError(f"dryrun_multichip({n_devices}) ranks still "
                           f"running after {timeout} s")
    if any(p.returncode for p in procs):
        raise RuntimeError(f"dryrun_multichip({n_devices}) failed:\n" +
                           "\n".join(f"--- rank {r} (rc {p.returncode}):\n"
                                     f"{o}" for r, (p, o) in
                                     enumerate(zip(procs, outs))))
    line = next(ln for ln in outs[0].splitlines() if ln.startswith(RESULT))
    return json.loads(line[len(RESULT):])


def _rank(rank: int, world: int, port: int, device: str) -> dict:
    """One rank of :func:`dryrun_multichip`."""
    import torch.distributed as dist

    from hiddenpose_tpu_torch.config import default_config
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose
    from hiddenpose_tpu_torch.parallel import distributed
    from hiddenpose_tpu_torch.parallel.mesh import (
        make_mesh,
        replicate,
        shard_batch,
    )
    from hiddenpose_tpu_torch.parallel.sharding_rules import apply_tp
    from hiddenpose_tpu_torch.train.state import TrainState
    from hiddenpose_tpu_torch.train.step import make_train_step

    dev = distributed.local_device(device)
    if world > 1:
        distributed.initialize(f"127.0.0.1:{port}", world, rank,
                               device=device)
    else:  # initialize() leaves one process alone; the mesh needs a group
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        cfg = default_config().tiny(SIZE)
        n_model = 2 if world >= 4 and world % 2 == 0 else 1
        mesh = make_mesh(world // n_model, n_model)
        rng = np.random.RandomState(410)
        b, h = mesh.n_data, SIZE // 2  # one sample a 'data' group
        batch = shard_batch(mesh, {
            "meas": rng.rand(b, 1, SIZE, SIZE, SIZE).astype(np.float32),
            "vol": (rng.rand(b, 1, SIZE, SIZE, SIZE) > 0.5).astype(
                np.float32),
            "joints": (rng.rand(b, 72) * h).astype(np.float32),
            "joints_vis": np.ones((b, 72), np.float32)})

        def one_step(spatial):
            model, lct = build_nlospose(
                cfg.model, device=dev, seed=410,
                spatial_mesh=mesh if spatial else None)
            state = TrainState.create(model, cfg.train)
            replicate(mesh, state)
            if n_model > 1 and not spatial:
                apply_tp(model, mesh, state.optimizer)
            metrics = make_train_step(model, mesh=mesh)(state, batch, lct)
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise RuntimeError(f"non-finite loss {loss}")
            return loss

        loss = one_step(spatial=False)
        sp_loss = float("nan")
        if n_model > 1:
            sp_loss = one_step(spatial=True)
            # an envelope, as the JAX dry run's: at the random init the
            # PoseNet BatchNorms amplify reduction-order noise to a few
            # percent; a broken sharded FFT diverges O(1)
            if abs(sp_loss - loss) >= 0.1 * max(1.0, abs(loss)):
                raise RuntimeError(f"sharded-LCT train step diverges: "
                                   f"{sp_loss} vs {loss}")
        return {"n_devices": world, "mesh": [mesh.n_data, mesh.n_model],
                "device": str(dev), "loss": loss, "sharded_lct_loss": sp_loss}
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, nargs="?", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--world", type=int, default=None)
    p.add_argument("--port", type=int, default=None)
    args = p.parse_args(argv)
    if args.rank is not None:  # one rank of a dry run
        out = _rank(args.rank, args.world, args.port, args.device)
        if args.rank == 0:
            print(RESULT + json.dumps(out), flush=True)
        return 0
    n = args.n or (torch.cuda.device_count() if args.device != "cpu" else 4)
    print(json.dumps(dryrun_multichip(n, device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
