"""What each gloo rank of the multi-rank port tests runs
(``tests/torch_gloo.py::run_ranks``).  Torch and the port only: no JAX.
Every function takes JSON-able arguments and returns what the test
compares, as CPU tensors."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def mesh_layout(n_data, n_model):
    """This rank's mesh: its coordinates, the ranks of its two groups (by
    an all-gather over each) and its share of a batch of row numbers."""
    from hiddenpose_tpu_torch.parallel.mesh import (
        batch_sharding,
        make_mesh,
        replicate,
        replicated,
        shard_batch,
    )

    mesh = make_mesh(n_data, n_model)
    members = {}
    for axis in mesh.axis_names:
        parts = [torch.zeros(1, dtype=torch.long)
                 for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, torch.tensor([mesh.rank]),
                        group=mesh.group(axis))
        members[axis] = [int(t) for t in parts]
    rows = np.arange(2 * n_data * 3).reshape(2 * n_data, 3)
    mine = torch.full((2,), float(mesh.rank))
    replicate(mesh, mine)
    return {"rank": mesh.rank, "shape": mesh.shape,
            "index": {a: mesh.index(a) for a in mesh.axis_names},
            "members": members,
            "share": shard_batch(mesh, {"rows": rows})["rows"],
            "replicated": mine,
            "specs": (batch_sharding(mesh).spec, replicated(mesh).spec)}


def _lct_inputs(size, seed, batch):
    rng = np.random.RandomState(seed)
    meas = rng.rand(batch, size, size, size).astype(np.float32)
    wgt = rng.randn(batch, size, size, size).astype(np.float32)
    return torch.from_numpy(meas), torch.from_numpy(wgt)


def lct_sharded(n_data, n_model, size, seed, batch):
    """``lct_apply_sharded`` on this rank's share of a seeded batch: its
    output and the VJP of sum(out * w), as this rank's rows of the whole
    batch."""
    from hiddenpose_tpu_torch.ops.lct import lct_apply_sharded, make_lct_params
    from hiddenpose_tpu_torch.parallel.mesh import make_mesh, shard_batch

    mesh = make_mesh(n_data, n_model)
    params = make_lct_params(image_size=size, time_size=size,
                             bin_len=0.32, device="cpu")
    meas, wgt = _lct_inputs(size, seed, batch)
    local = shard_batch(mesh, {"meas": meas, "wgt": wgt})
    m = local["meas"].requires_grad_()
    out = lct_apply_sharded(m, params, mesh)
    (out * local["wgt"]).sum().backward()
    return {"data_index": mesh.index("data"), "out": out.detach(),
            "grad": m.grad}


def bn_dice(n_data, seed):
    """A training ``FlaxBatchNorm3d`` and the Dice loss on this rank's
    share, inside ``data_parallel``: the output, the new running
    statistics, the Dice loss and the input gradients of a weighted sum."""
    from hiddenpose_tpu_torch.losses import dice_loss
    from hiddenpose_tpu_torch.models.posenet3d import FlaxBatchNorm3d
    from hiddenpose_tpu_torch.parallel.mesh import (
        data_parallel,
        make_mesh,
        shard_batch,
    )

    mesh = make_mesh(n_data, 1)
    rng = np.random.RandomState(seed)
    full = {"x": rng.randn(4, 3, 4, 5, 6).astype(np.float32) * 2 + 1,
            "w": rng.randn(4, 3, 4, 5, 6).astype(np.float32),
            "logits": rng.randn(4, 50).astype(np.float32),
            "t": (rng.rand(4, 50) > 0.5).astype(np.float32)}
    local = shard_batch(mesh, full)
    bn = FlaxBatchNorm3d(3).train()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 0.5, 2.0]))
        bn.bias.copy_(torch.tensor([0.0, 0.1, -0.2]))
    x = local["x"].requires_grad_()
    logits = local["logits"].requires_grad_()
    with data_parallel(mesh):
        y = bn(x)
        dice = dice_loss(logits, local["t"])
    ((y * local["w"]).sum() + dice).backward()
    return {"y": y.detach(), "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone(), "dice": dice.detach(),
            "x_grad": x.grad, "logits_grad": logits.grad}


def dp_step(n_data, n_model, size, weights_path, batch_path,
            spatial=False):
    """One data-parallel train step of the tiny(``size``) NlosPose (the
    weights and global batch from the test's files) on a (``n_data``,
    ``n_model``) mesh: the wide weights and their Adam moments sharded
    over 'model' (``n_model`` > 1), or with ``spatial`` the LCT sharded
    over 'model' instead.  Returns the metrics and the whole new
    parameters, BatchNorm statistics and Adam moments under the plain
    names."""
    from hiddenpose_tpu_torch.config import default_config
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose
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

    cfg = default_config().tiny(size)
    mesh = make_mesh(n_data, n_model)
    model, lct = build_nlospose(cfg.model, device="cpu",
                                spatial_mesh=mesh if spatial else None)
    model.load_state_dict(torch.load(weights_path))
    state = TrainState.create(model, cfg.train)
    replicate(mesh, state)
    if n_model > 1 and not spatial:
        apply_tp(model, mesh, state.optimizer)
    batch = shard_batch(mesh, dict(np.load(batch_path)))
    metrics = make_train_step(model, mesh=mesh)(state, batch, lct)
    sd = full_state_dict(model)
    opt = full_optimizer_state_dict(model, state.optimizer)
    names = getattr(model, "_tp_plain_names",
                    [n for n, _ in model.named_parameters()])
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "names": names, "digest": digests(sd),
           "tp_names": [n for n, *_ in _sharded(model)]}
    if dist.get_rank() == 0:  # the others' tensors by their digests only
        out.update(state_dict=sd, exp_avg=[opt["state"][i]["exp_avg"]
                                           for i in range(len(names))])
    return out


def digests(tensors):
    """{name: sha1 of the tensor's bytes}: bit-equality across ranks
    without moving the tensors."""
    import hashlib

    return {k: hashlib.sha1(v.detach().cpu().contiguous().numpy()
                            .tobytes()).hexdigest()
            for k, v in tensors.items()}


def initialize_env():
    """``initialize(device="cpu")`` from the environment the test set, and
    again (which must do nothing): what the job looks like."""
    from hiddenpose_tpu_torch.parallel import distributed

    distributed.initialize(device="cpu")
    group = dist.group.WORLD
    distributed.initialize(device="cpu")
    assert dist.group.WORLD is group
    info = distributed.process_info()
    total = torch.tensor([dist.get_rank() + 1.0])
    dist.all_reduce(total)
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "backend": dist.get_backend(), "info": (info.shard_index,
                                                    info.shard_count),
            "sum": float(total), "device": str(distributed.local_device(
                "cpu"))}


def linear_dp(n):
    """The JAX multi-process test's linear model on the port's machinery:
    the first batch of 8 of this rank's pipeline shard of 16 samples (the
    pipeline's own order and sharding), the mean squared error of x @ w
    at w = 0, the gradient averaged over 'data'."""
    from hiddenpose_tpu_torch.data.dataset import DataPipeline
    from hiddenpose_tpu_torch.parallel.distributed import process_info
    from hiddenpose_tpu_torch.parallel.mesh import average_gradients, make_mesh

    mesh = make_mesh(n, 1)
    info = process_info()
    pipe = DataPipeline(IdSource(16), batch_size=8, shuffle=True, seed=11,
                        num_workers=0, shard_index=info.shard_index,
                        shard_count=info.shard_count)
    pipe.set_epoch(0)
    ids = pipe._index_batches()[0]
    src = pipe.source
    w = torch.zeros(4, 1, requires_grad=True)
    x, y = torch.from_numpy(src.x[ids]), torch.from_numpy(src.y[ids])
    ((x @ w - y) ** 2).mean().backward()
    average_gradients([w], mesh)
    return {"ids": ids.tolist(), "grad": w.grad.clone()}


class IdSource:
    """``n`` samples of x (4,) and y (1,) from a seed."""

    def __init__(self, n):
        rng = np.random.RandomState(0)
        self.x = rng.randn(n, 4).astype(np.float32)
        self.y = rng.randn(n, 1).astype(np.float32)

    def __len__(self):
        return len(self.x)


def cli_rank(outdir, workdir, size):
    """``python -m hiddenpose_tpu_torch.cli.train --multihost --device cpu
    --synthetic --size N`` for one step (loader in-process), its train
    step's batch and the gradients it applied kept."""
    import dataclasses
    import os

    import hiddenpose_tpu_torch.config as config
    import hiddenpose_tpu_torch.train.loop as loop
    from hiddenpose_tpu_torch.cli import train as cli

    t128 = config.t128_config
    config.t128_config = lambda: dataclasses.replace(t128(), num_workers=0)
    seen = []
    make_step = loop.make_train_step

    def recording(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(state, batch, lct):
            seen.append({k: v.clone() for k, v in batch.items()})
            return step(state, batch, lct)

        return run

    loop.make_train_step = recording
    result = cli.main(["--multihost", "--device", "cpu", "--synthetic",
                       "--size", str(size), "--epochs", "1",
                       "--steps-per-epoch", "1", "--model", workdir,
                       "--log", os.path.join(workdir, "log")])
    model = result.state.model
    grads = {n: p.grad for n, p in model.named_parameters()}
    out = {"rank": dist.get_rank(), "batch": seen[0],
           "metrics": result.last_metrics, "grad_digest": digests(grads),
           "state_digest": digests(model.state_dict())}
    if dist.get_rank() == 0:  # rank 1's by their digests only
        out.update(grads=grads, state_dict=model.state_dict())
    torch.save(out, os.path.join(outdir, f"rank{dist.get_rank()}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    import sys

    if sys.argv[1] == "cli":
        cli_rank(sys.argv[2], sys.argv[3], int(sys.argv[4]))
    else:  # initialize from the environment
        import os

        out = initialize_env()
        torch.save(out, os.path.join(sys.argv[2], f"rank{out['rank']}.pt"))
        dist.barrier()
        dist.destroy_process_group()
