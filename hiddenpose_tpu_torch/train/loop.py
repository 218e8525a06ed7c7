"""The training loop over epochs.

Port of ``hiddenpose_tpu/train/loop.py`` as a function of (Config, data
source), on one device:

* seed ``cfg.train.seed`` for the initial weights (or ``weights``);
* Adam with the MultiStep schedule, its count ``TrainState.step``
  (``steps_per_epoch`` feeds it), and the reference's step-before-epoch
  quirk (``train/optim.py``);
* the train step at ``cfg.train.matmul_precision``, as the JAX loop;
* a pretrained, frozen autoencoder when ``cfg.model.pretrain_autoencoder``;
* resume from ``resume_from``, or (phase ``continue_train``) from the
  latest ``epoch_*`` in ``workdir``, at that epoch + 1;
* the metrics window: each step's losses stay on the device and the loop
  reads a window of ``log_every`` steps in one copy, never one per step;
  a non-finite loss found there (or before a checkpoint, or at an epoch's
  end) aborts the run before it can be saved;
* ``iter_{n}`` checkpoints every ``ckpt_every_iters`` steps, ``epoch_{e}``
  at each epoch's end; the JAX loop's log lines and ``metrics.jsonl``
  tags (``Train Loss``, ``joint_loss``, ``voxel_loss``);
* every ``viz_every`` steps the JAX loop's figures of the step's batch
  (:func:`log_visuals`: the volume, heatmaps and refinement with the
  ground-truth joints over them, predicted and ground-truth skeletons,
  three-view projections; with ``viz_histograms`` a histogram of every
  parameter under the JAX tree's tags), best-effort as in the JAX loop:
  a failure (no matplotlib, as on the GPU host) is a warning.

Not ported: the device mesh (multi-GPU, ROADMAP Queue 1 item 9), which
raises.

``TrainResult.timings`` holds, per step, the seconds the loop spent and
the seconds of that it waited on the loader, and per checkpoint its path
and the seconds its save took: host clocks only, read by ``chip_smoke.py``
phase 11.  With ``log_every`` > 1 the loop does not wait for the device
between reads, so a step's seconds are then its share of the host's time.
"""

from __future__ import annotations

import itertools
import logging
import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

import torch

from hiddenpose_tpu_torch import resolve_device
from hiddenpose_tpu_torch.data.dataset import DataPipeline, SyntheticSource
from hiddenpose_tpu_torch.data.device_prefetch import device_prefetch
from hiddenpose_tpu_torch.models.nlospose import build_nlospose
from hiddenpose_tpu_torch.train import checkpoint as ckpt
from hiddenpose_tpu_torch.train.pretrain import (
    freeze_autoencoder,
    load_pretrained_autoencoder,
)
from hiddenpose_tpu_torch.train.state import TrainState
from hiddenpose_tpu_torch.train.step import make_train_step
from hiddenpose_tpu_torch.utils.logging import MetricWriter, create_logger

METRICS = ("loss", "joint_loss", "voxel_loss")


@dataclass
class TrainResult:
    state: TrainState
    last_metrics: Dict[str, float]
    epochs_run: int
    timings: Dict[str, List] = field(default_factory=dict)


def train(
    cfg,
    source=None,
    workdir: str = "./checkpoints",
    resume_from: Optional[str] = None,
    log_every: int = 100,
    ckpt_every_iters: int = 10000,
    max_steps_per_epoch: Optional[int] = None,
    viz_every: Optional[int] = None,
    viz_histograms: bool = False,
    shard_index: int = 0,
    shard_count: int = 1,
    weights: Optional[Mapping[str, torch.Tensor]] = None,
    device="cuda",
) -> TrainResult:
    """Train ``cfg``'s NlosPose on ``source`` (synthetic, 8 samples, when
    None) from ``cfg.train.begin_epoch`` to ``cfg.train.end_epoch``.
    ``weights``: a state_dict to start from instead of the seeded
    initialisation.  ``device``: the GPU by default (raises without one);
    ``"cpu"`` only when asked for."""
    device = resolve_device(device)
    logger = create_logger(cfg.log_dir, phase=cfg.phase)
    model, lct = build_nlospose(cfg.model, device=device, seed=cfg.train.seed)
    if weights is not None:
        model.load_state_dict(weights)
    if source is None:
        source = SyntheticSource(cfg, length=8)
    pipeline = DataPipeline(
        source, batch_size=cfg.train.batch_size, shuffle=True,
        seed=cfg.train.seed, num_workers=cfg.num_workers,
        shard_index=shard_index, shard_count=shard_count,
        pin_memory=device.type == "cuda")
    steps_per_epoch = max_steps_per_epoch or len(pipeline)
    logger.info("Total number of parameters: "
                f"{sum(p.numel() for p in model.parameters())}")

    params = None
    if cfg.model.pretrain_autoencoder:
        load_pretrained_autoencoder(cfg.model.pretrain_autoencoder_path,
                                    model)
        params = freeze_autoencoder(model)
        logger.info("loaded pretrained autoencoder from "
                    f"{cfg.model.pretrain_autoencoder_path} (frozen)")
    state = TrainState.create(model, cfg.train, steps_per_epoch,
                              params=params)

    begin_epoch = cfg.train.begin_epoch
    global_iter = 0
    if cfg.phase == "continue_train" or resume_from:
        path = resume_from or ckpt.latest_checkpoint(workdir)
        if path:
            state, epoch, global_iter = ckpt.restore_checkpoint(path, state)
            begin_epoch = epoch + 1
            logger.info(f"resumed from {path} at epoch {begin_epoch}")

    train_step = make_train_step(
        model, matmul_precision=cfg.train.matmul_precision)
    timings = dict(step_s=[], wait_s=[], ckpt=[])
    window: List[Dict[str, torch.Tensor]] = []
    last: Dict[str, float] = {}
    epochs_run = 0
    begin_time = time.time()

    def flush():
        """One device -> host copy for the whole window; returns the host
        window and its first entry with a non-finite loss, or None."""
        if not window:
            return [], None
        rows = torch.stack([torch.stack([m[k] for k in METRICS])
                            for m in window]).cpu().tolist()
        window.clear()
        host = [dict(zip(METRICS, r)) for r in rows]
        bad = next((m for m in host if not math.isfinite(m["loss"])), None)
        return host, bad

    def result(metrics):
        return TrainResult(state=state, last_metrics=metrics,
                           epochs_run=epochs_run, timings=timings)

    def abort(bad, where):
        # stop rather than poison the optimizer state; the last epoch
        # checkpoint stays restorable
        logger.error(f"non-finite loss {bad['loss']} detected at {where}; "
                     "aborting (restore the last checkpoint to resume)")
        return result(bad)

    writer = MetricWriter(cfg.log_dir)

    def save(epoch, name=None):
        t0 = time.perf_counter()
        path = ckpt.save_checkpoint(workdir, state, epoch, global_iter,
                                    name=name)
        timings["ckpt"].append((path, time.perf_counter() - t0))

    try:
        for epoch in range(begin_epoch, cfg.train.end_epoch):
            epoch_begin = time.time()
            pipeline.set_epoch(epoch)  # per-epoch reshuffle, reproducibly
            batches = device_prefetch(
                itertools.islice(iter(pipeline), steps_per_epoch), device)
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                t1 = time.perf_counter()
                window.append(train_step(state, batch, lct))
                global_iter += 1

                if global_iter % log_every == 0:
                    host, bad = flush()
                    if bad is not None:
                        return abort(bad, f"iter {global_iter} window")
                    last = host[-1]
                    mean_loss = sum(m["loss"] for m in host) / len(host)
                    writer.scalar("Train Loss", mean_loss, global_iter)
                    writer.scalar("joint_loss", last["joint_loss"],
                                  global_iter)
                    writer.scalar("voxel_loss", last["voxel_loss"],
                                  global_iter)
                    logger.info(f"iter {global_iter} loss {mean_loss:.5f} "
                                f"({time.time() - begin_time:.1f}s elapsed)")
                timings["step_s"].append(time.perf_counter() - t0)
                timings["wait_s"].append(t1 - t0)

                if viz_every and global_iter % viz_every == 0:
                    log_visuals(cfg, model, batch, lct, global_iter,
                                writer=writer if viz_histograms else None)

                if ckpt_every_iters and global_iter % ckpt_every_iters == 0:
                    host, bad = flush()
                    if bad is not None:
                        return abort(bad,
                                     f"iter {global_iter} (pre-checkpoint)")
                    last = host[-1] if host else last
                    save(epoch, name=f"iter_{global_iter}")

            # flush before the epoch checkpoint, so that a poisoned tail of
            # the epoch is never saved as a good checkpoint
            host, bad = flush()
            if bad is not None:
                return abort(bad, f"epoch {epoch} end")
            last = host[-1] if host else last
            save(epoch)
            epochs_run += 1
            epoch_time = time.time() - epoch_begin
            left_h = epoch_time * (cfg.train.end_epoch - epoch - 1) / 3600
            logger.info(f"epoch {epoch} used {epoch_time:.1f}s, "
                        f"left {left_h:.2f}h")
        return result(last)
    finally:
        pipeline.close()
        writer.close()


def log_visuals(cfg, model, batch, lct, global_iter, writer=None) -> None:
    """The JAX loop's figures of one interval under
    ``<cfg.result_dir>/figure``: ``volume/{volume,output,feature}_{n}``
    (axis sums with the first sample's ground-truth joints),
    ``joints/{pred,gt}_joints_{n}`` (skeletons and their ``.txt``),
    ``threeviews/{feature,output,volume}_{n}``; with ``writer``, a
    histogram of every parameter tagged by its JAX tree path.  The
    heatmaps and refinement are an eval-mode forward of the batch.
    Best-effort: a failure is logged as a warning."""
    try:
        from hiddenpose_tpu_torch.ops.softargmax import softmax_integral
        from hiddenpose_tpu_torch.viz.visualizer import (
            host_array,
            joints_log,
            threeviews_log,
            volume_log,
        )

        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                heatmaps, refine = model(batch["meas"], lct)
                preds = softmax_integral(heatmaps, cfg.model.num_joints)
        finally:
            model.train(was_training)
        out_dir = os.path.join(cfg.result_dir, "figure")
        vol_dir = os.path.join(out_dir, "volume")
        tv_dir = os.path.join(out_dir, "threeviews")
        joints_dir = os.path.join(out_dir, "joints")
        vol, output, feature = (host_array(t) for t in (
            batch["vol"], heatmaps, refine))
        gt = host_array(batch["joints"][0]).reshape(-1, 3)

        for tag, v in (("volume", vol), ("output", output),
                       ("feature", feature)):
            volume_log(v, vol_dir, f"{tag}_{global_iter}", global_iter,
                       joints=gt)
        joints_log(host_array(preds[0]).reshape(-1, 3), joints_dir,
                   f"pred_joints_{global_iter}")
        joints_log(gt, joints_dir, f"gt_joints_{global_iter}")
        for tag, v in (("feature", feature), ("output", output),
                       ("volume", vol)):
            threeviews_log(v, tv_dir, f"{tag}_{global_iter}", global_iter)

        if writer is not None:
            from hiddenpose_tpu_torch.utils.jax_bridge import to_jax

            def walk(node, path):  # in the JAX tree's (sorted) order
                for k, v in sorted(node.items()):
                    if isinstance(v, dict):
                        yield from walk(v, (*path, k))
                    else:
                        yield "/".join((*path, k)), v

            tree = to_jax(dict(model.named_parameters()))
            for tag, leaf in walk(tree, ()):
                writer.histogram(f"params/{tag}", leaf, global_iter)
    except Exception as e:  # figures are best-effort
        logging.getLogger("hiddenpose").warning(f"viz failed: {e}")
