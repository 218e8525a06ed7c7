"""Evaluation entry point of the port.

    python -m hiddenpose_tpu_torch.cli.test --model DIR [--test MODE] ...

The flags and three modes of the JAX package's ``test.py``:
``test_pose_v2`` (MPJPE over the test split, or the synthetic source),
``test_realdata`` (measured ``.mat`` captures through NlosPose or, with
``--variant sformer``, NlosPoseSformer) and ``test_fk`` (fk-dataset
captures), restoring the latest ``epoch_*`` checkpoint of ``--model``.
Joints are written as the same ``.txt`` files (``preds_{id}``,
``gt_{id}``, ``pred_joints_{name}``, ``sformer_joints_{name}``) and
figures as the JAX command draws them (``viz/visualizer.py``): each
skeleton's png beside its ``.txt`` under ``joints/``, and for a measured
capture the refinement's three views as ``threeviews/feature_{name}``.
A figure is best-effort: where it cannot be drawn (no matplotlib, as on
the GPU host) the command warns once and writes the ``.txt`` files.
``--device`` is a GPU index (default 0) or ``cpu``; without a GPU the
command fails unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from hiddenpose_tpu_torch.cli import device_arg
from hiddenpose_tpu_torch.viz.visualizer import joints_log, threeviews_log


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="HiddenPose (PyTorch) evaluation")
    p.add_argument("--model", type=str, default="./checkpoints",
                   help="checkpoint path or directory")
    p.add_argument("--test", type=str, default="test_pose_v2",
                   choices=("test_realdata", "test_pose_v2", "test_fk"))
    p.add_argument("--log", type=str, default="./log")
    p.add_argument("--data", type=str, default="")
    p.add_argument("--device", type=device_arg, default="0",
                   help="GPU index, or 'cpu'")
    p.add_argument("--out", type=str, default="./test_results")
    p.add_argument("--synthetic", action="store_true",
                   help="evaluate on the synthetic generator")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--variant", type=str, default="nlospose",
                   choices=("nlospose", "sformer"),
                   help="model family for test_realdata")
    p.add_argument("--dtype", type=str, default=None,
                   choices=("float32", "bfloat16"),
                   help="activation dtype; default float32 for NlosPose, "
                        "bfloat16 for the Sformer")
    return p.parse_args(argv)


def _load_state(path, cfg, model):
    from hiddenpose_tpu_torch.train import checkpoint as ckpt
    from hiddenpose_tpu_torch.train.state import TrainState

    state = TrainState.create(model, cfg.train)
    if os.path.isdir(path):
        path = ckpt.latest_checkpoint(path)
    if path and os.path.exists(path):
        state, epoch, _ = ckpt.restore_checkpoint(path, state)
        print(f"restored {path} (epoch {epoch})")
    else:
        print("WARNING: no checkpoint found — evaluating random init")
    return state


def main(argv=None):
    """Run the command; returns {'device', 'mpjpe' (None outside
    test_pose_v2), 'joints': {name: (J, 3) array}, 'figures': [the pngs
    drawn]}."""
    args = parse_args(argv)

    import torch

    from hiddenpose_tpu_torch import resolve_device
    from hiddenpose_tpu_torch.config import t128_config
    from hiddenpose_tpu_torch.data.dataset import (
        DataPipeline,
        NlosPoseSource,
        SyntheticSource,
    )
    from hiddenpose_tpu_torch.data.device_prefetch import device_prefetch
    from hiddenpose_tpu_torch.data.preprocess import (
        load_fk_measurement,
        load_realdata,
    )
    from hiddenpose_tpu_torch.eval.metrics import mpjpe
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose
    from hiddenpose_tpu_torch.train.step import make_eval_step

    device = resolve_device(args.device)
    cfg = t128_config() if args.size == 128 else t128_config().tiny(args.size)
    cfg = dataclasses.replace(
        cfg, phase="test", dataset=dataclasses.replace(
            cfg.dataset, phase="test",
            test_path=args.data or cfg.dataset.test_path))
    if args.dtype:  # the heatmap pipeline stays float32 unless asked
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=args.dtype))
    joints_dir = os.path.join(args.out, "joints")
    views_dir = os.path.join(args.out, "threeviews")
    results = {"device": str(device), "mpjpe": None, "joints": {},
               "figures": []}
    warned = []

    def figure(draw, *a):
        """One png, best-effort (warned about once)."""
        try:
            results["figures"].append(draw(*a))
        except Exception as e:
            if not warned:
                warned.append(e)
                print(f"WARNING: figures not drawn ({e!r}); the joints' "
                      ".txt files are written")

    def log_joints(joints, name):
        """The joints' .txt (written before the figure is drawn, so it
        is there without matplotlib) and their figure."""
        joints = np.asarray(joints).reshape(-1, 3)
        results["joints"][name] = joints
        figure(joints_log, joints, joints_dir, name)

    model = state = lct = eval_step = None
    if not (args.test == "test_realdata" and args.variant == "sformer"):
        model, lct = build_nlospose(cfg.model, device=device,
                                    seed=cfg.train.seed)
        state = _load_state(args.model, cfg, model)
        eval_step = make_eval_step(model)

    def run_single(meas_thw: np.ndarray, name: str):
        """One measurement (T, H, W) -> joints."""
        meas = torch.from_numpy(
            np.ascontiguousarray(meas_thw[None, None], np.float32))
        out = eval_step(state, {"meas": meas.to(device)}, lct)
        preds = out["pred_joints"][0].float().cpu().numpy().reshape(-1, 3)
        figure(threeviews_log, out["refine"], views_dir, f"feature_{name}")
        log_joints(preds, f"pred_joints_{name}")
        print(f"{name}: joints span "
              f"{preds.min(0).round(1)}..{preds.max(0).round(1)}")

    def run_single_sformer(meas_thw: np.ndarray, name: str):
        """A measured capture through NlosPoseSformer: the time bins enter
        as frames of one channel; the joint tokens decode by per-axis
        SimDR soft-argmax."""
        from hiddenpose_tpu_torch.models.sformer import (
            build_sformer,
            serve_video,
        )

        sf = build_sformer(cfg.model, device=device, seed=cfg.train.seed,
                           dtype=args.dtype or "bfloat16")
        video = torch.from_numpy(np.ascontiguousarray(
            meas_thw[None, :, None], np.float32)).to(device)
        joints = serve_video(sf, video)[0][0].cpu().numpy()
        log_joints(joints, f"sformer_joints_{name}")
        print(f"{name} (sformer): joints span "
              f"{joints.min(0).round(1)}..{joints.max(0).round(1)}")

    if args.test == "test_realdata":
        files = ([args.data] if args.data.endswith(".mat") else
                 [os.path.join(args.data, f)
                  for f in sorted(os.listdir(args.data))
                  if f.endswith(".mat")])
        for f in files:
            meas = load_realdata(f)
            name = os.path.splitext(os.path.basename(f))[0]
            if args.variant == "sformer":
                run_single_sformer(meas, name)
            else:
                run_single(meas, name)

    elif args.test == "test_fk":
        from scipy.io import loadmat

        files = [os.path.join(args.data, f)
                 for f in sorted(os.listdir(args.data)) if f.endswith(".mat")]
        t = cfg.model.time_size
        for f in files:
            # the reference crops [64:64 + 128] after x2 rebinning twice;
            # generalised to a centred crop of T bins
            raw_t = loadmat(f)["meas"].shape[2] // 4
            start = max((raw_t - t) // 2, 0)
            meas = load_fk_measurement(f, rebin_count=2,
                                       time_crop=(start, start + t))
            run_single(meas, os.path.splitext(os.path.basename(f))[0])

    else:  # test_pose_v2
        if args.synthetic or not os.path.isdir(cfg.dataset.test_path):
            source = SyntheticSource(cfg, length=8)
            print("using synthetic test source")
        else:
            source = NlosPoseSource(cfg, cfg.dataset.test_path)
        errs = []
        with DataPipeline(source, batch_size=cfg.test_batch_size,
                          shuffle=False, num_workers=cfg.num_workers,
                          pin_memory=device.type == "cuda") as pipe:
            for bi, batch in enumerate(pipe):
                if args.max_batches and bi >= args.max_batches:
                    break
                data = next(device_prefetch([batch], device))
                preds = eval_step(state, data, lct)["pred_joints"]
                preds = preds.float().cpu().numpy()
                gt = batch["joints"].numpy()
                errs.append(mpjpe(preds, gt))
                for i, pid in enumerate(batch["person_id"]):
                    log_joints(preds[i], f"preds_{pid}")
                    log_joints(gt[i], f"gt_{pid}")
        if errs:
            results["mpjpe"] = float(np.mean(errs))
            print(f"MPJPE (heatmap voxels): {results['mpjpe']:.4f} over "
                  f"{len(errs)} batches")

    print("finished")
    return results


if __name__ == "__main__":
    main()
