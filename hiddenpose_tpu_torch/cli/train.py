"""Training entry point of the port.

    python -m hiddenpose_tpu_torch.cli.train [--synthetic] [--size 128] ...

The flags of the JAX package's ``train.py`` (the reference's
--model/--test/--log/--data/--device/--PHASE, and --synthetic, --epochs,
--batch-size, --steps-per-epoch, --log-every, --size, --precision), the
same t128 configuration and recipe, on one device: ``--device`` is a GPU
index (default 0) or ``cpu``; without a GPU the command fails unless
given ``--device cpu``.  Multi-host training (the JAX ``--multihost``) is
not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from hiddenpose_tpu_torch.cli import device_arg


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="HiddenPose (PyTorch) training")
    p.add_argument("--model", type=str, default="", help="model directory")
    p.add_argument("--test", type=str, default="", help="unused (parity)")
    p.add_argument("--log", type=str, default="", help="log directory")
    p.add_argument("--data", type=str, default="", help="data directory")
    p.add_argument("--device", type=device_arg, default="0",
                   help="GPU index, or 'cpu'")
    p.add_argument("--PHASE", type=str, default="train",
                   help="'train' | 'continue_train' | 'eval' | 'test'")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic generator")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--log-every", type=int, default=None,
                   help="iterations between scalar logs (default 100; "
                        "lowered for short runs)")
    p.add_argument("--size", type=int, default=128,
                   help="grid size (128 = the reference configuration)")
    p.add_argument("--precision", type=str, default=None,
                   choices=("default", "high", "highest"),
                   help="matmul precision of the train step "
                        "(cfg.train.matmul_precision, 'default')")
    return p.parse_args(argv)


def main(argv=None):
    """Run the command; returns the TrainResult."""
    args = parse_args(argv)

    from hiddenpose_tpu_torch import resolve_device
    from hiddenpose_tpu_torch.config import t128_config
    from hiddenpose_tpu_torch.data.dataset import (
        NlosPoseSource,
        SyntheticSource,
    )
    from hiddenpose_tpu_torch.train.loop import train

    device = resolve_device(args.device)
    cfg = t128_config() if args.size == 128 else t128_config().tiny(args.size)
    updates = {}
    if args.log:
        updates["log_dir"] = args.log
    if args.PHASE:
        updates["phase"] = args.PHASE
    cfg = dataclasses.replace(cfg, **updates)
    tr = {}
    if args.epochs is not None:
        tr["end_epoch"] = args.epochs
    if args.batch_size is not None:
        tr["batch_size"] = args.batch_size
    if args.precision is not None:
        tr["matmul_precision"] = args.precision
    if tr:
        cfg = dataclasses.replace(cfg,
                                  train=dataclasses.replace(cfg.train, **tr))
    if args.data:
        cfg = dataclasses.replace(cfg, dataset=dataclasses.replace(
            cfg.dataset, train_path=args.data))

    if args.synthetic or not os.path.isdir(cfg.dataset.train_path):
        source = SyntheticSource(cfg, length=max(8, cfg.train.batch_size * 4))
        print("using synthetic data source")
    else:
        source = NlosPoseSource(cfg, cfg.dataset.train_path)

    log_every = args.log_every
    if log_every is None:
        log_every = min(100, max(1, (args.steps_per_epoch or 100) // 2))

    result = train(cfg, source=source,
                   workdir=args.model or cfg.final_output_dir,
                   max_steps_per_epoch=args.steps_per_epoch,
                   log_every=log_every, device=device)
    print(f"finished training: {result.epochs_run} epochs, final loss "
          f"{result.last_metrics.get('loss', float('nan')):.5f}")
    return result


if __name__ == "__main__":
    main()
