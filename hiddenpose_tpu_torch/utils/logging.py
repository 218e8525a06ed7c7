"""Logging and metric writers.

Port of ``hiddenpose_tpu/utils/logging.py``: a file + console logger and a
metric sink that always writes ``metrics.jsonl`` in the log directory,
with the JAX package's records (``tag``, ``value``, ``step``, ``ts``;
histograms as ``hist`` summaries).  Where the JAX writer adds TensorFlow
summaries, this one adds TensorBoard events through
``torch.utils.tensorboard`` when that imports (it needs the
``tensorboard`` package); training never depends on it.
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np


def create_logger(log_dir: str, name: str = "hiddenpose",
                  phase: str = "train") -> logging.Logger:
    """File + console logger, file named <name>_<time>_<phase>.log."""
    os.makedirs(log_dir, exist_ok=True)
    stamp = time.strftime("%Y-%m-%d-%H-%M")
    log_file = os.path.join(log_dir, f"{name}_{stamp}_{phase}.log")

    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)-15s %(message)s")
    fh = logging.FileHandler(log_file)
    fh.setFormatter(fmt)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


class NullWriter:
    """A metric sink that writes nothing (a multi-process job's ranks
    other than 0)."""

    def scalar(self, *args, **kwargs) -> None:
        pass

    def histogram(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


class MetricWriter:
    """Scalar metric sink: JSONL always (metrics.jsonl in log_dir),
    TensorBoard events too when ``torch.utils.tensorboard`` imports."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir)

    def _write(self, rec: dict) -> None:
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def scalar(self, tag: str, value: float, step: int):
        self._write({"tag": tag, "value": float(value), "step": int(step),
                     "ts": time.time()})
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def histogram(self, tag: str, values, step: int, bins: int = 64):
        """Per-parameter histogram; the JSONL sink stores (bin counts,
        min, max, mean, std) summaries to stay lightweight."""
        v = np.asarray(values).ravel()
        counts, edges = np.histogram(v, bins=bins)
        self._write({
            "tag": tag, "step": int(step), "ts": time.time(),
            "hist": {
                "counts": counts.tolist(),
                "min": float(edges[0]), "max": float(edges[-1]),
                "mean": float(v.mean()) if v.size else 0.0,
                "std": float(v.std()) if v.size else 0.0,
            },
        })
        if self._tb is not None:
            self._tb.add_histogram(tag, v, int(step), bins=bins)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
