"""The port's command line: ``python -m hiddenpose_tpu_torch.cli.train``
and ``python -m hiddenpose_tpu_torch.cli.test``, with the flags of the
JAX package's ``train.py`` and ``test.py``."""

from __future__ import annotations


def device_arg(value: str) -> str:
    """``--device``: a GPU index (``cuda:<index>``) or ``cpu``."""
    return "cpu" if value == "cpu" else f"cuda:{int(value)}"
