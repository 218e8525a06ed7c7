"""Multi-process (multi-GPU, multi-host) start-up.

Port of ``hiddenpose_tpu/parallel/distributed.py``.  :func:`initialize`
joins this process to the job (``torch.distributed.init_process_group``),
every process builds the same ('data', 'model') mesh over the job's ranks
(``parallel/mesh.py``), and the data pipeline feeds each process a
disjoint shard of the global batch (``shard_index`` / ``shard_count`` of
``data/dataset.py::DataPipeline``, from :func:`process_info`).  The
gradient average rides the train step's all-reduce over 'data'
(``train/step.py``): NCCL over NVLink within a host and the network
between hosts.

Environment-driven, so one command works on any layout:
``HP_COORDINATOR`` (host:port of rank 0) / ``HP_NUM_PROCESSES`` /
``HP_PROCESS_ID``, as the JAX package reads them, or else torchrun's
``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` (in place of
JAX's detection of a Cloud TPU job); ``LOCAL_RANK`` picks this process's
GPU.  ``grain_shard_options`` is not ported: grain is not on the GPU host
and the port's loader shards itself.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from hiddenpose_tpu_torch import resolve_device


@dataclass(frozen=True)
class ShardInfo:
    """This process's slice of the global data stream."""

    shard_index: int
    shard_count: int


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def local_device(device="cuda") -> torch.device:
    """This process's device: ``cuda:{LOCAL_RANK}`` (0 without torchrun)
    for a GPU ``device``, else ``device`` itself."""
    device = resolve_device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", _env_int("LOCAL_RANK") or 0)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> None:
    """Join this process to the multi-process job (nothing for one
    process).

    The arguments fall back to ``HP_COORDINATOR`` / ``HP_NUM_PROCESSES`` /
    ``HP_PROCESS_ID``, then to torchrun's ``MASTER_ADDR``:``MASTER_PORT``
    / ``WORLD_SIZE`` / ``RANK``.  ``device``: the GPU by default (NCCL;
    this process takes ``cuda:{LOCAL_RANK}``, and the call raises where
    there is no GPU), or ``"cpu"`` (gloo).  Safe to call twice (the second
    call does nothing)."""
    device = resolve_device(device)
    if coordinator_address is None:
        coordinator_address = os.environ.get("HP_COORDINATOR") or None
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = (_env_int("HP_NUM_PROCESSES")
                         or _env_int("WORLD_SIZE"))
    if process_id is None:
        process_id = _env_int("HP_PROCESS_ID")
        if process_id is None:
            process_id = _env_int("RANK")

    if num_processes is not None and num_processes <= 1:
        return
    if coordinator_address is None and num_processes is None:
        return  # a single-process run
    if dist.is_initialized():
        return
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            f"a multi-process job needs a coordinator, a process count and "
            f"this process's id; got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}")
    if device.type == "cuda":
        torch.cuda.set_device(local_device(device))
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def process_info() -> ShardInfo:
    """This process's (index, count): the data-shard coordinates."""
    if not dist.is_initialized():
        return ShardInfo(shard_index=0, shard_count=1)
    return ShardInfo(shard_index=dist.get_rank(),
                     shard_count=dist.get_world_size())


def free_port() -> int:
    """A TCP port of localhost that nothing listens on now (for a job's
    rendezvous on one host)."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port
