"""Host -> device batch prefetching.

Port of ``hiddenpose_tpu/data/device_prefetch.py``: ``buffer_size`` batches
are in flight on the device at once.  Each tensor goes by
``.to(device, non_blocking=True)``, from pinned memory where the pipeline
pinned it, so the copy is queued behind the running step and the host
goes on.  ``person_id`` (strings) is dropped.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterator

import torch


def device_prefetch(iterator: Iterator[Dict], device, buffer_size: int = 2,
                    drop_keys: tuple = ("person_id",)) -> Iterator[Dict]:
    """Yield the batches of ``iterator`` (dicts of tensors or numpy arrays)
    on ``device``, keeping ``buffer_size`` in flight."""

    def put(batch):
        return {k: torch.as_tensor(v).to(device, non_blocking=True)
                for k, v in batch.items() if k not in drop_keys}

    queue = deque()
    for batch in iterator:
        queue.append(put(batch))
        if len(queue) >= buffer_size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
