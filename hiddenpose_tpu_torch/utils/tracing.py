"""Spans of the port's own work: where a request's or a train step's time
goes, on the host and on the device.

The recorder is off by default; ``enable()`` turns it on and ``disable()``
off.  Off, a span site costs one flag check: it makes no CUDA event, no
record and no allocation.  On, each span leaves one :class:`Record` in a
bounded in-memory buffer (the oldest records fall out past ``CAPACITY``),
and ``take()`` returns the records held and clears the buffer.

Host times are ``time.time_ns()``: the clock ``torch.profiler`` stamps its
CPU events with, so a span can be laid over a profiler trace of the same
process, whichever thread recorded it.  A device span is also a pair of
CUDA events recorded on the current stream around the work; ``take()``
synchronises and resolves each pair to milliseconds.

Spans the port records:

* ``serve.py``: ``serve.queue`` (one a request, from ``submit()`` to the
  moment the pump takes it into a batch; ``id`` the request, ``parent``
  the batch), and for each batch ``serve.pack`` (stack, cast, pin and the
  enqueue of the host-to-device copy), ``serve.h2d`` (the copy; a device
  span), ``serve.forward`` (the enqueue of the forward; a device span too)
  and ``serve.fetch`` (the host blocked on the batch's fence: on the GPU
  the event behind the joints' copy back, on the CPU the copy).
* Inside a serving forward only, the device stages ``stage.recon``
  (FeatureExtraction, the LCT, normalisation), ``stage.unet``,
  ``stage.trunk`` (PoseNet3D's stem and layer1-4) and ``stage.head`` (the
  deconv head through the soft-argmax's joints): ``models/nlospose.py``,
  ``models/posenet3d.py``, ``train/step.py::make_forward``.
* ``train/step.py::make_train_step``: ``step.forward`` (the forward and the
  losses), ``step.backward`` and ``step.adam``, each a device span too.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import List, Optional

import torch

# records held before the oldest fall out
CAPACITY = 1 << 16

_on = False
_records: collections.deque = collections.deque(maxlen=CAPACITY)
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_NULL = contextlib.nullcontext()


class Record:
    """One span: ``name``; host ``start_ns`` and ``end_ns`` on
    ``time.time_ns()``'s clock; the recording ``thread``'s name; ``id``,
    the request, batch or train step it belongs to; ``parent``, the unit
    it hands on to (a request's batch) or None; ``ms``, its device time
    for a device span once ``take()`` resolved it, else None."""

    __slots__ = ("name", "start_ns", "end_ns", "thread", "id", "parent",
                 "ms", "events")

    def __init__(self, name, start_ns, end_ns, id, parent, events):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.thread = threading.current_thread().name
        self.id, self.parent = id, parent
        self.ms = None
        self.events = events

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def __repr__(self):
        return (f"Record({self.name!r}, id={self.id}, parent={self.parent}, "
                f"host_ms={self.host_ms:.3f}, ms={self.ms})")


def enable() -> None:
    """Start recording spans."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording spans; the records held stay for ``take()``."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def new_id() -> int:
    """A fresh id for a request, batch or step (0 while off)."""
    return next(_ids) if _on else 0


def now_ns() -> int:
    return time.time_ns()


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _append(rec: Record) -> None:
    with _lock:
        _records.append(rec)


def record(name: str, start_ns: int, end_ns: int, id: int = 0,
           parent: Optional[int] = None) -> None:
    """Keep a host span whose times were taken elsewhere."""
    if _on:
        _append(Record(name, start_ns, end_ns, id, parent, None))


class _Span:
    __slots__ = ("name", "id", "parent", "device", "stages", "start",
                 "event", "open", "outer")

    def __init__(self, name, id, parent, device, stages):
        self.name, self.id, self.parent = name, id, parent
        self.device, self.stages = device, stages
        self.open = None

    def __enter__(self):
        if self.stages:
            self.outer = getattr(_local, "scope", None)
            _local.scope = self
        self.event = _event() if self.device else None
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.stages:
            stage(None)
            _local.scope = self.outer
        end = time.time_ns()
        events = (self.event, _event()) if self.device else None
        _append(Record(self.name, self.start, end, self.id, self.parent,
                       events))
        return False


def span(name: str, id: int = 0, parent: Optional[int] = None, *,
         device: bool = False, stages: bool = False):
    """A context manager that records the span ``name`` of the block.
    ``device``: record CUDA events around it too (the work runs on the
    current CUDA device).  ``stages``: the block is a serving forward, and
    ``stage()`` calls inside it on this thread record its device stages
    under the same ``id`` (CUDA events where ``device``)."""
    if not _on:
        return _NULL
    return _Span(name, id, parent, device, stages)


def stage(name: Optional[str]) -> None:
    """Inside a ``span(..., stages=True)`` on this thread: end the stage
    open there, and start ``name`` (None: none), one event marking both
    ends.  Elsewhere (a train step's forward, a recompute) nothing."""
    if not _on:
        return
    scope = getattr(_local, "scope", None)
    if scope is None or (name is None and scope.open is None):
        return
    ev = _event() if scope.device else None
    now = time.time_ns()
    if scope.open is not None:
        n, t0, e0 = scope.open
        _append(Record(n, t0, now, scope.id, None,
                       (e0, ev) if scope.device else None))
    scope.open = (name, now, ev) if name is not None else None


def take() -> List[Record]:
    """The records held, oldest first, with each device span's ``ms``
    resolved (after a synchronise); the buffer is left empty."""
    with _lock:
        recs = list(_records)
        _records.clear()
    if any(r.events is not None for r in recs):
        torch.cuda.synchronize()
    for r in recs:
        if r.events is not None:
            r.ms = r.events[0].elapsed_time(r.events[1])
            r.events = None
    return recs
