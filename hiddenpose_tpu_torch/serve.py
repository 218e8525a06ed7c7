"""Batched-queue inference server for NlosPose, on one device.

Port of ``hiddenpose_tpu/serve.py::InferenceServer``: requests queue; a
pump thread packs up to ``batch_size`` of them, pads the tail by repeating
the last request so every batch has the same shape (per-sample results do
not depend on the batch: eval BatchNorm uses running statistics, GroupNorm
and the FFT are per-sample), runs the forward and resolves per-request
futures.

The pipeline is one batch deep, as in the JAX package: CUDA launches are
asynchronous, so the pump launches batch N+1 (a pinned-memory copy and the
forward, with no host sync) before it fetches batch N's joints.  Each
launch also queues its batch's fence: the joints' copy into pinned host
memory and a CUDA event behind it (``_fence``).  The fetch of N waits on
N's own event, which passes when N's forward ends, not on the stream,
where N+1's forward is queued behind it; so the pump packs and launches
N+2 while the device still runs N+1, and the device goes from one
forward to the next without waiting on the host.
``stats()['overlapped']`` counts the batches whose launch ended before the
previous batch's event passed.  On the CPU there is no fence and the
fetch is a plain copy.  All device work stays on the pump thread; callers
only touch numpy and futures.

With ``utils/tracing.py`` on, the server records each request's
``serve.queue`` span and each batch's ``serve.pack``, ``serve.h2d``,
``serve.forward`` and ``serve.fetch`` (the wait on the batch's fence)
spans, and the forward's device stages.

The default ``dtype`` is "bfloat16", the JAX server's default
(``Config.with_bf16()``'s mixed precision); "float32" is the parity path.
A bf16 server casts each request to bf16 on the host, before the pinned
copy, as the JAX server's transfer dtype does: the model's first op rounds
its input to bf16 anyway, so the answer is the same and the host-to-device
bytes halve.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hiddenpose_tpu_torch import as_dtype, resolve_device
from hiddenpose_tpu_torch.config import Config, t128_config
from hiddenpose_tpu_torch.models.nlospose import build_nlospose
from hiddenpose_tpu_torch.train.step import make_forward
from hiddenpose_tpu_torch.utils import tracing

_STOP = object()


class InferenceServer:
    """Turns single-capture requests into fixed-batch inference.

    Parameters
    ----------
    cfg : model/config preset (default: the t128 configuration).
    state_dict : model weights in the port's (reference PyTorch) naming,
        e.g. from ``utils.jax_bridge.state_dict_from_jax``; random weights
        from ``rng_seed`` when omitted.
    batch_size : the fixed batch every forward runs at.
    dtype : the activation compute dtype; 'bfloat16' is the serving
        default (as the JAX server's), 'float32' the parity path.
    max_wait_ms : how long the pump holds an open batch for more arrivals
        before flushing it padded.
    device : where the model runs; the GPU by default (raises without
        one), 'cpu' only when asked for.
    """

    def __init__(
        self,
        cfg: Optional[Config] = None,
        state_dict=None,
        *,
        batch_size: int = 8,
        dtype: str = "bfloat16",
        max_wait_ms: float = 5.0,
        rng_seed: int = 0,
        device="cuda",
    ):
        cfg = cfg if cfg is not None else t128_config()
        if dtype:
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, compute_dtype=dtype))
        self.cfg = cfg
        # the request's type on the wire: bf16 for a bf16 server
        self._transfer_dtype = (torch.bfloat16
                                if as_dtype(cfg.model.compute_dtype)
                                == torch.bfloat16 else torch.float32)
        self.batch_size = int(batch_size)
        self.max_wait = float(max_wait_ms) / 1000.0
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self.model, self.lct = build_nlospose(
            self.cfg.model, device=self.device, seed=rng_seed)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        t = self.cfg.model.time_size
        im = self.cfg.model.image_size[0]
        self._meas_shape = (1, t, im, im)
        self._forward = make_forward(self.model)
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._stats = dict(
            requests=0, batches=0, padded=0, errors=0, overlapped=0)
        self._closed = False
        self._pump = threading.Thread(
            target=self._run, name="hp-serve-pump", daemon=True)
        self._pump.start()

    # -- client API --------------------------------------------------

    def submit(self, meas: np.ndarray) -> Future:
        """Enqueue one capture; resolves to {'joints': (J, 3) np.float32}.

        Accepts (T, H, W) or (1, T, H, W) float measurement volumes."""
        if self._closed:
            raise RuntimeError("server closed")
        meas = np.asarray(meas, np.float32)
        if meas.ndim == 3:
            meas = meas[None]
        if meas.shape != self._meas_shape:
            raise ValueError(
                f"expected meas {self._meas_shape}, got {meas.shape}")
        fut: Future = Future()
        # with tracing on: the request's id and arrival, to which the pump
        # adds the moment it takes the request into a batch
        stamp = ([tracing.new_id(), tracing.now_ns()] if tracing.enabled()
                 else None)
        self._q.put((meas, fut, stamp))
        return fut

    def infer(self, meas: np.ndarray) -> Dict[str, np.ndarray]:
        """Synchronous convenience wrapper around submit()."""
        return self.submit(meas).result()

    def warmup(self) -> None:
        """Run the serving forward once (kernel build, cuDNN and cuFFT
        plans) so the first real request does not pay for it."""
        self.submit(np.zeros(self._meas_shape, np.float32)).result()

    def stats(self) -> Dict[str, float]:
        """Counters (requests, batches, padded slots, failed batches,
        batches launched while the previous one still ran on the device)
        and ``mean_fill``, the requests over the batches' slots."""
        with self._lock:
            s = dict(self._stats)
        s["mean_fill"] = (
            s["requests"] / (s["batches"] * self.batch_size)
            if s["batches"] else 0.0)
        return s

    def close(self) -> None:
        """Drain in-flight work and stop the pump (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._q.put(_STOP)
        self._pump.join(timeout=600)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- pump --------------------------------------------------------

    def _collect(self) -> Tuple[List, bool]:
        """Block for one request, then hold the batch open up to max_wait
        for more (draining whatever is already queued past the deadline).
        Returns (requests, stop_seen)."""
        first = self._q.get()
        if first is _STOP:
            return [], True
        reqs = [self._taken(first)]
        deadline = time.perf_counter() + self.max_wait
        while len(reqs) < self.batch_size:
            left = deadline - time.perf_counter()
            try:
                nxt = (self._q.get(timeout=left) if left > 0
                       else self._q.get_nowait())
            except queue.Empty:
                break
            if nxt is _STOP:
                return reqs, True
            reqs.append(self._taken(nxt))
        return reqs, False

    @staticmethod
    def _taken(req):
        """The queued request ``req``, its stamp (if traced) closed now."""
        if req[2] is not None:
            req[2].append(tracing.now_ns())
        return req

    def _fail(self, reqs, exc) -> None:
        with self._lock:
            self._stats["errors"] += 1
        for _, fut, _ in reqs:
            fut.set_exception(exc)

    def _fence(self, joints):
        """Queue the joints' copy to the host and the event that marks its
        end: (pinned host joints, event), or None on the CPU."""
        if not self._cuda:
            return None
        host = torch.empty(joints.shape, dtype=joints.dtype, pin_memory=True)
        host.copy_(joints, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host, event

    def _launch(self, reqs: List, pending=None):
        """Queue one padded batch on the device without a host sync.
        Returns (reqs, device joints, batch id, fence, overlapped), or
        None after failing the requests' futures.  ``pending``: the batch
        in flight; ``overlapped`` is whether its fence had not yet passed
        when this launch ended (counted with the batch, in ``_resolve``)."""
        bid = tracing.new_id()
        if tracing.enabled():
            for _, _, stamp in reqs:
                if stamp is not None:
                    tracing.record("serve.queue", stamp[1], stamp[2],
                                   id=stamp[0], parent=bid)
        try:
            with tracing.span("serve.pack", bid):
                meas = np.stack(
                    [m for m, _, _ in reqs]
                    + [reqs[-1][0]] * (self.batch_size - len(reqs)))
                x = torch.from_numpy(meas).to(self._transfer_dtype)
                if self._cuda:
                    x = x.pin_memory()
                with tracing.span("serve.h2d", bid, device=self._cuda):
                    x = x.to(self.device, non_blocking=self._cuda)
            with tracing.span("serve.forward", bid, device=self._cuda,
                              stages=True):
                joints, _ = self._forward(x, self.lct)
            fence = self._fence(joints)
            overlapped = (pending is not None and pending[3] is not None
                          and not pending[3][1].query())
        except Exception as e:  # launch failures resolve the futures
            self._fail(reqs, e)
            return None
        return reqs, joints, bid, fence, overlapped

    def _resolve(self, pending) -> None:
        reqs, joints, bid, fence, overlapped = pending
        n = len(reqs)
        try:
            # the batch's own fence, or on the CPU the copy itself
            with tracing.span("serve.fetch", bid):
                if fence is None:
                    joints = joints.cpu()
                else:
                    joints, event = fence
                    event.synchronize()
            # a copy: the answers alias no buffer the pump reuses
            joints = joints.numpy().astype(np.float32)
            # (B, J*3) flat (x, y, z) triplets -> (B, J, 3)
            joints = joints.reshape(self.batch_size, -1, 3)
        except Exception as e:  # execution faults surface at the fetch
            self._fail(reqs, e)
            return
        with self._lock:
            self._stats["requests"] += n
            self._stats["batches"] += 1
            self._stats["padded"] += self.batch_size - n
            self._stats["overlapped"] += overlapped
        for i, (_, fut, _) in enumerate(reqs):
            fut.set_result({"joints": joints[i]})

    def _drain_nowait(self, reqs: List) -> bool:
        """Top ``reqs`` up from requests already queued; True on _STOP."""
        while len(reqs) < self.batch_size:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                return False
            if nxt is _STOP:
                return True
            reqs.append(self._taken(nxt))
        return False

    def _run(self) -> None:
        pending = None
        stop = False
        while not stop:
            if pending is None:
                reqs, stop = self._collect()
            else:
                # Work in flight: take a batch only from requests already
                # waiting; else resolve the in-flight one first.
                reqs = []
                stop = self._drain_nowait(reqs)
            launched = self._launch(reqs, pending) if reqs else None
            if pending is not None:
                self._resolve(pending)
            pending = launched
        if pending is not None:
            self._resolve(pending)
        # resolve anything still queued after close()
        while True:
            reqs = []
            self._drain_nowait(reqs)
            if not reqs:
                return
            launched = self._launch(reqs)
            if launched is not None:
                self._resolve(launched)
