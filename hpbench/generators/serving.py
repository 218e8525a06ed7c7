"""What the serving generators share: the server under test, the pool of
captures, the bookkeeping of requests, and the check of every answer
against the plain reference.

The server is the program's ``serve.InferenceServer`` with the cell's
weights, batch size, wait and dtype.  A request is one (1, T, H, W)
float32 capture drawn, in an order made from the seed, from a pool of
captures made from the seed.  Each answer (a (J, 3) joint array) is held
against the plain float32 reference's joints of its capture: the number
compared is, over every answer, the largest median over its joints of
the distance from the reference's joint over the standard deviation of
the reference's heatmap logits for that joint (voxels a logit).  Rounding
moves a heatmap's logits in proportion to their scale, which the seed's
weights set, so the distance alone swings with the seed on sound runs;
over the scale it does not.
"""

from __future__ import annotations

import threading
import time
from typing import List

import numpy as np
import torch

from hpbench import inputs, program, roofline
from hpbench.reference import lct as ref_lct
from hpbench.reference import model as ref

# seconds past the window's close that a late answer is waited for
LATE_S = 60.0
# captures the reference runs at once
REF_CHUNK = 4


class Request:
    __slots__ = ("capture", "due", "sent", "done", "joints", "error")

    def __init__(self, capture: int, due: float):
        self.capture, self.due = capture, due
        self.sent = self.done = None
        self.joints = self.error = None


class Requests:
    """Submits captures of the pool to the server and records when each
    was due, sent and answered; ``on_done`` (optional) runs after each
    answer, on the thread that resolved it."""

    def __init__(self, server, pool: List[np.ndarray], order: np.ndarray,
                 on_done=None):
        self.server, self.pool, self.order = server, pool, order
        self.on_done = on_done
        self.lock = threading.Lock()
        self.all: List[Request] = []
        self.answered = 0
        self.all_done = threading.Condition(self.lock)

    def submit(self, due=None) -> Request:
        with self.lock:
            i = int(self.order[len(self.all) % len(self.order)])
            req = Request(i, due)
            self.all.append(req)
        req.sent = time.perf_counter()
        if req.due is None:
            req.due = req.sent
        try:
            fut = self.server.submit(self.pool[i])
        except RuntimeError as e:        # the server refused it
            self._finish(req, None, e)
            return req
        fut.add_done_callback(lambda f, r=req: self._resolved(f, r))
        return req

    def _resolved(self, fut, req: Request) -> None:
        exc = fut.exception()
        self._finish(req, None if exc else fut.result()["joints"], exc)

    def _finish(self, req, joints, exc) -> None:
        req.done = time.perf_counter()
        req.joints, req.error = joints, exc
        with self.lock:
            self.answered += 1
            self.all_done.notify_all()
        if self.on_done is not None:
            self.on_done(req)

    def wait_all(self, timeout: float) -> None:
        """Until every request sent is answered, or ``timeout`` s."""
        end = time.perf_counter() + timeout
        with self.lock:
            while self.answered < len(self.all):
                left = end - time.perf_counter()
                if left <= 0:
                    return
                self.all_done.wait(left)

    def wait_answered(self, n: int, timeout: float) -> None:
        end = time.perf_counter() + timeout
        with self.lock:
            while self.answered < n:
                left = end - time.perf_counter()
                if left <= 0:
                    raise RuntimeError(f"fewer than {n} answers in "
                                       f"{timeout} s")
                self.all_done.wait(left)


def setup(run) -> None:
    """The server with the cell's weights, the pool of captures, and a
    warm-up of full batches."""
    cfg, traffic = run.config, run.traffic
    s = cfg["serve"]
    n_pool = int(traffic["pool"])
    wseed, oseed, *cseeds = inputs.sub_seeds(run.seed, 2 + n_pool)
    run.weights = inputs.peaked_weights(template(cfg), wseed, run.device)
    run.pool_seeds = cseeds
    caps = inputs.captures(cseeds, cfg["model"], run.device)
    run.pool = [c.cpu().numpy() for c in caps]
    del caps
    run.order = np.random.RandomState(oseed).permutation(
        np.arange(4096) % n_pool)
    run.program = program.server(cfg, run.weights, run.device)
    run.model = run.program.model
    run.batch_size = int(s["batch_size"])
    run.calls_per_unit = roofline.serve_calls(cfg["model"],
                                              cfg["architecture"],
                                              run.batch_size)
    run.peak = "bf16" if s["dtype"] == "bfloat16" else "f32"
    warm = Requests(run.program, run.pool, run.order)
    for _ in range(2 * run.batch_size):
        warm.submit()
    warm.wait_all(600)
    failed = [r.error for r in warm.all if r.error is not None]
    if failed:
        raise RuntimeError(f"the warm-up failed: {failed[0]!r}")


def template(cfg) -> ref.NlosPose:
    """The reference model on the meta device: the names and shapes of
    the weights."""
    with torch.device("meta"):
        return ref.NlosPose(cfg)


def snapshot(run, key: str) -> None:
    run.window[key] = dict(stats=run.program.stats(),
                           launches=program.launch_counts())


def release(run) -> None:
    run.program.close()
    run.program = run.model = None


def reference_joints(run, precision: str = "float32"):
    """(pool, J, 3) joints of the plain reference on the pool's captures
    (made again from their seeds), with the products rounded to
    ``precision`` (the control's), and (pool, J) the standard deviation
    of each joint's heatmap logits."""
    from hpbench.reference.train import rounded

    cfg = run.config
    q = rounded(precision)
    with ref_lct.no_tf32(), torch.no_grad():
        m = ref.NlosPose(cfg).to(run.device)
        m.load_state_dict(run.weights)
        m.eval()
        lct = ref_lct.LCT(cfg["model"], run.device)
        joints, sd = [], []
        for i in range(0, len(run.pool_seeds), REF_CHUNK):
            caps = inputs.captures(run.pool_seeds[i:i + REF_CHUNK],
                                   cfg["model"], run.device)
            heat, _ = ref.forward(m, caps, lct, q)
            joints.append(ref.soft_argmax(heat).reshape(
                caps.shape[0], -1, 3).cpu().numpy())
            sd.append(heat.flatten(2).std(2).cpu().numpy())
            del heat
        del m, lct
    return np.concatenate(joints), np.concatenate(sd).astype(np.float64)


def joint_gap(answers, want: np.ndarray, sd=None) -> float:
    """Over ``answers`` ((capture, joints or None) pairs), the largest
    median over an answer's joints of the distance (voxels) from the
    reference's joint, over that joint's heatmap logit s.d. ``sd`` where
    given: bf16 rounding moves most joints a fraction of a voxel and
    flips the odd joint between two near-equal heatmap peaks (which the
    median ignores); a wrong answer moves most joints.  A missing or
    non-finite answer reads inf."""
    worst = 0.0
    for cap, joints in answers:
        if joints is None:
            return float("inf")
        d = np.linalg.norm(np.asarray(joints, np.float64) - want[cap], axis=-1)
        if sd is not None:
            d = d / sd[cap]
        if not np.isfinite(d).all():
            return float("inf")
        worst = max(worst, float(np.median(d)))
    return worst


def check(run, answered) -> list:
    """[(name, number, limit)] over the answers ``answered``, for each
    number the configuration limits."""
    want, sd = reference_joints(run)
    answers = [(r.capture, r.joints) for r in answered]
    got = {"joint_err_median_per_sd": joint_gap(answers, want, sd),
           "joint_err_median_voxels": joint_gap(answers, want)}
    run.note(f"answers checked: {len(answered)} of {len(run.pool)} "
             f"captures; heatmap logit s.d. {sd.min():.6g}-{sd.max():.6g}; "
             + ", ".join(f"{k} {v:.6g}" for k, v in got.items()))
    return [(k, got[k], lim)
            for k, lim in run.config["limits"]["serve"].items()]


def flop_per_capture(run) -> int:
    """FLOP of one capture's forward, counted on the plain reference on
    the meta device."""
    cfg = run.config
    m = cfg["model"]
    with torch.device("meta"):
        net = ref.NlosPose(cfg)
        lct = ref_lct.LCT(m, "meta")
        x = torch.empty(1, m["in_channels"], m["time_size"],
                        *m["image_size"])
    with torch.no_grad():
        return roofline.count_flop(lambda: ref.forward(net, x, lct))
