"""Smoke test of the PyTorch/CUDA port (hiddenpose_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a host with an NVIDIA H100.  Phases,
each printing what it did; any failure exits non-zero before the result
lines:

1. toolchain: torch, CUDA, the card (compute capability must be 9.0),
   nvcc, and the card's name and power limit from nvidia-smi;
2. build: the kernels of ``hiddenpose_tpu_torch/csrc`` with nvcc, one
   process per source, all at once;
3. kernels vs plain: each kernel against its plain PyTorch version at the
   t128 batch-2 shapes of the inference path and of the train step
   (TF32 off), error and time; K2, K4 and K4-dx (three TF32 passes on the
   tensor cores) also against a float64 conv of the same inputs, where the
   kernel's error may be at most twice the plain f32 version's, and at
   ragged shapes the serving path never gives them; K2's row of the path
   twice for bit-identical results and beside its library conv, where it
   may take at most 1.1 times as long, and every K8 row likewise (exact
   against the library's backward, an odd extent on every axis off the
   path); K9's f32 rows (three
   TF32 passes at head dim 32) likewise against a float64 attention; every
   K1 and K5 row of the path twice for bit-identical results and beside
   its library call (medians of 20 readings each, taken in turns), where
   it may take at most 1.1 times as long, and K1 and K5 at ragged volumes
   off the path (zero and edge padding, channel counts that fill no
   channel block, the pre-affine before the zero padding);
4. serve: ``InferenceServer(t128_config(), batch_size=2, dtype="float32",
   device="cuda:0")`` answers 9 synthetic captures (a padded tail batch),
   with every serving kernel's launch count as expected afterwards, and a
   capture served alone equals the same capture served in a batch;
5. end to end: one batch through the kernels and through the plain
   versions on the same weights; heatmaps and joints must agree;
6. train: the t128 model at full width in training mode takes 3 Adam
   steps (``make_train_step``) on ``make_batch([0, 1])``, each loss finite,
   with every train-path kernel launched the expected number of times;
   then one step with the kernels and one with the plain versions from
   the same weights and batch must agree in loss, gradients, new running
   statistics and new parameters; beside it, the plain step on a
   measurement moved by 1e-7 shows how far rounding alone moves the
   gradients; last, forward and backward ms and peak memory, kernels and
   plain in turns;
7. sformer: ``build_sformer(t128_config().model, dtype="float32")`` at full
   width (dim 256, depth 8, 8 heads of 32) answers a real-data-shaped
   (1, 128, 1, 128, 128) video a few times: the attention kernel launches
   exactly 16 times a forward (the joint-token read and the grouped
   attention of each layer), logits and ``simdr_decode`` joints are
   finite, spread across joints and videos, and depend on the rotary
   tables; kernels and plain versions on the same weights must agree; ms
   per capture and peak memory of each; then the bfloat16 mode's ms, peak
   memory and distance from the float32 logits;
8. probes: the four stem probes of ``scripts/torch_diag_stem_paired.py``;
   each probe's launch is also timed alone, into preallocated outputs
   (medians of 20 readings); the dot probe's beside ``torch.matmul`` into
   one (taken in turns), and may take at most 1.1 times as long;
9. serve bf16: the bfloat16 model's kernels (K1-bf16, K2-bf16, K3-bf16,
   K4-bf16) against their plain versions at the path's shapes and off it:
   within one bf16 ulp of each output (K3 exact), two calls bit for bit,
   K2-bf16 and K4-bf16 in their f32-output form against float64 (at most
   F64_ERR_FACTOR times the library f32 conv's error on the widened
   operands); every K1-bf16, K2-bf16 and K4-bf16 row of the path beside
   its library call (``F.conv3d`` on the same bf16 tensors), medians of 20
   readings each, taken in turns, where it may take at most 1.1 times as
   long (K4-bf16 at c128 and c256: ``K4_BF16_SLOWER``, the ratio
   measured), and each K2-bf16 and K4-bf16 row's share of its bound; then
   ``InferenceServer(t128_config(), batch_size=2, dtype="bfloat16",
   device="cuda:0")``, the JAX server's default, answers
   phase 4's 9 captures on the same weights: volumes/s, p50 latency, each
   bf16 kernel's launch count, the device's idle share over a second burst
   under ``torch.profiler``; one batch with the kernels and one with the
   plain versions must agree, the heatmaps of a float32 model on the same
   weights and the joints of phase 4's float32 server must lie within the
   stated tolerances, and a capture served alone must equal the same
   capture served in a batch; last, the same server at batch 8 (the JAX
   server's default batch) answers 16 requests, two full batches: its
   volumes/s, p50, launch counts, and its joints against the batch-2
   server's;
10. train precision: K4-dx-bf16's rows, then the train step at the JAX
   package's default precision ('default'), at 'high' and in bfloat16
   (see ``phase_train_precision``);
11. train loop: (a) ``train()`` at t128 'default' from the peaked weights,
   two epochs of two steps over ``SyntheticSource(length=8)`` with 4
   loader worker processes, ``log_every=1``, ``ckpt_every_iters=3``: every
   loss finite, 4 'Train Loss' records, checkpoints iter_3, epoch_0 and
   epoch_1, each loop kernel launched 4 x its 'default' per-step count;
   the loop's ms a step beside phase 10's bare step, the loader wait, each
   checkpoint's save ms and size; (b) epoch_1 restored into a fresh state
   equals the live state bit for bit (and epoch_0 its file), and a resume
   from epoch_0 under deterministic algorithms repeats (a)'s first loss of
   epoch 1 within TRAIN_LOSS_TOL; (c) one step with (a)'s autoencoder
   loaded and frozen: its tensors bit-identical and without optimizer
   state, every other tensor moved; (d) ``evaluate()`` over 4 captures:
   finite MPJPE / PA-MPJPE / PCK, joints within BATCH_TOL of
   ``make_forward``, volumes/s; (e) ``python -m
   hiddenpose_tpu_torch.cli.train`` then ``.cli.test`` as processes of
   their own: exit 0, the test restoring epoch_0 and printing an MPJPE.
   ``python3 chip_smoke.py --loop`` runs phases 1, 2 and 11 alone (phase
   11 then times its own bare steps), ``--alt`` phases 1, 2 and 12;
12. alt objectives (``train/alt_steps.py``), f32, TF32 off, the
   comparisons under deterministic algorithms: (a) the SimDR step on the
   full-width Sformer (phase 7's model, weights and video, bins from a
   seed): 3 steps at 'highest' and one at 'default', ms by CUDA events,
   peak memory, K9 launched 16 times a step (forward through
   ``AttendFused``, backward the plain attention); one step with kernels
   vs one with the plain attention within SIMDR_* and phase 6's parameter
   limits; (b) the ``posenet2d`` NlosPose at t128 b2 on peaked weights:
   the serving forward (K1 only) kernels vs plain within phase 5's limits,
   once the joints spread; two ``make_train_step`` steps (K1, K5, K6, K8
   a step as the 3D model's FeatureExtraction and UNet); one step
   kernels vs plain, cut at visible_net's output with the 2D net's
   cotangent shared within phase 6's TRAIN_* limits, whole within
   POSENET2D_* (its 2D net amplifies any move of its input), beside the
   plain step's spread under three 1e-7 moves of the measurement; (c)
   ``make_heatmap3d_step`` on the t128 posenet3d_50 model: one step
   (TRAIN_PER_STEP launches), kernels vs plain within TRAIN_*, its loss
   equal to ``make_train_step``'s joint loss; (d) TokenPose at its
   published config: the 2D-heatmap step on the GPU (3 timed) against
   the same step on the CPU within TOKENPOSE_TOL (library ops only);
13. models: (a) the SimDR step on phase 7's Sformer in the bf16 mode: 3
   steps at 'highest' and one at 'default', ms, peak memory, K9 launched
   16 times a step; K9 against its order in plain PyTorch (equal outputs
   at BF16_K9_ORDER_EQUAL of the elements); one step with kernels vs one whose plain attention rounds where
   K9 rounds, within BF16_SIMDR_SPREAD x that plain step's own spread
   under three 1e-7 moves of the video (the step through ``attend_ref``
   printed beside it); (b) ``PoseNet3D(block="basic", layers=(2, 2, 2, 2))`` at full
   width on a t128 b2 volume, peaked weights: the f32 and bf16 serving
   forwards kernels vs plain within phase 5's limits and phase 9's
   heatmap limit once the joints spread, the bf16 joints within
   BASIC_BF16_JOINTS x the plain bf16 forward's distance from f32 (K2, K3
   and K4 10 times a forward; their bf16 forms),
   one train forward + backward at 'highest' with a shared cotangent
   within phase 6's TRAIN_* (K3, K7, K4 and K4-dx 10 times each), and one
   forward with the library stem (``conv1_t_stride=2``, ``no_max_pool``);
   (c) DeepVoxels at the reference's size (``build_deepvoxels()``: a (1, 1,
   512, 256, 256) capture -> (1, 17, 200, 128, 128)): ms, peak memory, and
   the forward against the same forward in float64 on the card; (d)
   ``MultiViewResampler`` and ``wave_convolve`` on its output, card vs
   CPU.  ``python3 chip_smoke.py --models`` runs phases 1, 2 and 13 alone.

Phase 3 also times, beside each kernel, the one PyTorch call that computes
the same function where there is one (``library_ms``: a yardstick, used
nowhere in the port), and computes the kernel's bound: the larger of its
bytes (each input read once, each output written once) over the card's
memory rate and its operations over the card's peak rate for their type
(``BANDWIDTH``, ``PEAK`` below).

The comparisons of phases 3-5 run with
``torch.use_deterministic_algorithms(True)``, so a reading does not move
from run to run; phase 6's with ``warn_only=True`` (the backward of the
UNet's trilinear resize and replicate pad have no deterministic CUDA
version).  Every timed run keeps the libraries' default algorithms.

Then one JSON line of per-kernel results, the nvidia-smi line, and the
last line ``{"ok": true, "device": {...}}``.  Detailed per-shape results
go to ``chiprun_out/chip_smoke.json``.  Imports no JAX.

At its end, passed or failed, the script stops the data loader's fork
server and resource tracker and kills whatever child is left, the
processes of a command's loader included (it is their subreaper), so no
process it started outlives it.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import subprocess
import sys
import time
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
B = 2  # the serving batch

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at the full
# 700 W limit): device memory bytes/s, and FLOP/s by operand type.  f32
# means fp32 FMA outside the tensor cores; tf32 the tensor cores' rate, at
# which K4, K4-dx and K9 at head dim 32 run every f32 product three times
# (3xTF32, never one pass).  The port's other f32 kernels never use TF32.
BANDWIDTH = 3.35e12
PEAK = {"f32": 67e12, "bf16": 989e12, "tf32": 495e12}

# Tolerances, kernel vs plain, both f32 with TF32 off: they differ only in
# summation order, a few ulps of the output scale.  Max-pool selects
# values and must match exactly.
CONV_TOL = 1e-4     # max |kernel - plain| / max |plain|
# K4, K4-dx, K6 and K9 against a float64 version of the same inputs: the
# kernel's max error may be at most this many times the plain f32 version's
# (cuDNN or cuBLAS, TF32 off), both read in the same call, or one f32 ulp
# of the largest output (2^-23 of it) where that is more: below an ulp the
# two errors are the roundings of single outputs, and their ratio is chance.
# One-pass TF32 would read about 100 times, a dropped cross term about 10.
F64_ERR_FACTOR = 2.0
E2E_HM_TOL = 1e-4   # heatmaps, max |kernel - plain| / max |plain|
# Joints, max abs error in heatmap voxels.  The kernels sum in another
# order than cuDNN: the heatmaps differ by a few 1e-6 of their peak, and
# the peaked soft-argmax turns that into about 1e-3 voxel.  The reading is
# deterministic (same weights, inputs and algorithms every run).
E2E_JOINT_TOL = 1e-2
# Joints, served alone vs in a batch, voxels.  Eval BatchNorm, GroupNorm
# and the FFT are per sample, so with deterministic algorithms a request's
# result does not depend on its batch-mate.
BATCH_TOL = 1e-4
# The stem pool's VJP: the kernel sums as the autograd of the plain chain
# does (powers-of-two weights, two-term sums), so it is expected exact;
# the tolerance is the contract's 2 ulp of the largest cotangent.
VJP_ULPS = 2
# Phase 6, one train step with kernels vs with plain versions, same
# weights and batch (the readings of the first chip run are in PERF.md):
TRAIN_LOSS_TOL = 1e-4        # relative, each of the three losses
TRAIN_STATS_TOL = 1e-3       # new running stats, max err / max abs
TRAIN_GRAD_L2_TOL = 0.05     # gradients, relative L2 over each module
TRAIN_PARAM_TOL = 1e-6       # new params where the two gradients agree
TRAIN_SIGN_AGREE = 0.99      # share of large gradient elements of one sign
# K9, kernel vs plain, |got - want| <= atol + rtol * |want|: f32 both sides
# (three TF32 passes with f32 sums, or fp32 FMA off head dim 32, vs cuBLAS
# f32), differing in summation order and in the online softmax's rescaling.  With a bf16 v both round the output to bf16, so
# they may differ by one bf16 ulp, at most 2^-7 of the value; the atol
# covers outputs near zero, where the differently rounded probabilities
# (about 1e-4 at these shapes) outweigh an ulp.  A typical output at the
# full shape is 0.05: dropped keys or a ragged tail would show.
ATTN_F32_TOL = (1e-5, 2e-6)
ATTN_EXTREME_TOL = (1e-5, 1e-5)
ATTN_BF16_TOL = (2.0 ** -7, 1e-3)
# Head dim 32 with logits of a few hundred: an f32 score carries an error of
# 3e-5 (one ulp of 400), which exp() turns into that relative error of a
# weight, so the plain f32 version itself errs about 6e-5 against float64
# there; the row is held to the float64 limit above all.
ATTN_LARGE_LOGITS_TOL = (1e-4, 1e-4)
# Phase 7, the Sformer with kernels vs a forward whose attention is taken
# in float64, same weights and video: the logits' max error over their max
# (the plain f32 forward is held to nothing: its joint-token read sums
# 131 096 values a row in one f32 chain and sits 1.5e-4 from that forward,
# so kernels vs plain may read SFORMER_TOL plus that), and the decoded
# joints, kernels vs plain, in bins (image units x 2).  In the bf16 mode a
# one-ulp difference of K9's bf16 output passes through the bf16 Dense
# layers of up to 8 layers.  The
# bf16 mode against the f32 logits differs by bf16's rounding at every
# Dense, which the peaked weights amplify: a few times the first reading
# (8.7e-3 of the max).
SFORMER_TOL = 1e-4
SFORMER_JOINT_TOL = 0.05
SFORMER_BF16_KERNELS_TOL = 1e-2
SFORMER_BF16_TOL = 3e-2
# per layer the joint-token read and the grouped attention
SFORMER_LAUNCHES_PER_FORWARD = 16
# Phase 3: a K1, K2, K5 or K8 call of the path may take this many times its
# library call's time (``F.conv3d``, ``conv3d_input``, the autograd of
# ``F.max_pool3d``), medians of LIBRARY_READINGS readings each, taken in
# turns; phase 9 likewise for K1-bf16, K2-bf16 and K4-bf16 (``F.conv3d`` in
# bf16)
CONV3P_SLOWER = 1.1
LIBRARY_READINGS = 20
# Phase 9, K4-bf16 against cuDNN's bf16 conv on the same tensors, by
# channels (c64 @64^3, c128 @32^3, c256 @16^3), medians as above.  The
# halo-staged design reaches 1.1 at c64 only: in its final form its ratios
# read 0.77-0.80, 1.07-1.12 and 1.17-1.24 (scripts/torch_bf16_conv_ab.py,
# NVIDIA H100 80GB HBM3, 700 W; PERF.md), so the two wider shapes are held
# at the ratio measured plus about a tenth, not at the target.
K4_BF16_SLOWER = {64: CONV3P_SLOWER, 128: 1.2, 256: 1.35}
# Phase 10, one train step with kernels vs one with plain versions, same
# weights and batch, at 'default' (the plain versions' library convs then
# take TF32 where K1, K5 and K6 sum in f32) and in the bf16 model (both
# round to bf16 at the same places, but an output near a rounding boundary
# rounds the other way), under deterministic algorithms.  Both steps are
# chaotic at t128: a TF32 or bf16 rounding flips ReLU masks and max-pool
# winners, so their gradients lie 0.7 (f32) and 1.3 (bf16) apart by
# relative L2 where phase 6's 'highest' step reads 0.02; the losses, the
# statistics and the signs of the large gradient elements say more.  The
# limits are twice the first reading (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md): f32 loss 1.11e-4, gradients 0.72, statistics 2.62e-3, 7.0% of
# large gradient elements of the other sign; bf16 loss 6.16e-4,
# gradients 1.28, statistics 2.10e-2, 21% of large gradient elements of
# the other sign.  The sign floors fail a zeroed backward (no element of
# one sign) or a negated one (the other sign's share).
DEFAULT_LOSS_TOL = 2.3e-4
DEFAULT_GRAD_L2_TOL = 1.5
DEFAULT_STATS_TOL = 5.3e-3
DEFAULT_SIGN_AGREE = 0.86
BF16_TRAIN_LOSS_TOL = 1.3e-3
BF16_TRAIN_GRAD_L2_TOL = 2.6
BF16_TRAIN_STATS_TOL = 4.2e-2
BF16_TRAIN_SIGN_AGREE = 0.58
# DEFAULT_AWAY: the 'default' step's gradients must lie from phase 6's
# 'highest' step more than this many times that step's own spread (its
# plain versions on a measurement moved by 1e-7), in every module (read:
# 19-39 times).  BF16_TRAIN_AWAY: the bf16 step's losses and statistics
# must lie from the f32 'default' step's at least this many times as far
# as that step's kernels lie from its plain versions (read: 18.8 and 11.2
# times), so that an f32 path posing as bf16 fails; its gradients cannot
# tell (1.7 times: both sides are chaotic).
DEFAULT_AWAY = 1.0
BF16_TRAIN_AWAY = 5.0
# Phase 8: the dot probe's launch may take this many times torch.matmul's
PROBE_DOT_SLOWER = 1.1
DOT_PROBE_TOL = 1e-5
# Phase 9, the bf16 kernels against their plain versions (the bf16
# operands widened, the f32 op, one rounding): each output within one bf16
# ulp of the plain one, plus this much of the largest output, where sums
# that cancel near zero leave an ulp smaller than the f32 sums' own
# difference.  K3 selects values and must match exactly.
BF16_ATOL = 2.0 ** -16
# The bf16 model end to end (``bf16_e2e``): its forward with the kernels,
# with the plain versions, and a float32 model's on the same weights and
# the same bf16-valued captures, over BF16_E2E_CAPTURES captures in
# batches of B.  Every kernel output is within an ulp of its plain
# version's, but an output whose f32 sum lies near a rounding boundary
# rounds the other way, and the next layers carry such ulps on as bf16
# noise.  The peaked weights make heatmap logits of up to about 190 (phase
# 5), where a bf16 ulp is 1.0, so a largest difference reads a few ulps of
# the top logit whatever the path, and a joint whose heatmap has two
# near-equal peaks moves by voxels when one logit moves by an ulp: the
# heatmaps are held by the RMS of their difference over the reference's
# RMS, the joints by their mean distance.  The upper limits are about
# twice the largest reading of one batch over 3 weight seeds x 4 batches
# (``scripts/torch_bf16_spread.py``; NVIDIA H100 80GB HBM3, 700 W;
# PERF.md).  Kernels vs plain: heatmap RMS 1.012e-2 to 1.085e-2, joints
# mean 0.246 to 0.833 voxels.  The two bf16 forwards lie as far apart as
# each lies from f32 (the kernels' one-ulp rows above hold them closely);
BF16_E2E_CAPTURES = 8
BF16_KP_HM_RMS_TOL = 2.2e-2
BF16_KP_JOINT_MEAN_TOL = 1.7
# the bf16 forward against the float32 one: heatmap RMS 1.057e-2 to
# 1.152e-2, joints mean 0.221 to 0.943 voxels (the joint limit also holds
# the bf16 server's joints of phase 4's 9 captures against the float32
# server's, and batch 8's against batch 2's, two bf16 forwards whose
# library convs may take other algorithms).
BF16_VS_F32_HM_RMS_TOL = 2.3e-2
BF16_JOINT_MEAN_TOL = 1.9
# The lower limits say that the path rounds where the JAX contract does,
# so that an f32 path posing as bf16 fails: the f32 heatmaps rounded once
# to bf16 lie some RMS from f32 (an f32 path that rounds only its output
# lies just that far); the bf16 forward with its kernels must lie at least
# BF16_AWAY_ROUNDED times as far, and at least BF16_AWAY_PLAIN times as
# far as the bf16 forward with the plain versions does.  Readings: 6.36 to
# 6.95 times the rounded-once RMS (1.656e-3 to 1.663e-3), and 0.997 to
# 1.004 times the plain versions' distance.
BF16_AWAY_ROUNDED = 3.0
BF16_AWAY_PLAIN = 0.5


@contextlib.contextmanager
def deterministic(warn_only: bool = False):
    """cuDNN's and cuBLAS's deterministic algorithms, for the comparisons
    only.  (cuDNN's default transposed conv, the head's deconvs,
    accumulates with atomics: two runs of one batch differ in the last
    bits of the heatmaps.)  ``warn_only`` lets ops that have no
    deterministic CUDA version run as they are, silently."""
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def log(msg: str) -> None:
    print(msg, flush=True)


def adopt_orphans() -> None:
    """Make this process the parent of every process its descendants leave
    behind (Linux's child subreaper), so that :func:`stop_children` finds
    them: a command's loader workers, say, if the command ends first."""
    import ctypes

    PR_SET_CHILD_SUBREAPER = 36
    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_CHILD_SUBREAPER, 1,
                                                0, 0, 0)


def stop_children() -> list:
    """Stop every process this one started that is still running: the data
    loader's fork server and resource tracker (stopped and waited for),
    then any other child, adopted orphans included (killed and reaped).
    Returns the killed pids."""
    from hiddenpose_tpu_torch.data.dataset import stop_worker_server

    stop_worker_server()
    me, killed = str(os.getpid()), []
    for _ in range(10):  # a killed child's own children are adopted next
        found = []
        for stat in Path("/proc").glob("[0-9]*/stat"):
            try:  # "pid (comm) state ppid ...": comm may hold spaces
                ppid = stat.read_text().rsplit(")", 1)[1].split()[1]
            except (OSError, IndexError):
                continue
            if ppid == me:
                found.append(int(stat.parent.name))
        if not found:
            break
        for pid in found:
            with contextlib.suppress(ProcessLookupError, ChildProcessError):
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
            killed.append(pid)
    return killed


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_toolchain() -> str:
    from hiddenpose_tpu_torch.ops.kernels import _build

    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    log(f"[1 toolchain] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} capability {cap} count {torch.cuda.device_count()}")
    if cap != (9, 0):
        raise RuntimeError(f"needs compute capability (9, 0), got {cap}")
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    for line in nvcc.stdout.strip().splitlines()[-2:]:
        log("[1 toolchain] " + line)
    smi = smi_line()
    log(f"[1 toolchain] nvidia-smi: {smi}")
    return smi


def phase_build() -> None:
    from hiddenpose_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"[2 build] {len(_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    for line in _build.build_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            log("[2 build] " + line.strip())


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, ops):
    """The least time (ms) the card could take: ``nbytes`` over its memory
    rate, or ``ops`` ([(FLOP, operand type), ...]) over its peak rates,
    whichever is larger, and which."""
    by_bytes = nbytes / BANDWIDTH * 1e3
    by_ops = sum(f / PEAK[t] for f, t in ops) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def attention64(q, k, v):
    """softmax(q k^T) v in float64, 64 groups at a time."""
    return torch.cat([
        torch.softmax(torch.bmm(q[i:i + 64].double(),
                                k[i:i + 64].double().transpose(1, 2)),
                      dim=-1) @ v[i:i + 64].double()
        for i in range(0, q.shape[0], 64)])


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def compare(name, kernel_fn, plain_fn, iters, exact=False, atol=None,
            rtol_atol=None, library_fn=None, moved=0, ops=(), tag="3 kernels",
            f64_fn=None, repeats=False, slower=None, bf16_ulp=False):
    """Error and times (plain, kernel, kernel, plain) of one call shape.
    The kernel's result must be exact (``exact``), within ``atol``, within
    ``rtol_atol`` element by element, within one bf16 ulp of each output
    plus BF16_ATOL of the largest (``bf16_ulp``), or within CONV_TOL of the
    plain result's max; a tuple result (dk, db) is compared part by part.
    ``library_fn`` is the one PyTorch call for the same function, timed
    only; ``moved`` (bytes) and ``ops`` give the bound.  ``f64_fn`` gives
    the same function in float64 (a tuple for a tuple result): the kernel's
    max error against it, over all parts, may be at most F64_ERR_FACTOR
    times the plain version's (or one f32 ulp of the plain result's
    max).  ``repeats``: a second call must give the same bits.  ``slower``:
    the kernel's time may be at most this many times ``library_fn``'s,
    medians of LIBRARY_READINGS readings of ``iters`` launches each, taken
    in turns."""
    with deterministic(warn_only=True):
        got = kernel_fn()
        want = plain_fn()
        torch.cuda.synchronize()
        if repeats and not torch.equal(got, kernel_fn()):
            raise RuntimeError(f"{name}: two calls differ")
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    pairs = [(g_.float(), w_.float()) for g_, w_ in pairs]
    err = max((g - w).abs().max().item() for g, w in pairs)
    scale = max(w.abs().max().item() for _, w in pairs)
    finite = all(bool(torch.isfinite(g).all()) for g, _ in pairs)
    if exact:
        ok = err == 0.0
    elif bf16_ulp:
        from hiddenpose_tpu_torch.ops.kernels import bf16_ulp_excess

        ok = finite and all(
            bf16_ulp_excess(g, w, BF16_ATOL * w.abs().max().item()) <= 0.0
            for g, w in pairs)
    elif atol is not None:
        ok = finite and err <= atol
    elif rtol_atol is not None:
        ok = finite and all(bool(
            ((g.float() - w.float()).abs()
             <= rtol_atol[1] + rtol_atol[0] * w.float().abs()).all())
            for g, w in pairs)
    else:
        ok = finite and all(
            (g - w).abs().max().item() <= CONV_TOL * max(
                w.abs().max().item(), 1e-30) for g, w in pairs)
    err64 = None
    if f64_fn is not None:
        want64 = f64_fn()
        want64 = want64 if isinstance(want64, tuple) else (want64,)
        got_p, want_p = ((got, want) if isinstance(got, tuple)
                         else ((got,), (want,)))
        # the largest error over the parts (dk, db), each side
        err64 = tuple(max((t.double() - w64).abs().max().item()
                          for t, w64 in zip(side, want64))
                      for side in (got_p, want_p))
        del want64
        ok = ok and err64[0] <= max(F64_ERR_FACTOR * err64[1],
                                    2.0 ** -23 * scale)
    p1 = cuda_ms(plain_fn, iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, iters)
    lib = cuda_ms(library_fn, iters) if library_fn is not None else None
    bound_ms, bound_by = bound(moved, ops)
    res = dict(shape=name, max_abs_err=err, max_abs_ref=scale,
               ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=lib,
               bound_ms=bound_ms, bound_by=bound_by)
    log(f"[{tag}] {name}: max_abs_err {err:.3e} (ref max {scale:.3e}) "
        f"kernel {res['ms']:.4f} ms plain {res['plain_ms']:.4f} ms library "
        f"{'none' if lib is None else format(lib, '.4f') + ' ms'} bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    if err64 is not None:
        res.update(err_vs_f64=err64[0], plain_err_vs_f64=err64[1])
        log(f"[{tag}] {name}: max abs err against float64: kernel "
            f"{err64[0]:.3e}, plain f32 {err64[1]:.3e} (limit "
            f"{F64_ERR_FACTOR:g} x plain)")
    if not ok:
        raise RuntimeError(f"{name}: kernel disagrees with plain version")
    if slower is not None:
        reads = {"kernel": [], "library": []}
        for _ in range(LIBRARY_READINGS):
            reads["kernel"].append(cuda_ms(kernel_fn, iters))
            reads["library"].append(cuda_ms(library_fn, iters))
        res["ms_median"] = float(np.median(reads["kernel"]))
        res["library_ms_median"] = float(np.median(reads["library"]))
        log(f"[{tag}] {name}: medians of {LIBRARY_READINGS}: kernel "
            f"{res['ms_median']:.4f} ms, library {res['library_ms_median']:.4f}"
            f" ms (limit {slower} x)")
        if res["ms_median"] > slower * res["library_ms_median"]:
            raise RuntimeError(
                f"{name}: the kernel takes {res['ms_median']:.4f} ms, more "
                f"than {slower} x its library call's "
                f"{res['library_ms_median']:.4f} ms")
    return res


# K1 call shapes of one t128 forward: (c_in, c_out, extent, pad, act,
# residual, count per forward, input needs a gradient in training, bias).
# FeatureExtraction at 128^3, then the UNet level by level (its convs are
# followed by GroupNorm: act none).  In a train step each call also runs
# K6 (dk, db) and, where its input needs a gradient, K5 (dx): the
# measurement fed to conv_in and to the corner conv needs none.
K1_SHAPES = [
    (1, 1, 128, "edge", "none", False, 1, False, True),   # FE conv_in
    (1, 1, 128, "edge", "leaky", False, 2, True, True),   # ResConv3D conv1
    (1, 1, 128, "edge", "leaky", True, 2, True, True),    # ResConv3D conv2
    (1, 1, 128, "zero", "none", True, 1, False, False),   # corner + branch
    (1, 4, 128, "zero", "none", False, 1, True, True),    # UNet conv
    (4, 4, 128, "zero", "none", False, 2, True, True),    # conv, dec4
    (4, 8, 64, "zero", "none", False, 1, True, True),     # enc1
    (8, 8, 64, "zero", "none", False, 1, True, True),
    (8, 16, 32, "zero", "none", False, 1, True, True),    # enc2
    (16, 16, 32, "zero", "none", False, 1, True, True),
    (16, 32, 16, "zero", "none", False, 1, True, True),   # enc3
    (32, 32, 16, "zero", "none", False, 1, True, True),
    (32, 32, 8, "zero", "none", False, 2, True, True),    # enc4
    (64, 16, 16, "zero", "none", False, 1, True, True),   # dec1
    (16, 16, 16, "zero", "none", False, 1, True, True),
    (32, 8, 32, "zero", "none", False, 1, True, True),    # dec2
    (8, 8, 32, "zero", "none", False, 1, True, True),
    (16, 4, 64, "zero", "none", False, 1, True, True),    # dec3
    (4, 4, 64, "zero", "none", False, 1, True, True),
    (8, 4, 128, "zero", "none", False, 1, True, True),    # dec4
]
# Rows (indexes into K1_SHAPES) whose conv the bf16 model runs on an f32
# input, so through the f32 K1, as the JAX kernel takes it: the UNet's
# first conv (on the f32 normalised feature) in serving and training, and
# the FeatureExtraction's first conv (on the f32 measurement; the servers
# send bf16) in training.
K1_F32_INPUT_SERVE = (4,)
K1_F32_INPUT_TRAIN = (0, 4)
# K1 and K5 off the path, one capture: (c_in, c_out, (D, H, W), pad, the
# pre-affine's ReLU or None), with residual and leaky: extents that no tile
# divides, channel counts that fill no channel block.  The pre-affine row
# holds K1 to the plain version over the whole volume: the affine precedes
# the zero padding.
K1_RAGGED = [(cin, cout, dhw, pad, None)
             for dhw in ((5, 6, 7), (9, 17, 33))
             for pad in ("zero", "edge")
             for cin, cout in ((1, 1), (3, 5), (20, 12))]
K1_RAGGED.append((3, 5, (9, 17, 33), "zero", True))
# The stem's input extent on the path (t128: 128^3); K3 pools its output.
STEM_N = 128
# K4 call shapes: (width, extent, stride-1 blocks per forward); in a train
# step each block also runs K4-dx once.
K4_SHAPES = [(64, 64, 3), (128, 32, 3), (256, 16, 5)]
# K4 and K4-dx off the path: one capture, extents that no tile divides
# (width, (D, H, W)), with and without the epilogue.
K4_RAGGED = [(64, (5, 6, 7)), (128, (5, 6, 7))]
# K2 off the path, one capture: extents that the kernel's 8 x 16 tiles and
# 32-plane work units do not divide, each with and without ReLU.
K2_RAGGED = [(5, 6, 7), (9, 17, 33), (12, 20, 36)]
# K8: the UNet's four pools, (channels, extent of the pool's input); off the
# path an odd extent on every axis.
POOL2_SHAPES = [(4, 128), (8, 64), (16, 32), (32, 16)]
POOL2_ODD = (1, 3, 5, 7, 9)
# K1 launches of one t128 forward.  In a train step FeatureExtraction and
# the UNet run their forward twice, the second time in the backward
# (``cfg.stage_remat``, the default: ``utils/remat.py``), so K1
# launches STAGE_RUNS times its forward count; K5, K6 and K8 (backward)
# once.
K1_PER_FORWARD = sum(r[6] for r in K1_SHAPES)
STAGE_RUNS = 2
# Launches of each kernel in one t128 train step, by the shapes above.
TRAIN_PER_STEP = {
    "conv3_planes": STAGE_RUNS * K1_PER_FORWARD,
    "conv3_planes_adjoint": sum(r[6] for r in K1_SHAPES if r[7]),
    "conv3_planes_wgrad": sum(r[6] for r in K1_SHAPES),
    "maxpool3d_k3s2p1": 1, "maxpool3d_k3s2p1_vjp": 1,
    "conv3_mxu": sum(r[2] for r in K4_SHAPES),
    "conv3_mxu_dx": sum(r[2] for r in K4_SHAPES),
    "max_pool2_bwd": len(POOL2_SHAPES), "stem_conv_raw": 0,
}
# Launches of each kernel in one t128 train step at 'default' (the library
# forward and K4-dx-bf16 for each admitted conv2), and in the bf16 model's
# (K1-bf16 and K3-bf16 forward, K1 for the K1_F32_INPUT_TRAIN convs; K5-K8
# the f32 kernels behind casts).
TRAIN_DEFAULT_PER_STEP = dict(TRAIN_PER_STEP, conv3_mxu=0, conv3_mxu_dx=0,
                              conv3_mxu_dx_bf16=TRAIN_PER_STEP["conv3_mxu_dx"])
TRAIN_BF16_PER_STEP = dict(
    TRAIN_DEFAULT_PER_STEP,
    conv3_planes=STAGE_RUNS * sum(K1_SHAPES[i][6]
                                  for i in K1_F32_INPUT_TRAIN),
    conv3_planes_bf16=STAGE_RUNS * (K1_PER_FORWARD - sum(
        K1_SHAPES[i][6] for i in K1_F32_INPUT_TRAIN)),
    maxpool3d_k3s2p1=0, maxpool3d_k3s2p1_bf16=1)


def phase_kernels(dev):
    import torch.nn.functional as F
    from torch.nn.grad import conv3d_input, conv3d_weight

    from hiddenpose_tpu_torch.ops import kernels as K
    from hiddenpose_tpu_torch.ops.kernels import conv3mxu as k4
    from hiddenpose_tpu_torch.ops.kernels import stem_conv as k2

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    rows = {name: [] for name in K.KERNELS}
    # the path's rows at batch B, then K1 and K5 alone at ragged volumes off
    # the path (one capture; count 0)
    conv3p_cases = [(cin, cout, (n, n, n), pad, act, res, count, dx, has_bias,
                     None) for cin, cout, n, pad, act, res, count, dx,
                    has_bias in K1_SHAPES]
    conv3p_cases += [(cin, cout, dhw, pad, "leaky", True, 0, True, True, pre)
                     for cin, cout, dhw, pad, pre in K1_RAGGED]
    for (cin, cout, dhw, pad, act, res, count, dx, has_bias,
         pre) in conv3p_cases:
        on_path = count > 0
        vol = (B if on_path else 1, *dhw)
        at = (f"@{dhw[0]}^3" if on_path else "@" + "x".join(map(str, dhw)))
        x = randn(vol[0], cin, *dhw)
        k = randn(3, 3, 3, cin, cout, scale=(27 * cin) ** -0.5)
        bias = randn(cout, scale=0.1)
        r = randn(vol[0], cout, *dhw) if res else None
        nvox = vol[0] * dhw[0] * dhw[1] * dhw[2]
        out_bytes = 4 * cout * nvox
        flop = [(2 * 27 * cin * cout * nvox, "f32")]
        # the library's operands: a padded copy of x, OIDHW weights
        xp = F.pad(x, (1,) * 6, mode="replicate" if pad == "edge"
                   else "constant")
        w = k.permute(4, 3, 0, 1, 2).contiguous()
        kw = dict(act=act, pad_mode=pad)
        pre_args = ()
        if pre is not None:  # the pre-affine (+ ReLU), before the padding
            kw["pre_relu"] = pre
            pre_args = (torch.rand(cin, generator=g, device=dev) + 0.5,
                        randn(cin, scale=0.5) + 0.5)
        slower = CONV3P_SLOWER if on_path else None
        row = compare(
            f"conv3_planes {cin}->{cout} {at} {pad} {act}"
            f"{' +residual' if res else ''}"
            f"{'' if pre is None else ' pre-affine+relu'}",
            lambda: K.conv3_planes(x, k, bias, r, *pre_args, **kw),
            lambda: K.conv3_planes_ref(x, k, bias, r, *pre_args, **kw),
            iters=20 if on_path else 5,
            library_fn=lambda: F.conv3d(xp, w, bias),
            moved=nbytes(x, k, bias, r) + out_bytes, ops=flop, repeats=True,
            slower=slower)
        row.update(per_forward=count, per_step=STAGE_RUNS * count)
        rows["conv3_planes"].append(row)

        dz = randn(vol[0], cout, *dhw)
        if dx:
            row = compare(
                f"conv3_planes_adjoint {cout}->{cin} {at} {pad}",
                lambda: K.conv3_planes_adjoint(dz, k, pad_mode=pad),
                lambda: K.conv3_planes_adjoint_ref(dz, k, pad_mode=pad),
                iters=10 if on_path else 5,
                # zero padding's adjoint; edge padding also folds the halo
                # onto the boundary voxels, which no one call does: the
                # call without the fold is the yardstick there too
                library_fn=lambda: conv3d_input(x.shape, w, dz, padding=1),
                moved=nbytes(dz, k, x), ops=flop, repeats=True, slower=slower)
            row["per_step"] = count
            rows["conv3_planes_adjoint"].append(row)
        if not on_path:
            continue
        n = dhw[0]
        kw = dict(pad_mode=pad, has_bias=has_bias)

        def wgrad64():
            """K6's function in float64: one product per tap."""
            x64 = F.pad(x.double(), (1,) * 6, mode="replicate"
                        if pad == "edge" else "constant")
            dz64 = dz.double().flatten(2)
            dk = torch.stack([torch.einsum(
                "bin,bon->io", x64[:, :, a:a + n, b_:b_ + n,
                                   c:c + n].flatten(2), dz64)
                for a in range(3) for b_ in range(3) for c in range(3)])
            dk = dk.view(3, 3, 3, cin, cout)
            return (dk, dz64.sum((0, 2))) if has_bias else (dk,)

        row = compare(
            f"conv3_planes_wgrad {cin}x{cout} @{n}^3 {pad}"
            f"{' +db' if has_bias else ''}",
            lambda: K.conv3_planes_wgrad(x, dz, **kw),
            lambda: tuple(t for t in K.conv3_planes_wgrad_ref(x, dz, **kw)
                          if t is not None), iters=10,
            library_fn=lambda: conv3d_weight(xp, w.shape, dz),
            moved=nbytes(x, dz, k) + (4 * cout if has_bias else 0), ops=flop,
            f64_fn=wgrad64)
        row["per_step"] = count
        rows["conv3_planes_wgrad"].append(row)
    del x, xp, dz, r

    # K2 at the serving shape, then alone at extents that no tile divides
    # (one capture, off the path)
    for vol, relu, count in [((B, 128, 128, 128), True, 1)] + [
            ((1, *dhw), relu, 0) for dhw in K2_RAGGED
            for relu in (True, False)]:
        x = torch.rand((*vol, 1), generator=g, device=dev)
        k = randn(7, 7, 7, 1, 64, scale=343 ** -0.5)
        scale = torch.rand(64, generator=g, device=dev) + 0.5
        shift = randn(64, scale=0.1)
        # the library's operands: the channels-last view, OIDHW weights
        x_ncdhw = x.permute(0, 4, 1, 2, 3)
        w = k.permute(4, 3, 0, 1, 2).contiguous()
        flop = 2 * 343 * 64 * x.numel()

        def stem64(relu=relu):
            """K2's function in float64."""
            y = F.conv3d(x_ncdhw.double(), w.double(), padding=3)
            y = (y.permute(0, 2, 3, 4, 1) * scale.double()
                 + shift.double())
            return y.clamp_min(0.0) if relu else y

        if not torch.equal(k2.prepare_weights(k), k2.prepare_weights_ref(k)):
            raise RuntimeError("stem_conv_raw: prepared weights differ from "
                               "the plain version")
        at = "x".join(map(str, vol))
        row = compare(f"stem_conv_raw ({at},1)->64{'' if relu else ' no relu'}",
                      lambda: K.stem_conv_raw(x, k, scale, shift, relu),
                      lambda: K.stem_conv_raw_ref(x, k, scale, shift, relu),
                      iters=5 if count else 20,
                      # the conv alone, as K1's row leaves out its epilogue
                      library_fn=lambda: F.conv3d(x_ncdhw, w, padding=3),
                      moved=nbytes(x, k, scale, shift) + 4 * 64 * x.numel(),
                      # three TF32 passes; the fp32 FMA bound beside it
                      ops=[(3 * flop, "tf32")], f64_fn=stem64, repeats=True,
                      slower=CONV3P_SLOWER if count else None)
        row.update(per_forward=count, bound_fma_ms=flop / PEAK["f32"] * 1e3,
                   prep_ms=cuda_ms(lambda: k2.prepare_weights(k), 20))
        log(f"[3 kernels] stem_conv_raw ({at}): prepared weights equal the "
            f"plain version's, their preparation {row['prep_ms']:.4f} ms; "
            f"fp32 FMA bound {row['bound_fma_ms']:.4f} ms")
        rows["stem_conv_raw"].append(row)
    del x_ncdhw

    x = torch.rand((B, 128, 128, 128, 1), generator=g, device=dev)
    k = randn(7, 7, 7, 1, 64, scale=343 ** -0.5)
    scale = torch.rand(64, generator=g, device=dev) + 0.5
    shift = randn(64, scale=0.1)
    # the real pool input: post-ReLU stem output, many exact-zero ties
    y = K.stem_conv_raw(x, k, scale, shift - 0.5)
    zeros = (y == 0).float().mean().item()
    y_ncdhw = y.permute(0, 4, 1, 2, 3)  # a channels-last view, no copy
    pooled = 4 * B * 64 ** 3 * 64
    row = compare(f"maxpool3d_k3s2p1 (2,128^3,64) ties ({zeros:.0%} zeros)",
                  lambda: K.maxpool3d_k3s2p1(y),
                  lambda: K.maxpool3d_k3s2p1_ref(y), iters=10, exact=True,
                  library_fn=lambda: F.max_pool3d(y_ncdhw, 3, 2, 1),
                  moved=nbytes(y) + pooled)
    row["per_forward"] = row["per_step"] = 1
    rows["maxpool3d_k3s2p1"].append(row)

    gy = randn(B, *((n - 1) // 2 + 1 for n in y.shape[1:4]), 64)
    row = compare(
        f"maxpool3d_k3s2p1_vjp (2,128^3,64) ties ({zeros:.0%} zeros)",
        lambda: K.maxpool3d_k3s2p1_vjp(y, gy),
        lambda: K.maxpool3d_k3s2p1_vjp_ref(y, gy), iters=5,
        atol=VJP_ULPS * float(np.spacing(np.float32(gy.abs().max().item()))),
        # the 0.5/0.5 tie rule is the maximum chain's: no one library call
        moved=nbytes(y, gy, y))
    row["per_step"] = 1
    rows["maxpool3d_k3s2p1_vjp"].append(row)
    del y, y_ncdhw, gy

    # K8: the path's four pools, then an odd extent on every axis with
    # ties (one capture, off the path)
    for vol, count in [((B, c, n, n, n), 1) for c, n in POOL2_SHAPES] + [
            (POOL2_ODD, 0)]:
        x = torch.relu(randn(*vol))  # GroupNorm + ReLU: ties at 0
        if not count:
            x = torch.round(x)
        dy = randn(*vol[:2], *(n // 2 for n in vol[2:]))
        xg = x.clone().requires_grad_()
        pooled_graph = F.max_pool3d(xg, 2)  # its backward is the library call
        at = (f"(2,{vol[1]},{vol[2]}^3)" if count
              else str(vol).replace(" ", "") + " ties")
        row = compare(f"max_pool2_bwd {at}",
                      lambda: K.max_pool2_bwd(x, dy),
                      lambda: K.max_pool2_bwd_ref(x, dy), iters=10,
                      exact=True,
                      library_fn=lambda: torch.autograd.grad(
                          pooled_graph, xg, dy, retain_graph=True),
                      moved=nbytes(x, dy, x), repeats=True,
                      slower=CONV3P_SLOWER)
        row["per_step"] = count
        rows["max_pool2_bwd"].append(row)
        del xg, pooled_graph

    def conv64(x, k, scale=None, shift=None, relu=False):
        """K4's function in float64, NDHWC in and out."""
        y = F.conv3d(x.double().permute(0, 4, 1, 2, 3),
                     k.double().permute(4, 3, 0, 1, 2),
                     padding=1).permute(0, 2, 3, 4, 1)
        if scale is not None:
            y = y * scale.double() + shift.double()
        return y.clamp_min(0.0) if relu else y

    cases = [(c, (B, n, n, n), count, (True,)) for c, n, count in K4_SHAPES]
    cases += [(c, (1, *dhw), 0, (True, False)) for c, dhw in K4_RAGGED]
    for c, vol, count, epilogues in cases:
        x = randn(*vol, c)
        k = randn(3, 3, 3, c, c, scale=(27 * c) ** -0.5)
        sc = torch.rand(c, generator=g, device=dev) + 0.5
        sh = randn(c, scale=0.1)
        x_ncdhw = x.permute(0, 4, 1, 2, 3)  # channels-last view
        w = k.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        at = f"c{c}@{'x'.join(map(str, vol[1:]))} b{vol[0]}"
        # three TF32 passes of the conv's FLOP; the fp32 FMA bound beside it
        flop = 2 * 27 * c * c * x.numel() // c
        ops = [(3 * flop, "tf32")]
        fma_ms = flop / PEAK["f32"] * 1e3
        # the weight operand: the preparation kernel against its plain
        # version, bit for bit
        for transposed in (False, True):
            if not torch.equal(k4.prepare_weights(k, transposed),
                               k4.prepare_weights_ref(k, transposed)):
                raise RuntimeError(f"{at}: prepared weights differ from the "
                                   f"plain version (transposed={transposed})")
        for epi in epilogues:
            e = dict(scale=sc, shift=sh, relu=True) if epi else {}
            row = compare(f"conv3_mxu {at}{' +bn+relu' if epi else ''}",
                          lambda: K.conv3_mxu(x, k, **e),
                          lambda: K.conv3_mxu_ref(x, k, **e), iters=5,
                          library_fn=lambda: F.conv3d(x_ncdhw, w, padding=1),
                          moved=nbytes(x, k, sc, sh, x), ops=ops,
                          f64_fn=lambda: conv64(x, k, **e))
            row.update(per_forward=count, per_step=count,
                       bound_fma_ms=fma_ms)
            rows["conv3_mxu"].append(row)
        row = compare(f"conv3_mxu_dx {at}",
                      lambda: K.conv3_mxu_dx(x, k),
                      lambda: K.conv3_mxu_dx_ref(x, k), iters=5,
                      library_fn=lambda: conv3d_input(
                          x_ncdhw.shape, w, x_ncdhw, padding=1),
                      moved=nbytes(x, k, x), ops=ops,
                      f64_fn=lambda: conv64(x, k4.flip_swap(k)))
        row.update(per_step=count, bound_fma_ms=fma_ms)
        rows["conv3_mxu_dx"].append(row)
        log(f"[3 kernels] conv3_mxu and conv3_mxu_dx {at}: prepared weights "
            f"equal the plain version's; fp32 FMA bound {fma_ms:.4f} ms")
    del x, x_ncdhw

    # K9.  (B, Lq, Lk, dh), q/k dtype, v dtype, calls per Sformer forward:
    # the Sformer's grouped attention at full width (8 heads x 128 frames
    # of 1024 patches + 24 joint keys; once a layer), its over="time"
    # grouping (8 heads x 1024 positions, 128 frames + 24 joint keys), the
    # ragged shapes of the JAX package's tests, the bf16 mode's
    # combinations at the full-width shape, and the joint-token read (8
    # heads, 24 joint queries over all tokens; once a layer), which the
    # kernel splits over the keys, in the dtypes of both modes.
    f32, bf16 = torch.float32, torch.bfloat16
    full = (8 * 128, 1024, 1048, 32)
    joint = (8, 24, 24 + 128 * 1024, 32)

    for shape, qdt, vdt, per, iters, tol in [
            (full, f32, f32, 8, 3, ATTN_F32_TOL),
            ((8 * 1024, 128, 152, 32), f32, f32, 0, 3, ATTN_F32_TOL),
            ((3, 64, 80, 32), f32, f32, 0, 20, ATTN_F32_TOL),
            ((2, 256, 131, 32), f32, f32, 0, 20, ATTN_F32_TOL),
            ((1, 128, 1048, 32), f32, f32, 0, 20, ATTN_F32_TOL),
            ((2, 24, 640, 64), f32, f32, 0, 20, ATTN_F32_TOL),
            (full, bf16, bf16, 0, 3, ATTN_BF16_TOL),
            (full, f32, bf16, 0, 3, ATTN_BF16_TOL),
            (joint, f32, f32, 8, 3, ATTN_F32_TOL),
            (joint, bf16, bf16, 0, 3, ATTN_BF16_TOL)]:
        b, lq, lk, dh = shape
        q = (randn(b, lq, dh, scale=dh ** -0.5)).to(qdt)
        k = randn(b, lk, dh).to(qdt)
        v = randn(b, lk, dh).to(vdt)
        half = 2 * b * lq * lk * dh
        # What the kernel's products are made of: at head dim 32 an f32
        # operand takes three TF32 passes on the tensor cores, a bf16 one
        # (for p v: a bf16 v) one bf16 pass; other head dims fp32 FMA.
        ops = [(half, "bf16") if dt == bf16 else
               (3 * half, "tf32") if dh == 32 else (half, "f32")
               for dt in (qdt, vdt)]
        row = compare(
            f"attend {shape} q/k {qdt} v {vdt}".replace("torch.", ""),
            lambda: K.attend(q, k, v), lambda: K.attend_ref(q, k, v),
            iters=iters, rtol_atol=tol,
            # one dtype for all three, or SDPA refuses
            library_fn=(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=1.0)) if qdt == vdt else None,
            moved=nbytes(q, k, v) + b * lq * dh * v.element_size(),
            ops=ops,
            f64_fn=(lambda: attention64(q, k, v)) if vdt == f32 else None)
        row["per_forward"] = per
        if vdt == f32:
            row["bound_fma_ms"] = 2 * half / PEAK["f32"] * 1e3
        with deterministic(warn_only=True):  # the split sums in chunk order
            if not torch.equal(K.attend(q, k, v), K.attend(q, k, v)):
                raise RuntimeError(f"attend {shape}: two calls differ")
        rows["attend"].append(row)
        del q, k, v
    # logits x 50: the running max must keep exp() finite
    q, k, v = randn(1, 8, 8, scale=50.0), randn(1, 136, 8), randn(1, 136, 8)
    row = compare("attend (1, 8, 136, 8) logits x 50",
                  lambda: K.attend(q, k, v), lambda: K.attend_ref(q, k, v),
                  iters=20, rtol_atol=ATTN_EXTREME_TOL,
                  library_fn=lambda: F.scaled_dot_product_attention(
                      q, k, v, scale=1.0),
                  moved=nbytes(q, k, v, q), ops=[(4 * 8 * 136 * 8, "f32")],
                  f64_fn=lambda: attention64(q, k, v))
    row["per_forward"] = 0
    rows["attend"].append(row)
    # the same at head dim 32, on the tensor cores: an error in a score is
    # multiplied by the score's size inside exp()
    q, k, v = randn(2, 100, 32, scale=20.0), randn(2, 300, 32), \
        randn(2, 300, 32)
    row = compare("attend (2, 100, 300, 32) logits x 113",
                  lambda: K.attend(q, k, v), lambda: K.attend_ref(q, k, v),
                  iters=20, rtol_atol=ATTN_LARGE_LOGITS_TOL,
                  library_fn=lambda: F.scaled_dot_product_attention(
                      q, k, v, scale=1.0),
                  moved=nbytes(q, k, v, q),
                  ops=[(3 * 4 * 2 * 100 * 300 * 32, "tf32")],
                  f64_fn=lambda: attention64(q, k, v))
    row["per_forward"] = 0
    rows["attend"].append(row)
    torch.cuda.empty_cache()
    return rows, stem_vjp_row(dev, g)


def stem_vjp_row(dev, g):
    """The train-mode stem conv's matrix-product backward
    (``ops/stem_vjp.py``; products by ``torch.matmul``, no kernel of the
    port) at the t128 batch-2 shape against the library's conv backward,
    both times, two calls bit for bit, and on a cut-down volume against
    float64."""
    from torch.nn.grad import conv3d_input, conv3d_weight

    from hiddenpose_tpu_torch.ops import stem_vjp as S

    def inputs(n, dtype=torch.float32):
        x = torch.rand((B, 1, n, n, n), generator=g, device=dev)
        w = torch.randn((64, 1, 7, 7, 7), generator=g, device=dev) / 343 ** .5
        dy = torch.randn((B, 64, n, n, n), generator=g, device=dev)
        return x.to(dtype), w.to(dtype), dy.to(dtype)

    def ours(x, w, dy):
        return S.stem_conv_dx(w, dy), S.stem_conv_dk(x, dy, 7)

    def library(x, w, dy):
        return (conv3d_input(x.shape, w, dy, padding=3),
                conv3d_weight(x, w.shape, dy, padding=3))

    x, w, dy = inputs(128)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with deterministic(warn_only=True):
        got, again = ours(x, w, dy), ours(x, w, dy)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated(dev) - base
        want = library(x, w, dy)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise RuntimeError("stem_vjp: two calls differ")
    rel = [((a - b).abs().max() / b.abs().max()).item()
           for a, b in zip(got, want)]
    del got, again, want
    row = dict(shape=f"stem_vjp ({B},1,128^3) -> dx, dk (64,1,7^3)",
               dx_rel_err=rel[0], dk_rel_err=rel[1],
               scratch_peak_bytes=extra,
               dx_ms=cuda_ms(lambda: S.stem_conv_dx(w, dy), 2),
               dk_ms=cuda_ms(lambda: S.stem_conv_dk(x, dy, 7), 2),
               library_dx_ms=cuda_ms(
                   lambda: conv3d_input(x.shape, w, dy, padding=3), 1),
               library_dk_ms=cuda_ms(
                   lambda: conv3d_weight(x, w.shape, dy, padding=3), 1))
    del x, w, dy
    # a cut-down volume against float64: the long sums of dk
    x, w, dy = inputs(48)
    with deterministic(warn_only=True):
        got, want = ours(x, w, dy), library(x, w, dy)
        want64 = library(x.double(), w.double(), dy.double())
    errs = [tuple((t.double() - w64).abs().max().item() for t in (a, b))
            for a, b, w64 in zip(got, want, want64)]
    ok64 = all(e[0] <= max(F64_ERR_FACTOR * e[1],
                           2.0 ** -23 * w64.abs().max().item())
               for e, w64 in zip(errs, want64))
    row.update(dx_err_vs_f64=errs[0][0], library_dx_err_vs_f64=errs[0][1],
               dk_err_vs_f64=errs[1][0], library_dk_err_vs_f64=errs[1][1])
    log(f"[3 kernels] {row['shape']}: dx {row['dx_ms']:.3f} ms (library "
        f"conv3d_input {row['library_dx_ms']:.3f}), dk {row['dk_ms']:.3f} ms "
        f"(library conv3d_weight {row['library_dk_ms']:.3f}); max err / max "
        f"against the library dx {rel[0]:.3e} dk {rel[1]:.3e} (tolerance "
        f"{CONV_TOL}); scratch peak {extra / 2**30:.3f} GiB; two calls bit "
        f"for bit; at 48^3 against float64: dx {errs[0][0]:.3e} (library "
        f"{errs[0][1]:.3e}), dk {errs[1][0]:.3e} (library {errs[1][1]:.3e}), "
        f"limit {F64_ERR_FACTOR:g} x the library's")
    if max(rel) > CONV_TOL or not ok64:
        raise RuntimeError("stem_vjp disagrees with the library backward")
    torch.cuda.empty_cache()
    return row


def t128_captures(n: int):
    """``n`` synthetic t128 captures (seeds 0..n-1) and the t128 config."""
    from hiddenpose_tpu_torch.config import t128_config
    from hiddenpose_tpu_torch.data.synthetic import make_sample

    cfg = t128_config()
    m = cfg.model
    return cfg, [make_sample(s, m.time_size, m.image_size[0], m.grid_dim,
                             m.heatmap_size[0], m.bin_len)["meas"]
                 for s in range(n)]


def t128_weights(cfg, seed: int = 1):
    """The port's peaked random weights (seed 1 unless another is given)
    for ``cfg``."""
    from hiddenpose_tpu_torch.models.nlospose import NlosPose
    from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict

    with torch.device("meta"):  # names and shapes only
        template = NlosPose(cfg.model)
    return peaked_state_dict(template, seed=seed)


def phase_serve(dev, smi):
    from hiddenpose_tpu_torch.ops import kernels as K
    from hiddenpose_tpu_torch.serve import InferenceServer

    t0 = time.perf_counter()
    cfg, caps = t128_captures(9)
    log(f"[4 serve] 9 synthetic t128 captures in "
        f"{time.perf_counter() - t0:.1f} s")
    server = InferenceServer(cfg, t128_weights(cfg), batch_size=B,
                             dtype="float32", device=dev)
    try:
        t0 = time.perf_counter()
        server.warmup()
        log(f"[4 serve] warm-up request {time.perf_counter() - t0:.2f} s")

        # closed loop: one request at a time, each served alone (its
        # batch padded with copies of itself)
        lat1 = []
        for c in caps[:5]:
            t0 = time.perf_counter()
            server.infer(c)
            lat1.append(time.perf_counter() - t0)

        before = server.stats()
        K.reset_launch_counts()
        t_sub, t_done = {}, {}
        start = time.perf_counter()
        futs = []
        for i, c in enumerate(caps):
            t_sub[i] = time.perf_counter()
            f = server.submit(c)
            f.add_done_callback(
                lambda _f, i=i: t_done.__setitem__(i, time.perf_counter()))
            futs.append(f)
        results = [f.result(timeout=600)["joints"] for f in futs]
        wall = time.perf_counter() - start
        counts = K.launch_counts()
        stats = {k: v - before[k] for k, v in server.stats().items()
                 if k in ("batches", "padded")}

        for j in results:
            if j.shape != (24, 3) or not np.isfinite(j).all():
                raise RuntimeError(f"bad joints {j.shape}")
        lat = sorted(t_done[i] - t_sub[i] for i in range(len(caps)))
        log(f"[4 serve] {len(caps)} requests in {stats['batches']} batches "
            f"({stats['padded']} padded) in {wall:.3f} s: "
            f"{len(caps) / wall:.3f} volumes/s, p50 latency "
            f"{lat[len(lat) // 2] * 1000:.1f} ms under the burst; closed-loop "
            f"p50 {sorted(lat1)[2] * 1000:.1f} ms  [{smi}]")
        log(f"[4 serve] launch counts over the burst: {counts}")
        per_forward = {
            "conv3_planes": sum(row[6] for row in K1_SHAPES),
            "stem_conv_raw": 1, "maxpool3d_k3s2p1": 1,
            "conv3_mxu": sum(row[2] for row in K4_SHAPES)}
        want = {k: per_forward.get(k, 0) * stats["batches"] for k in counts}
        if counts != want or min(counts[k] for k in K.SERVING) <= 0:
            raise RuntimeError(f"launch counts {counts}, expected {want}")

        # captures 0-4 alone, then all five at once: batches (0, 1),
        # (2, 3) and 4 padded
        with deterministic():
            alone = [server.infer(c)["joints"] for c in caps[:5]]
            batched = [f.result(timeout=600)["joints"]
                       for f in [server.submit(c) for c in caps[:5]]]
        d = float(np.abs(np.stack(batched) - np.stack(alone)).max())
        log(f"[4 serve] captures 0-4 alone vs in batches (deterministic "
            f"algorithms): max |d joints| {d:.3e} voxels (tolerance "
            f"{BATCH_TOL})")
        if d > BATCH_TOL:
            raise RuntimeError("per-request result depends on the batch")
        joints_spread = float(np.ptp(np.stack(results)))
        serve = dict(requests=len(caps), wall_s=wall,
                     volumes_per_s=len(caps) / wall,
                     p50_latency_ms=lat[len(lat) // 2] * 1000,
                     closed_loop_p50_ms=sorted(lat1)[2] * 1000,
                     batches=stats["batches"], padded=stats["padded"],
                     launches=counts, joints_spread_voxels=joints_spread,
                     joints=[j.tolist() for j in results])
    finally:
        server.close()
    return server, caps, serve, counts


def phase_end_to_end(server, caps):
    from hiddenpose_tpu_torch.train.step import make_forward

    model = server.model
    fwd = make_forward(model)
    meas = torch.from_numpy(np.stack(caps[:B])).to(server.device)
    out = {}
    for flag in (True, False):
        model.set_use_kernels(flag)
        ms = cuda_ms(lambda: fwd(meas, server.lct), iters=5)
        with deterministic():
            joints, hm = fwd(meas, server.lct)
        out[flag] = (joints.float(), hm.float(), ms)
    model.set_use_kernels(True)
    jk, hk, ms_k = out[True]
    jp, hp, ms_p = out[False]
    hm_rel = ((hk - hp).abs().max() / hp.abs().max()).item()
    j_abs = (jk - jp).abs().max().item()
    log(f"[5 e2e] heatmaps max rel err {hm_rel:.3e} (tolerance {E2E_HM_TOL}),"
        f" joints max abs err {j_abs:.3e} voxels (tolerance {E2E_JOINT_TOL});"
        f" forward b{B}: kernels {ms_k:.2f} ms, plain {ms_p:.2f} ms;"
        f" heatmap range [{hp.min().item():.3g}, {hp.max().item():.3g}]")
    if not (torch.isfinite(hk).all() and hm_rel <= E2E_HM_TOL
            and j_abs <= E2E_JOINT_TOL):
        raise RuntimeError("kernels and plain versions disagree end to end")
    return dict(hm_max_rel_err=hm_rel, joints_max_abs_err=j_abs,
                forward_ms_kernels=ms_k, forward_ms_plain=ms_p)


def _module(name: str) -> str:
    return name.split(".")[0]


def _grad_rel_l2(a, b):
    """Relative L2 distance of gradients ``a`` from ``b`` (by name), over
    each top-level module."""
    out = {}
    for mod in sorted({_module(n) for n in b}):
        names = [n for n in b if _module(n) == mod]
        num = sum(float((a[n] - b[n]).double().pow(2).sum()) for n in names)
        den = sum(float(b[n].double().pow(2).sum()) for n in names)
        out[mod] = (num / den) ** 0.5
    return out


def _train_readings(a, b):
    """How far step result ``a`` is from ``b`` (dicts of loss, grads,
    params, stats by name)."""
    loss = {k: abs(a["loss"][k] - b["loss"][k]) / abs(b["loss"][k])
            for k in b["loss"]}
    grad_l2 = _grad_rel_l2(a["grads"], b["grads"])
    grad_max = sorted(
        ((float((a["grads"][n] - b["grads"][n]).abs().max())
          / max(float(b["grads"][n].abs().max()), 1e-30), n)
         for n in b["grads"]), reverse=True)
    stats = max(float((a["stats"][n] - b["stats"][n]).abs().max())
                / max(float(b["stats"][n].abs().max()), 1e-30)
                for n in b["stats"])
    param_err, agree, total = 0.0, 0, 0
    for n, gb in b["grads"].items():
        ga = a["grads"][n]
        close = ((ga - gb).abs() <= 0.25 * gb.abs()) & (gb.abs() >= 1e-5)
        if close.any():
            param_err = max(param_err, float(
                (a["params"][n] - b["params"][n])[close].abs().max()))
        big = gb.abs() > 1e-2 * gb.abs().max()
        agree += int(((torch.sign(ga) == torch.sign(gb)) & big).sum())
        total += int(big.sum())
    return dict(loss_rel=loss, grad_rel_l2=grad_l2,
                grad_max_rel_worst=grad_max[:3], stats_max_rel=stats,
                param_max_abs=param_err, sign_agree=agree / max(total, 1))


def phase_train(dev, smi):
    """Three Adam steps at t128, then one step with kernels vs plain."""
    from hiddenpose_tpu_torch.config import TrainConfig
    from hiddenpose_tpu_torch.data.synthetic import make_batch
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose
    from hiddenpose_tpu_torch.ops import kernels as K
    from hiddenpose_tpu_torch.train.state import TrainState
    from hiddenpose_tpu_torch.train.step import make_train_step

    from hiddenpose_tpu_torch.config import t128_config

    cfg = t128_config()
    m = cfg.model
    t0 = time.perf_counter()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        [0, 1], m.time_size, m.image_size[0], m.grid_dim, m.heatmap_size[0],
        m.bin_len).items()}
    weights = t128_weights(cfg)
    model, lct = build_nlospose(m, device=dev)
    model.load_state_dict(weights)
    step = make_train_step(model)
    state = TrainState.create(model, TrainConfig())
    log(f"[6 train] t128 model and batch [0, 1] in "
        f"{time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    steps = []
    for i in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(state, batch, lct)
        end.record()
        torch.cuda.synchronize()
        steps.append(dict({k: v.item() for k, v in metrics.items()},
                          ms=start.elapsed_time(end)))
        log(f"[6 train] step {i}: loss {steps[-1]['loss']:.6g} (joint "
            f"{steps[-1]['joint_loss']:.6g}, voxel "
            f"{steps[-1]['voxel_loss']:.6g}) in {steps[-1]['ms']:.2f} ms")
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[6 train] peak memory {peak / 2**30:.3f} GiB; launch counts over "
        f"3 steps: {counts}  [{smi}]")
    want = {k: 3 * TRAIN_PER_STEP.get(k, 0) for k in counts}
    if counts != want or min(counts[k] for k in K.TRAINING) <= 0:
        raise RuntimeError(f"train launch counts {counts}, expected {want}")
    if not all(np.isfinite(s_[k]) for s_ in steps
               for k in ("loss", "joint_loss", "voxel_loss")):
        raise RuntimeError("a train step's loss is not finite")

    def one_step(use_kernels):
        model.load_state_dict(weights)
        model.set_use_kernels(use_kernels)
        st = TrainState.create(model, TrainConfig())
        with deterministic(warn_only=True):
            met = step(st, batch, lct)
        torch.cuda.synchronize()
        return dict(
            loss={k: v.item() for k, v in met.items()},
            grads={n: p.grad.detach().clone()
                   for n, p in model.named_parameters()},
            params={n: p.detach().clone()
                    for n, p in model.named_parameters()},
            stats={n: b.clone() for n, b in model.named_buffers()
                   if n.endswith(("running_mean", "running_var"))})

    kern = one_step(True)
    plain = one_step(False)
    vs = _train_readings(kern, plain)
    # The step's own conditioning: the plain step again on a measurement
    # moved by 1e-7 (relative), far below the kernels' rounding effects.
    g = torch.Generator(device=dev).manual_seed(0)
    meas = batch["meas"]
    batch["meas"] = meas * (1 + 1e-7 * torch.randn(
        meas.shape, generator=g, device=dev))
    spread = _train_readings(one_step(False), plain)
    batch["meas"] = meas
    del plain
    for name, r in (("kernels vs plain", vs),
                    ("plain vs plain on a 1e-7 moved measurement", spread)):
        log(f"[6 train] {name}: loss rel {r['loss_rel']}; grads rel L2 "
            f"{r['grad_rel_l2']}; grads worst max err/max abs "
            f"{r['grad_max_rel_worst']}; new running stats max rel "
            f"{r['stats_max_rel']:.3e}; new params max abs err where the "
            f"gradients agree {r['param_max_abs']:.3e}; large gradient "
            f"elements of one sign {r['sign_agree']:.5f}")
    ok = (max(vs["loss_rel"].values()) <= TRAIN_LOSS_TOL
          and max(vs["grad_rel_l2"].values()) <= TRAIN_GRAD_L2_TOL
          and vs["stats_max_rel"] <= TRAIN_STATS_TOL
          and vs["param_max_abs"] <= TRAIN_PARAM_TOL
          and vs["sign_agree"] >= TRAIN_SIGN_AGREE)
    log(f"[6 train] tolerances: loss {TRAIN_LOSS_TOL}, grads rel L2 "
        f"{TRAIN_GRAD_L2_TOL}, stats {TRAIN_STATS_TOL}, params "
        f"{TRAIN_PARAM_TOL}, one sign >= {TRAIN_SIGN_AGREE}: "
        f"{'pass' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("train step: kernels and plain versions disagree")

    # Forward (to the model's output) and backward + loss + Adam, by CUDA
    # events, kernels and plain in turns; peak memory of each.
    marks = {}
    hook = model.register_forward_hook(
        lambda *_: marks["fwd"].record())
    timing = {True: [], False: []}
    for use_kernels in (True, False, True, False):
        model.load_state_dict(weights)
        model.set_use_kernels(use_kernels)
        st = TrainState.create(model, TrainConfig())
        for k in ("start", "fwd", "end"):
            marks[k] = torch.cuda.Event(enable_timing=True)
        torch.cuda.reset_peak_memory_stats(dev)
        marks["start"].record()
        step(st, batch, lct)
        marks["end"].record()
        torch.cuda.synchronize()
        timing[use_kernels].append(dict(
            forward_ms=marks["start"].elapsed_time(marks["fwd"]),
            backward_ms=marks["fwd"].elapsed_time(marks["end"]),
            peak_memory_bytes=torch.cuda.max_memory_allocated(dev)))
    hook.remove()
    model.set_use_kernels(True)
    for use_kernels, runs in timing.items():
        log(f"[6 train] {'kernels' if use_kernels else 'plain'}: forward "
            f"{[round(r['forward_ms'], 2) for r in runs]} ms, backward + "
            f"loss + Adam {[round(r['backward_ms'], 2) for r in runs]} ms, "
            f"peak memory {runs[0]['peak_memory_bytes'] / 2**30:.3f} GiB  "
            f"[{smi}]")
    train = dict(steps=steps, peak_memory_bytes=peak, launches=counts,
                 kernels_vs_plain=vs, plain_vs_moved_plain=spread,
                 timing={"kernels": timing[True], "plain": timing[False]})
    # phase 10 reads this step on the host: nothing of it stays on the card
    # through phases 7-9
    return train, counts, dict(step=_step_to(kern, "cpu"), spread=spread)


def _step_to(result, device):
    """A step result (dicts of tensors by name) on ``device``."""
    return {k: ({n: t.to(device) for n, t in v.items()} if k != "loss"
                else v) for k, v in result.items()}


def sformer_weights(cfg):
    """The port's peaked random Sformer weights (seed 1) for ``cfg``."""
    from hiddenpose_tpu_torch.models.sformer import sformer_from_config
    from hiddenpose_tpu_torch.utils.peaked import (
        peaked_transformer_state_dict,
    )

    with torch.device("meta"):  # names and shapes only
        template = sformer_from_config(cfg)
    return peaked_transformer_state_dict(template, seed=1)


def sformer_videos(dev, seeds=(0, 1)):
    """Real-data-shaped synthetic captures as videos (1, 128, 1, 128, 128):
    128 time bins as frames of one 128 x 128 channel."""
    return [torch.from_numpy(np.random.RandomState(s).rand(
        1, 128, 1, 128, 128).astype(np.float32)).to(dev) for s in seeds]


def _median_ms(fn, reps=5):
    """Median device ms of ``fn()`` over ``reps`` runs, and the peak memory
    of one."""
    times = []
    for _ in range(reps):
        torch.cuda.reset_peak_memory_stats()
        times.append(cuda_ms(fn, iters=1))
    return float(np.median(times)), torch.cuda.max_memory_allocated()


def phase_sformer(dev, smi):
    """The Sformer serving path at full width: video -> SimDR logits ->
    joints, f32 with kernels and plain, then the bf16 mode."""
    from hiddenpose_tpu_torch.config import t128_config
    from hiddenpose_tpu_torch.models import sformer as sformer_module
    from hiddenpose_tpu_torch.models.sformer import build_sformer, serve_video
    from hiddenpose_tpu_torch.ops import kernels as K

    cfg = t128_config().model
    t0 = time.perf_counter()
    weights = sformer_weights(cfg)
    model = build_sformer(cfg, device=dev, dtype="float32")
    model.load_state_dict(weights)
    videos = sformer_videos(dev)
    n_tokens = cfg.num_joints + 128 * (128 // cfg.patch_size) ** 2
    log(f"[7 sformer] dim {cfg.patch_feature_dim} depth {cfg.depth} heads "
        f"{cfg.heads} x {cfg.dim_head}, {n_tokens} tokens, weights and 2 "
        f"videos in {time.perf_counter() - t0:.1f} s")
    serve_video(model, videos[0])  # warm-up: cuBLAS, the kernel library
    torch.cuda.synchronize()

    # the main path: a few captures answered one at a time
    K.reset_launch_counts()
    answers, lat = [], []
    for v in (videos[0], videos[1], videos[0]):
        t0 = time.perf_counter()
        joints, out = serve_video(model, v)
        joints = joints.cpu().numpy()  # the completion fence
        lat.append((time.perf_counter() - t0) * 1000)
        answers.append((joints, out))
    counts = K.launch_counts()
    want = {k: (3 * SFORMER_LAUNCHES_PER_FORWARD if k in K.SFORMER else 0)
            for k in counts}
    log(f"[7 sformer] 3 captures, f32, kernels: {[round(x, 2) for x in lat]} "
        f"ms each (host clock, fetch included); launch counts {counts}  "
        f"[{smi}]")
    if counts != want:
        raise RuntimeError(f"sformer launch counts {counts}, expected {want}")
    for joints, out in answers:
        if out.shape != (1, cfg.num_joints, 4, cfg.out_dim // 4) \
                or joints.shape != (1, cfg.num_joints, 3) \
                or not bool(torch.isfinite(out).all()) \
                or not np.isfinite(joints).all():
            raise RuntimeError(f"bad sformer output {tuple(out.shape)}")

    # the comparison below means something only if the joints spread over
    # the bins, move with the video, and the logits depend on the tables
    (j0, out0), (j1, _), _ = answers
    spread = float(np.ptp(j0, axis=1).min())
    moved = float(np.abs(j0 - j1).max())
    model.rotary_emb, model.pos_emb = False, torch.zeros(1, 1, 1, device=dev)
    _, no_rot = serve_video(model, videos[0])
    model.rotary_emb = True
    del model.pos_emb
    rot_rel = ((no_rot - out0).abs().max() / out0.abs().max()).item()
    log(f"[7 sformer] joints spread over joints {spread:.2f} image units "
        f"(smallest axis), moved by up to {moved:.2f} between two videos; "
        f"without the rotary tables the logits move by {rot_rel:.3f} of "
        f"their max; logit range [{out0.min().item():.3g}, "
        f"{out0.max().item():.3g}]")
    if spread < 1.0 or moved < 0.05 or rot_rel < 100 * SFORMER_TOL:
        raise RuntimeError("the sformer check cannot tell a wrong model")

    outs = {}
    for flag in (True, False):
        model.set_use_kernels(flag)
        with deterministic(warn_only=True):
            outs[flag] = serve_video(model, videos[0])
    # The same forward with every attention taken in float64: the joint
    # read sums 131 096 weighted values a row, where the plain f32 version
    # (cuBLAS's unsplit batched GEMM) errs a thousand times more than the
    # kernel, whose chunks sum 2048 each.  So the kernels are held to
    # SFORMER_TOL against this forward, and against the plain f32 forward
    # to SFORMER_TOL plus the plain forward's own distance from it.
    with mock.patch.object(
            sformer_module, "attend_ref",
            lambda q, k, v: attention64(q, k, v).to(v.dtype)), \
            deterministic(warn_only=True):
        exact = serve_video(model, videos[0])[1]

    def rel_err(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    rel = rel_err(outs[True][1], outs[False][1])
    rel_exact = rel_err(outs[True][1], exact)
    plain_exact = rel_err(outs[False][1], exact)
    j_bins = 2 * (outs[True][0] - outs[False][0]).abs().max().item()
    log(f"[7 sformer] logits max rel err, kernels vs the float64-attention "
        f"forward {rel_exact:.3e} (tolerance {SFORMER_TOL}), plain vs the "
        f"same {plain_exact:.3e}, kernels vs plain {rel:.3e} (tolerance "
        f"{SFORMER_TOL} + the plain forward's); joints max err "
        f"{j_bins:.3e} bins (tolerance {SFORMER_JOINT_TOL})")
    if not rel_exact <= SFORMER_TOL \
            or not rel <= SFORMER_TOL + plain_exact \
            or not j_bins <= SFORMER_JOINT_TOL:
        raise RuntimeError("sformer: kernels and plain versions disagree")

    timing = {True: [], False: []}
    for flag in (True, False, True, False):
        model.set_use_kernels(flag)
        ms, peak = _median_ms(lambda: serve_video(model, videos[0]))
        timing[flag].append(dict(ms_per_capture=ms, peak_memory_bytes=peak))
    model.set_use_kernels(True)
    for flag, runs in timing.items():
        log(f"[7 sformer] f32 {'kernels' if flag else 'plain'}: "
            f"{[round(r['ms_per_capture'], 2) for r in runs]} ms per capture "
            f"(median of 5 each), peak memory "
            f"{runs[0]['peak_memory_bytes'] / 2**30:.3f} GiB  [{smi}]")
    del model, outs, answers, no_rot
    torch.cuda.empty_cache()

    # the bfloat16 mode: bf16 Dense layers, f32 norms and residual stream
    model = build_sformer(cfg, device=dev, dtype="bfloat16")
    model.load_state_dict(weights)
    K.reset_launch_counts()
    joints_b, out_b = serve_video(model, videos[0])
    n_bf16 = K.launch_counts()["attend"]
    bf_rel = ((out_b.float() - out0).abs().max() / out0.abs().max()).item()
    bf_bins = 2 * float(np.abs(joints_b.cpu().numpy() - j0).max())
    # kernels vs plain in this mode: K9 on (f32 q/k, bf16 v)
    outs = {}
    for flag in (True, False):
        model.set_use_kernels(flag)
        with deterministic(warn_only=True):
            outs[flag] = serve_video(model, videos[0])[1].float()
    model.set_use_kernels(True)
    bf_k_rel = ((outs[True] - outs[False]).abs().max()
                / outs[False].abs().max()).item()
    ms_b, peak_b = _median_ms(lambda: serve_video(model, videos[0]))
    log(f"[7 sformer] bf16 mode: {ms_b:.2f} ms per capture, peak memory "
        f"{peak_b / 2**30:.3f} GiB, {n_bf16} kernel launches a forward, "
        f"logits {out_b.dtype}; kernels vs plain max rel err {bf_k_rel:.3e} "
        f"(tolerance {SFORMER_BF16_KERNELS_TOL}); max err vs f32 "
        f"{bf_rel:.3e} of the max (limit {SFORMER_BF16_TOL}), joints up to "
        f"{bf_bins:.2f} bins off  [{smi}]")
    if out_b.dtype != torch.bfloat16 or not bf_rel <= SFORMER_BF16_TOL \
            or not bf_k_rel <= SFORMER_BF16_KERNELS_TOL \
            or n_bf16 != SFORMER_LAUNCHES_PER_FORWARD \
            or not bool(torch.isfinite(out_b.float()).all()):
        raise RuntimeError("sformer bf16 mode is off")
    res = dict(tokens=n_tokens, latency_ms=lat, launches=counts,
               joints_spread=spread, joints_moved_between_videos=moved,
               no_rotary_rel=rot_rel, logits_max_rel_err=rel,
               logits_rel_err_vs_f64_attention=rel_exact,
               plain_logits_rel_err_vs_f64_attention=plain_exact,
               joints_max_err_bins=j_bins,
               f32={"kernels": timing[True], "plain": timing[False]},
               bf16=dict(ms_per_capture=ms_b, peak_memory_bytes=peak_b,
                         logits_rel_err_vs_f32=bf_rel,
                         kernels_vs_plain_rel_err=bf_k_rel,
                         joints_err_bins_vs_f32=bf_bins, launches=n_bf16))
    return res, counts


def busy_seconds(events) -> float:
    """Length of the union of the device events' [start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in events):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e6  # profiler times are in microseconds


def idle_share(fn):
    """(wall s, device busy s, idle share) of fn() under torch.profiler;
    busy is the union of the device kernels' intervals."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = busy_seconds(e for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall, busy, 1.0 - busy / wall


def bf16_rows(dev):
    """Each bf16 kernel against its plain version (one bf16 ulp; K3
    exact), twice for identical bits, beside its one library call on the
    same bf16 tensors, at the bf16 path's t128 batch-2 shapes and at
    ragged volumes off the path (one capture); K2-bf16 and K4-bf16 also in
    their f32-output form against float64."""
    import torch.nn.functional as F

    from hiddenpose_tpu_torch.ops import kernels as K
    from hiddenpose_tpu_torch.ops.kernels import conv3mxu as k4
    from hiddenpose_tpu_torch.ops.kernels import stem_conv as k2

    g = torch.Generator(device=dev).manual_seed(9)
    bf16, tag = torch.bfloat16, "9 serve bf16"

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    rows = {name: [] for name in K.SERVING_BF16}

    # K1-bf16: the path's shapes (FeatureExtraction and the UNet, bf16 x
    # and residual, f32 taps and bias; the UNet's first conv, whose input
    # is f32, off the path), then two ragged volumes
    cases = [(cin, cout, (n, n, n), pad, act, res,
              0 if i in K1_F32_INPUT_SERVE else count)
             for i, (cin, cout, n, pad, act, res, count, _, _)
             in enumerate(K1_SHAPES)]
    cases += [(3, 5, (9, 17, 33), "edge", "leaky", True, 0),
              (20, 12, (5, 6, 7), "zero", "leaky", True, 0)]
    for cin, cout, dhw, pad, act, res, count in cases:
        nb = B if count else 1
        x = randn(nb, cin, *dhw).to(bf16)
        k = randn(3, 3, 3, cin, cout, scale=(27 * cin) ** -0.5)
        bias = randn(cout, scale=0.1)
        r = randn(nb, cout, *dhw).to(bf16) if res else None
        nvox = nb * dhw[0] * dhw[1] * dhw[2]
        xp = F.pad(x, (1,) * 6, mode="replicate" if pad == "edge"
                   else "constant")
        w = k.permute(4, 3, 0, 1, 2).to(bf16).contiguous()
        kw = dict(act=act, pad_mode=pad)
        at = (f"@{dhw[0]}^3" if count else "@" + "x".join(map(str, dhw)))
        row = compare(
            f"conv3_planes_bf16 {cin}->{cout} {at} {pad} {act}"
            f"{' +residual' if res else ''}",
            lambda: K.conv3_planes_bf16(x, k, bias, r, **kw),
            lambda: K.conv3_planes_ref(x, k, bias, r, **kw), iters=5,
            library_fn=lambda: F.conv3d(xp, w, bias.to(bf16)),
            moved=nbytes(x, k, bias, r) + 2 * cout * nvox,
            # the sums are f32 FMAs
            ops=[(2 * 27 * cin * cout * nvox, "f32")], tag=tag,
            repeats=True, bf16_ulp=True,
            slower=CONV3P_SLOWER if count else None)
        row["per_forward"] = count
        rows["conv3_planes_bf16"].append(row)
    del x, xp, r

    def f64_check(row, kernel_fn, plain_fn, f64_fn):
        """The f32-output form of the kernel against float64, beside the
        library's f32 conv (TF32 off) of the widened operands."""
        chk = compare(row["shape"] + " f32 out", kernel_fn, plain_fn,
                      iters=1, tag=tag, f64_fn=f64_fn)
        row.update(err_vs_f64=chk["err_vs_f64"],
                   plain_err_vs_f64=chk["plain_err_vs_f64"])

    # K2-bf16 at the serving shape, then two ragged volumes
    for vol, relu, count in [((B, STEM_N, STEM_N, STEM_N), True, 1),
                             ((1, 5, 6, 7), True, 0),
                             ((1, 9, 17, 33), False, 0)]:
        x = torch.rand((*vol, 1), generator=g, device=dev).to(bf16)
        k = randn(7, 7, 7, 1, 64, scale=343 ** -0.5).to(bf16)
        scale = torch.rand(64, generator=g, device=dev) + 0.5
        shift = randn(64, scale=0.1)
        x_ncdhw = x.permute(0, 4, 1, 2, 3)
        w = k.permute(4, 3, 0, 1, 2).contiguous()
        if not torch.equal(k2.prepare_weights_bf16(k),
                           k2.prepare_weights_bf16_ref(k)):
            raise RuntimeError("stem_conv_raw_bf16: prepared weights differ "
                               "from the plain version")

        def stem64(relu=relu):
            y = F.conv3d(x_ncdhw.double(), w.double(), padding=3)
            y = y.permute(0, 2, 3, 4, 1) * scale.double() + shift.double()
            return y.clamp_min(0.0) if relu else y

        at = "x".join(map(str, vol))
        row = compare(
            f"stem_conv_raw_bf16 ({at},1)->64{'' if relu else ' no relu'}",
            lambda: K.stem_conv_raw_bf16(x, k, scale, shift, relu),
            lambda: K.stem_conv_raw_ref(x, k, scale, shift, relu),
            iters=5 if count else 20,
            library_fn=lambda: F.conv3d(x_ncdhw, w, padding=3),
            moved=nbytes(x, k, scale, shift) + 2 * 64 * x.numel(),
            ops=[(2 * 343 * 64 * x.numel(), "bf16")], tag=tag, repeats=True,
            bf16_ulp=True, slower=CONV3P_SLOWER if count else None)
        if count:
            row["bound_share"] = row["bound_ms"] / row["ms_median"]
            log(f"[{tag}] {row['shape']}: {row['bound_share']:.1%} of its "
                f"bound ({row['bound_ms']:.4f} ms, {row['bound_by']}), "
                f"{row['ms_median'] / row['library_ms_median']:.3f} x its "
                "library call")
        f64_check(row, lambda: K.stem_conv_raw_bf16(
                      x, k, scale, shift, relu, out_dtype=torch.float32),
                  lambda: K.stem_conv_raw_ref(x.float(), k.float(), scale,
                                              shift, relu), stem64)
        row.update(per_forward=count, prep_ms=cuda_ms(
            lambda: k2.prepare_weights_bf16(k), 20))
        rows["stem_conv_raw_bf16"].append(row)

    # K3-bf16 on the stem's bf16 output (post-ReLU: many exact-zero ties),
    # then an odd volume off the path
    x = torch.rand((B, STEM_N, STEM_N, STEM_N, 1), generator=g,
                   device=dev).to(bf16)
    k = randn(7, 7, 7, 1, 64, scale=343 ** -0.5).to(bf16)
    y = K.stem_conv_raw_bf16(x, k, torch.rand(64, generator=g, device=dev)
                             + 0.5, randn(64, scale=0.1) - 0.5)
    for y, count in ((y, 1), (randn(1, 9, 10, 11, 64).to(bf16), 0)):
        zeros = (y == 0).float().mean().item()
        y_ncdhw = y.permute(0, 4, 1, 2, 3)
        out = 2 * y.shape[0] * 64 * np.prod(
            [(n - 1) // 2 + 1 for n in y.shape[1:4]])
        row = compare(
            f"maxpool3d_k3s2p1_bf16 {tuple(y.shape)} ({zeros:.0%} zeros)",
            lambda: K.maxpool3d_k3s2p1_bf16(y),
            lambda: K.maxpool3d_k3s2p1_ref(y), iters=10, exact=True,
            library_fn=lambda: F.max_pool3d(y_ncdhw, 3, 2, 1),
            moved=nbytes(y) + int(out), tag=tag, repeats=True)
        row["per_forward"] = count
        rows["maxpool3d_k3s2p1_bf16"].append(row)
    del x, y, y_ncdhw

    # K4-bf16: the path's three shapes with the bn2 epilogue, then ragged
    # volumes with and without it
    cases = [(c, (B, n, n, n), count, (True,)) for c, n, count in K4_SHAPES]
    cases += [(c, (1, *dhw), 0, (True, False)) for c, dhw in K4_RAGGED]
    for c, vol, count, epilogues in cases:
        x = randn(*vol, c).to(bf16)
        k = randn(3, 3, 3, c, c, scale=(27 * c) ** -0.5).to(bf16)
        sc = torch.rand(c, generator=g, device=dev) + 0.5
        sh = randn(c, scale=0.1)
        x_ncdhw = x.permute(0, 4, 1, 2, 3)
        w = k.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        if not torch.equal(k4.prepare_weights_bf16(k),
                           k4.prepare_weights_bf16_ref(k)):
            raise RuntimeError(f"conv3_mxu_bf16 c{c}: prepared weights "
                               "differ from the plain version")
        at = f"c{c}@{'x'.join(map(str, vol[1:]))} b{vol[0]}"
        flop = 2 * 27 * c * c * (x.numel() // c)
        for epi in epilogues:
            e = dict(scale=sc, shift=sh, relu=True) if epi else {}

            def conv64(e=e):
                y = F.conv3d(x_ncdhw.double(), w.double(),
                             padding=1).permute(0, 2, 3, 4, 1)
                if e:
                    y = (y * sc.double() + sh.double()).clamp_min(0.0)
                return y

            row = compare(
                f"conv3_mxu_bf16 {at}{' +bn+relu' if epi else ''}",
                lambda: K.conv3_mxu_bf16(x, k, **e),
                lambda: K.conv3_mxu_ref(x, k, **e), iters=5,
                library_fn=lambda: F.conv3d(x_ncdhw, w, padding=1),
                moved=nbytes(x, k, sc, sh, x), ops=[(flop, "bf16")], tag=tag,
                repeats=True, bf16_ulp=True,
                slower=K4_BF16_SLOWER[c] if count else None)
            if count:
                row["bound_share"] = row["bound_ms"] / row["ms_median"]
                log(f"[{tag}] {row['shape']}: {row['bound_share']:.1%} of "
                    f"its bound ({row['bound_ms']:.4f} ms, "
                    f"{row['bound_by']}), "
                    f"{row['ms_median'] / row['library_ms_median']:.3f} x "
                    "its library call")
            f64_check(row, lambda: K.conv3_mxu_bf16(
                          x, k, **e, out_dtype=torch.float32),
                      lambda: K.conv3_mxu_ref(x.float(), k.float(), **e),
                      conv64)
            row["per_forward"] = count
            rows["conv3_mxu_bf16"].append(row)
    del x, x_ncdhw
    torch.cuda.empty_cache()
    return rows


def phase_serve_bf16(dev, smi, f32_serve):
    """The bf16 kernels' rows, then the bf16 server on phase 4's weights
    and captures.  Every reading is taken and logged before a check may
    fail."""
    from hiddenpose_tpu_torch.ops import kernels as K
    from hiddenpose_tpu_torch.serve import InferenceServer

    rows = bf16_rows(dev)
    tag = "9 serve bf16"
    cfg, caps = t128_captures(9)
    server = InferenceServer(cfg, t128_weights(cfg), batch_size=B,
                             dtype="bfloat16", device=dev)
    try:
        t0 = time.perf_counter()
        server.warmup()
        log(f"[{tag}] warm-up request {time.perf_counter() - t0:.2f} s")
        lat1 = []
        for c in caps[:5]:
            t0 = time.perf_counter()
            server.infer(c)
            lat1.append(time.perf_counter() - t0)

        before = server.stats()
        K.reset_launch_counts()
        t_sub, t_done, futs = {}, {}, []
        start = time.perf_counter()
        for i, c in enumerate(caps):
            t_sub[i] = time.perf_counter()
            f = server.submit(c)
            f.add_done_callback(
                lambda _f, i=i: t_done.__setitem__(i, time.perf_counter()))
            futs.append(f)
        results = [f.result(timeout=600)["joints"] for f in futs]
        wall = time.perf_counter() - start
        counts = K.launch_counts()
        batches = server.stats()["batches"] - before["batches"]
        lat = sorted(t_done[i] - t_sub[i] for i in range(len(caps)))
        log(f"[{tag}] {len(caps)} requests in {batches} batches in "
            f"{wall:.3f} s: {len(caps) / wall:.3f} volumes/s, p50 latency "
            f"{lat[len(lat) // 2] * 1000:.1f} ms under the burst; closed-loop"
            f" p50 {sorted(lat1)[2] * 1000:.1f} ms  [{smi}]")
        log(f"[{tag}] launch counts over the burst: {counts}")
        f32_in = sum(K1_SHAPES[i][6] for i in K1_F32_INPUT_SERVE)
        per_forward = {
            "conv3_planes": f32_in,
            "conv3_planes_bf16": sum(row[6] for row in K1_SHAPES) - f32_in,
            "stem_conv_raw_bf16": 1, "maxpool3d_k3s2p1_bf16": 1,
            "conv3_mxu_bf16": sum(row[2] for row in K4_SHAPES)}
        want = {k: per_forward.get(k, 0) * batches for k in counts}

        p_wall, p_busy, idle = idle_share(lambda: [
            f.result(timeout=600) for f in [server.submit(c) for c in caps]])
        log(f"[{tag}] a second burst under torch.profiler: wall "
            f"{p_wall:.4f} s, device busy {p_busy:.4f} s, idle share "
            f"{idle:.4f}")

        f32_joints = np.asarray(f32_serve["joints"], np.float32)
        d32 = np.abs(np.stack(results) - f32_joints)
        log(f"[{tag}] joints of the 9 captures against the float32 "
            f"server's (phase 4): mean |d| {d32.mean():.3e} voxels "
            f"(tolerance {BF16_JOINT_MEAN_TOL}), median "
            f"{np.median(d32):.3e}, max {d32.max():.3e}; float32 joints "
            f"spread {float(np.ptp(f32_joints)):.3f} voxels")

        with deterministic():
            alone = [server.infer(c)["joints"] for c in caps[:5]]
            batched = [f.result(timeout=600)["joints"]
                       for f in [server.submit(c) for c in caps[:5]]]
        d = float(np.abs(np.stack(batched) - np.stack(alone)).max())
        log(f"[{tag}] captures 0-4 alone vs in batches: max |d joints| "
            f"{d:.3e} voxels (tolerance {BATCH_TOL})")
    finally:
        server.close()
    del server
    torch.cuda.empty_cache()
    e2e = bf16_e2e(dev, cfg, t128_weights(cfg), caps[:BF16_E2E_CAPTURES])
    a = e2e["all"]
    log(f"[{tag}] over {BF16_E2E_CAPTURES} captures in batches of {B}: "
        f"kernels vs plain, heatmap RMS {a['kp_hm_rms']:.3e} of the plain "
        f"one's (tolerance {BF16_KP_HM_RMS_TOL}), max |d| "
        f"{a['kp_hm_max']:.3e} of its max, joints mean |d| "
        f"{a['kp_joints_mean']:.3e} voxels (tolerance "
        f"{BF16_KP_JOINT_MEAN_TOL}), max {a['kp_joints_max']:.3e}; against "
        f"the float32 model: heatmap RMS {a['f32_hm_rms']:.3e} of its RMS "
        f"(tolerance {BF16_VS_F32_HM_RMS_TOL}; {a['f32_hm_rms'] / a['rounded_hm_rms']:.2f}"
        f" x the f32 heatmaps rounded once, {a['rounded_hm_rms']:.3e}, at "
        f"least {BF16_AWAY_ROUNDED}; "
        f"{a['f32_hm_rms'] / a['plain_f32_hm_rms']:.3f} x the plain "
        f"versions', {a['plain_f32_hm_rms']:.3e}, at least "
        f"{BF16_AWAY_PLAIN}), max |d| {a['f32_hm_max']:.3e} of its max, "
        f"joints mean |d| {a['f32_joints_mean']:.3e} voxels (tolerance "
        f"{BF16_JOINT_MEAN_TOL}), max {a['f32_joints_max']:.3e}; forward "
        f"b{B}: kernels {e2e['forward_ms_kernels']:.2f} ms, plain "
        f"{e2e['forward_ms_plain']:.2f} ms")
    b8 = serve_bf16_batch8(dev, smi, cfg, caps, results, per_forward)

    for j in results + b8.pop("results"):
        if j.shape != (24, 3) or not np.isfinite(j).all():
            raise RuntimeError(f"bad joints {j.shape}")
    if counts != want or min(counts[k] for k in K.SERVING_BF16) <= 0:
        raise RuntimeError(f"launch counts {counts}, expected {want}")
    if not (e2e["heatmaps_bf16_finite"]
            and a["kp_hm_rms"] <= BF16_KP_HM_RMS_TOL
            and a["kp_joints_mean"] <= BF16_KP_JOINT_MEAN_TOL):
        raise RuntimeError("bf16: kernels and plain versions disagree")
    if not (a["f32_hm_rms"] <= BF16_VS_F32_HM_RMS_TOL
            and a["f32_joints_mean"] <= BF16_JOINT_MEAN_TOL
            and d32.mean() <= BF16_JOINT_MEAN_TOL):
        raise RuntimeError("bf16: too far from the float32 model")
    if not (a["f32_hm_rms"] >= BF16_AWAY_ROUNDED * a["rounded_hm_rms"]
            and a["f32_hm_rms"] >= BF16_AWAY_PLAIN * a["plain_f32_hm_rms"]):
        raise RuntimeError("bf16: too close to the float32 model for a "
                           "path that rounds to bf16 where JAX does")
    if d > BATCH_TOL:
        raise RuntimeError("bf16: per-request result depends on the batch")
    if b8["launches"] != b8["launches_expected"]:
        raise RuntimeError(f"batch 8: launch counts {b8['launches']}, "
                           f"expected {b8['launches_expected']}")
    if not b8["vs_b2_joints_mean_abs"] <= BF16_JOINT_MEAN_TOL:
        raise RuntimeError("bf16: batch 8 and batch 2 disagree")
    serve = dict(requests=len(caps), wall_s=wall,
                 volumes_per_s=len(caps) / wall,
                 p50_latency_ms=lat[len(lat) // 2] * 1000,
                 closed_loop_p50_ms=sorted(lat1)[2] * 1000, batches=batches,
                 launches=counts, profiled_wall_s=p_wall,
                 profiled_busy_s=p_busy, idle_share=idle, end_to_end=e2e,
                 vs_f32_joints_max_abs=float(d32.max()),
                 vs_f32_joints_mean_abs=float(d32.mean()),
                 alone_vs_batched=d, batch8=b8)
    return rows, counts, serve


def bf16_e2e(dev, cfg, weights, caps):
    """The bf16 model end to end on ``caps`` in batches of B, under
    deterministic algorithms: its forward with the kernels (``k``) and
    with the plain versions (``p``), and a float32 model's (``32``), on
    the same weights and the same captures rounded to bf16 (as the bf16
    server sends them).  For each pair (``kp``: k vs p; ``f32``: k vs 32;
    ``plain_f32``: p vs 32; ``rounded``: the float32 heatmaps rounded once
    to bf16 vs 32), per batch and over all: the heatmaps' RMS difference
    over the second one's RMS (``_hm_rms``), their largest difference over
    its largest value (``_hm_max``), and the joints' mean and largest
    distance in voxels."""
    import dataclasses

    from hiddenpose_tpu_torch.models.nlospose import build_nlospose
    from hiddenpose_tpu_torch.train.step import make_forward

    fwd = {}
    for dt in ("bfloat16", "float32"):
        m, lct = build_nlospose(dataclasses.replace(
            cfg.model, compute_dtype=dt), device=dev)
        m.load_state_dict(weights)
        fwd[dt] = (make_forward(m), lct, m)
    (fb, lb, mb), (f32, l32, _) = fwd["bfloat16"], fwd["float32"]
    pairs = (("kp", "k", "p"), ("f32", "k", "32"), ("plain_f32", "p", "32"),
             ("rounded", "r", "32"))
    # per pair: sum d^2, sum ref^2, sum |d joints|, max |d joints|,
    # max |d| / max |ref| of a batch
    sums = {name: [0.0, 0.0, 0.0, 0.0, 0.0] for name, _, _ in pairs}
    batches, finite, ms = [], True, {}
    for i in range(0, len(caps), B):
        meas = torch.from_numpy(np.stack(caps[i:i + B])).to(dev).to(
            torch.bfloat16)
        hm, jt = {}, {}
        for flag, key in ((True, "k"), (False, "p")):
            mb.set_use_kernels(flag)
            if i == 0:
                ms[key] = cuda_ms(lambda: fb(meas, lb), iters=5)
            with deterministic():
                j, h = fb(meas, lb)
            finite = finite and h.dtype == torch.bfloat16 and bool(
                torch.isfinite(h.float()).all())
            hm[key], jt[key] = h.float(), j.float()
        mb.set_use_kernels(True)
        with deterministic():
            jt["32"], hm["32"] = f32(meas.float(), l32)
        hm["r"], jt["r"] = hm["32"].to(torch.bfloat16).float(), jt["32"]
        row = {}
        for name, a, b in pairs:
            d2 = (hm[a] - hm[b]).square().sum().item()
            r2 = hm[b].square().sum().item()
            dj = (jt[a] - jt[b]).abs()
            dmax = ((hm[a] - hm[b]).abs().max()
                    / hm[b].abs().max()).item()
            row.update({f"{name}_hm_rms": (d2 / r2) ** 0.5,
                        f"{name}_hm_max": dmax,
                        f"{name}_joints_mean": dj.mean().item(),
                        f"{name}_joints_max": dj.max().item()})
            acc = sums[name]
            acc[0] += d2
            acc[1] += r2
            acc[2] += dj.sum().item()
            acc[3] = max(acc[3], dj.max().item())
            acc[4] = max(acc[4], dmax)
        batches.append(row)
        del hm, jt
    n = len(caps) * 24 * 3
    total = {}
    for name, acc in sums.items():
        total.update({f"{name}_hm_rms": (acc[0] / acc[1]) ** 0.5,
                      f"{name}_hm_max": acc[4],
                      f"{name}_joints_mean": acc[2] / n,
                      f"{name}_joints_max": acc[3]})
    del fwd, mb
    torch.cuda.empty_cache()
    return {"all": total, "batches": batches, "heatmaps_bf16_finite": finite,
            "forward_ms_kernels": ms["k"], "forward_ms_plain": ms["p"]}


def serve_bf16_batch8(dev, smi, cfg, caps, b2_joints, per_forward):
    """The bf16 server at batch 8 on 16 requests (the 9 captures, then the
    first 7 again: two full batches); its joints of the 9 captures against
    the batch-2 server's, whose convolutions may take other algorithms at
    another batch size (so they are held as two bf16 forwards are)."""
    from hiddenpose_tpu_torch.ops import kernels as K
    from hiddenpose_tpu_torch.serve import InferenceServer

    tag = "9 serve bf16"
    reqs = list(caps) + list(caps[:7])
    torch.cuda.reset_peak_memory_stats(dev)
    server = InferenceServer(cfg, t128_weights(cfg), batch_size=8,
                             dtype="bfloat16", device=dev)
    try:
        server.warmup()
        before = server.stats()["batches"]
        K.reset_launch_counts()
        t_sub, t_done, futs = {}, {}, []
        start = time.perf_counter()
        for i, c in enumerate(reqs):
            t_sub[i] = time.perf_counter()
            f = server.submit(c)
            f.add_done_callback(
                lambda _f, i=i: t_done.__setitem__(i, time.perf_counter()))
            futs.append(f)
        results = [f.result(timeout=600)["joints"] for f in futs]
        wall = time.perf_counter() - start
        counts = K.launch_counts()
        batches = server.stats()["batches"] - before
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        server.close()
    lat = sorted(t_done[i] - t_sub[i] for i in range(len(reqs)))
    d = np.abs(np.stack(results[:len(caps)]) - np.stack(b2_joints))
    want = {k: per_forward.get(k, 0) * batches for k in counts}
    log(f"[{tag}] batch 8: {len(reqs)} requests in {batches} batches in "
        f"{wall:.3f} s: {len(reqs) / wall:.3f} volumes/s, p50 latency "
        f"{lat[len(lat) // 2] * 1000:.1f} ms; launch counts "
        f"{ {k: v for k, v in counts.items() if v} }; joints against the "
        f"batch-2 server's: mean |d| {d.mean():.3e} voxels (tolerance "
        f"{BF16_JOINT_MEAN_TOL}), max {d.max():.3e}; peak memory "
        f"{peak / 2**30:.3f} GiB  [{smi}]")
    return dict(requests=len(reqs), batches=batches, wall_s=wall,
                volumes_per_s=len(reqs) / wall,
                p50_latency_ms=lat[len(lat) // 2] * 1000, launches=counts,
                launches_expected=want, vs_b2_joints_mean_abs=float(d.mean()),
                vs_b2_joints_max_abs=float(d.max()), peak_memory_bytes=peak,
                results=results)


def dx_bf16_rows(dev, smi):
    """K4-dx-bf16 at the three conv2 shapes of a t128 b2 train step and at
    one ragged volume: its bf16-output form (the bf16 model's) within one
    bf16 ulp of its plain version, twice bit for bit, beside the library's
    ``conv3d_input`` on the same bf16 channels-last tensors (medians of 20
    readings each, at most CONV3P_SLOWER times its time) and its bound; its
    f32-output form (the f32 model's, f32 dz rounded by the wrapper)
    against its plain version and against float64 within F64_ERR_FACTOR
    times the library f32 conv's error, and its time."""
    from torch.nn.grad import conv3d_input

    from hiddenpose_tpu_torch.ops import kernels as K
    from hiddenpose_tpu_torch.ops.kernels import conv3mxu as k4

    g = torch.Generator(device=dev).manual_seed(10)
    bf16, tag = torch.bfloat16, "10 train precision"
    rows = []
    cases = [(c, (B, n, n, n), count) for c, n, count in K4_SHAPES]
    cases.append((64, (1, 5, 6, 7), 0))
    for c, vol, count in cases:
        dz = torch.randn((*vol, c), generator=g, device=dev)
        k = torch.randn((3, 3, 3, c, c), generator=g,
                        device=dev) * (27 * c) ** -0.5
        dzb, kb = dz.to(bf16), k.to(bf16)
        if not torch.equal(k4.prepare_weights_bf16(kb, transposed=True),
                           k4.prepare_weights_bf16_ref(kb, transposed=True)):
            raise RuntimeError(f"conv3_mxu_dx_bf16 c{c}: prepared weights "
                               "differ from the plain version")
        dz_ncdhw = dzb.permute(0, 4, 1, 2, 3)  # channels-last view
        w = kb.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        at = f"c{c}@{'x'.join(map(str, vol[1:]))} b{vol[0]}"
        flop = 2 * 27 * c * c * (dz.numel() // c)
        row = compare(
            f"conv3_mxu_dx_bf16 {at}",
            lambda: K.conv3_mxu_dx_bf16(dzb, kb, out_dtype=bf16),
            lambda: K.conv3_mxu_dx_bf16_ref(dzb, kb, out_dtype=bf16),
            iters=5,
            library_fn=lambda: conv3d_input(dz_ncdhw.shape, w, dz_ncdhw,
                                            padding=1),
            moved=nbytes(dzb, kb, dzb), ops=[(flop, "bf16")], tag=tag,
            repeats=True, bf16_ulp=True,
            slower=CONV3P_SLOWER if count else None)
        if count:
            row["bound_share"] = row["bound_ms"] / row["ms_median"]
            log(f"[{tag}] {row['shape']}: {row['bound_share']:.1%} of its "
                f"bound ({row['bound_ms']:.4f} ms, {row['bound_by']}), "
                f"{row['ms_median'] / row['library_ms_median']:.3f} x its "
                f"library call  [{smi}]")

        def dx64():
            return conv3d_input(
                dz_ncdhw.shape, w.double(), dz_ncdhw.double(),
                padding=1).permute(0, 2, 3, 4, 1)

        chk = compare(
            f"conv3_mxu_dx_bf16 {at} f32 dz, f32 out",
            lambda: K.conv3_mxu_dx_bf16(dz, k),
            lambda: K.conv3_mxu_dx_bf16_ref(dz, k), iters=5, tag=tag,
            repeats=True, moved=nbytes(dz, k, dz), ops=[(flop, "bf16")],
            f64_fn=dx64)
        row.update(per_step=count, err_vs_f64=chk["err_vs_f64"],
                   plain_err_vs_f64=chk["plain_err_vs_f64"],
                   f32_model_ms=chk["ms"], f32_model_max_abs_err=chk[
                       "max_abs_err"])
        rows.append(row)
    del dz, dzb, dz_ncdhw
    torch.cuda.empty_cache()
    return rows


def _step_result(model, weights, step, batch, lct, use_kernels):
    """One train step from ``weights`` under deterministic algorithms:
    its losses, gradients, new parameters and new running statistics."""
    from hiddenpose_tpu_torch.config import TrainConfig
    from hiddenpose_tpu_torch.train.state import TrainState

    model.load_state_dict(weights)
    model.set_use_kernels(use_kernels)
    st = TrainState.create(model, TrainConfig())
    with deterministic(warn_only=True):
        met = step(st, batch, lct)
    torch.cuda.synchronize()
    model.set_use_kernels(True)
    return dict(
        loss={k: v.item() for k, v in met.items()},
        grads={n: p.grad.detach().clone()
               for n, p in model.named_parameters()},
        params={n: p.detach().clone() for n, p in model.named_parameters()},
        stats={n: b.clone() for n, b in model.named_buffers()
               if n.endswith(("running_mean", "running_var"))})


def _log_readings(tag, name, r):
    log(f"[{tag}] {name}: loss rel {r['loss_rel']}; grads rel L2 "
        f"{r['grad_rel_l2']}; new running stats max rel "
        f"{r['stats_max_rel']:.3e}; new params max abs err where the "
        f"gradients agree {r['param_max_abs']:.3e}; large gradient elements "
        f"of one sign {r['sign_agree']:.5f}")


def _timed_steps(tag, dev, step, state, batch, lct, n, per_step, smi):
    """``n`` Adam steps from the counts at 0: losses and ms by CUDA events,
    peak memory, the launch counts, which must be ``n`` x ``per_step``;
    the TF32 flags must read after each step as before it."""
    from hiddenpose_tpu_torch.ops import kernels as K

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    steps = []
    for i in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(state, batch, lct)
        end.record()
        torch.cuda.synchronize()
        steps.append(dict({k: v.item() for k, v in metrics.items()},
                          ms=start.elapsed_time(end)))
        after = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        log(f"[{tag}] step {i}: loss {steps[-1]['loss']:.6g} (joint "
            f"{steps[-1]['joint_loss']:.6g}, voxel "
            f"{steps[-1]['voxel_loss']:.6g}) in {steps[-1]['ms']:.2f} ms; "
            f"TF32 flags after the step {after}")
        if after != flags:
            raise RuntimeError(f"{tag}: the step left the TF32 flags at "
                               f"{after}, not {flags}")
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[{tag}] peak memory {peak / 2**30:.3f} GiB; launch counts over "
        f"{n} steps: {counts}  [{smi}]")
    want = {k: n * per_step.get(k, 0) for k in counts}
    if counts != want:
        raise RuntimeError(f"{tag}: launch counts {counts}, expected {want}")
    if not all(np.isfinite(s_[k]) for s_ in steps
               for k in ("loss", "joint_loss", "voxel_loss")):
        raise RuntimeError(f"{tag}: a train step's loss is not finite")
    return dict(steps=steps, peak_memory_bytes=peak, launches=counts), counts


def phase_train_precision(dev, smi, highest):
    """The train step at the JAX package's default precision and in bf16:
    K4-dx-bf16's rows; (a) the f32 model at 'default': 3 Adam steps, one
    step with kernels vs one with plain versions, and its distance from
    phase 6's 'highest' step (``highest``) against that step's own
    spread; (b) the f32 model at 'high': one step; (c) the bf16 model at
    'default': 3 steps, kernels vs plain, and its distance from the f32
    'default' step."""
    from hiddenpose_tpu_torch.config import TrainConfig, t128_config
    from hiddenpose_tpu_torch.data.synthetic import make_batch
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose
    from hiddenpose_tpu_torch.ops import kernels as K
    from hiddenpose_tpu_torch.train.state import TrainState
    from hiddenpose_tpu_torch.train.step import make_train_step

    tag = "10 train precision"
    rows = dx_bf16_rows(dev, smi)
    cfg = t128_config()
    m = cfg.model
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        [0, 1], m.time_size, m.image_size[0], m.grid_dim, m.heatmap_size[0],
        m.bin_len).items()}
    weights = t128_weights(cfg)
    res, counts = {}, {}

    def run(name, model, lct, precision, n, per_step):
        step = make_train_step(model, matmul_precision=precision)
        state = TrainState.create(model, TrainConfig())
        model.load_state_dict(weights)
        r, c = _timed_steps(f"{tag}] [{name}", dev, step, state, batch, lct,
                            n, per_step, smi)
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        res[name] = r
        return step

    # (a), (b): the f32 model
    model, lct = build_nlospose(m, device=dev)
    step = run("f32 default", model, lct, "default", 3, TRAIN_DEFAULT_PER_STEP)
    kern32 = _step_result(model, weights, step, batch, lct, True)
    plain32 = _step_result(model, weights, step, batch, lct, False)
    vs = _train_readings(kern32, plain32)
    _log_readings(tag, "f32 default, kernels vs plain", vs)
    away = _train_readings(kern32, _step_to(highest["step"], dev))
    _log_readings(tag, "f32 default vs phase 6's 'highest' step", away)
    spread = highest["spread"]["grad_rel_l2"]
    ok = (max(vs["loss_rel"].values()) <= DEFAULT_LOSS_TOL
          and max(vs["grad_rel_l2"].values()) <= DEFAULT_GRAD_L2_TOL
          and vs["stats_max_rel"] <= DEFAULT_STATS_TOL
          and vs["sign_agree"] >= DEFAULT_SIGN_AGREE)
    log(f"[{tag}] f32 default, kernels vs plain: limits loss "
        f"{DEFAULT_LOSS_TOL}, grads rel L2 {DEFAULT_GRAD_L2_TOL}, stats "
        f"{DEFAULT_STATS_TOL}, one sign >= {DEFAULT_SIGN_AGREE}: "
        f"{'pass' if ok else 'FAIL'}; from 'highest' by module "
        f"{away['grad_rel_l2']} against phase 6's spread {spread}")
    if not ok:
        raise RuntimeError("f32 default step: kernels and plain disagree")
    if not all(away["grad_rel_l2"][mod] > DEFAULT_AWAY * spread[mod]
               for mod in spread):
        raise RuntimeError("the 'default' step's gradients lie within the "
                           "'highest' step's own spread: no bf16 pass?")
    res["f32 default"].update(kernels_vs_plain=vs, vs_highest=away)
    del plain32
    run("f32 high", model, lct, "high", 1, TRAIN_PER_STEP)
    del model, lct
    torch.cuda.empty_cache()

    # (c): the bf16 model
    model, lct = build_nlospose(cfg.with_bf16().model, device=dev)
    step = run("bf16 default", model, lct, "default", 3, TRAIN_BF16_PER_STEP)
    kern16 = _step_result(model, weights, step, batch, lct, True)
    plain16 = _step_result(model, weights, step, batch, lct, False)
    vs16 = _train_readings(kern16, plain16)
    _log_readings(tag, "bf16 default, kernels vs plain", vs16)
    del plain16
    to32 = _train_readings(kern16, kern32)
    _log_readings(tag, "bf16 default vs f32 default (kernels)", to32)
    ok = (max(vs16["loss_rel"].values()) <= BF16_TRAIN_LOSS_TOL
          and max(vs16["grad_rel_l2"].values()) <= BF16_TRAIN_GRAD_L2_TOL
          and vs16["stats_max_rel"] <= BF16_TRAIN_STATS_TOL
          and vs16["sign_agree"] >= BF16_TRAIN_SIGN_AGREE
          and max(to32["loss_rel"].values())
          >= BF16_TRAIN_AWAY * max(vs["loss_rel"].values())
          and to32["stats_max_rel"] >= BF16_TRAIN_AWAY * vs["stats_max_rel"])
    log(f"[{tag}] bf16 default: limits kernels vs plain loss "
        f"{BF16_TRAIN_LOSS_TOL}, grads rel L2 {BF16_TRAIN_GRAD_L2_TOL}, "
        f"stats {BF16_TRAIN_STATS_TOL}, one sign >= {BF16_TRAIN_SIGN_AGREE}"
        f"; losses and stats from the f32 step "
        f"at least {BF16_TRAIN_AWAY} x the f32 kernels-vs-plain distance: "
        f"{'pass' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("bf16 default step: outside its limits")
    res["bf16 default"].update(kernels_vs_plain=vs16, vs_f32_default=to32)
    del model, lct, kern16, kern32
    torch.cuda.empty_cache()
    return {"conv3_mxu_dx_bf16": rows}, counts, res


def phase_probes(dev):
    """The four stem probes, through the script a user would run; then
    each probe kernel against its plain version (A and B exact, two calls
    bit-identical), and its device time, the host's time a launch and its
    bound (``scripts/torch_probe_times.py``)."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_diag_stem_paired as diag

    from hiddenpose_tpu_torch.ops import kernels as K
    from hiddenpose_tpu_torch.ops.kernels import _build

    K.reset_launch_counts()
    results = diag.run_probes(dev)
    counts = K.launch_counts()
    for r in results:
        log(f"[8 probes] {r['probe']}: max err {r['err']:.3e} (limit "
            f"{r['tol']:g}) {'ok' if r['ok'] else 'FAILED'}")
    want = {k: 0 for k in counts}
    want.update(probe_im2col=1, probe_slice_transpose=1, probe_dot_f32=2)
    if counts != want or not all(r["ok"] for r in results):
        raise RuntimeError(f"probes failed: {results}; launches {counts}")

    import torch_probe_times as ptimes

    def device_readings(row, call):
        """Beside the row's time through the wrapper (its ``ms``), the
        probe's device time (a CUDA graph of 50 launches, replayed), the
        host's time a launch with and without ``device=`` and 50 launches
        back to back under CUDA events, each of the launch the wrapper
        ``call`` makes."""
        entry, args, keep = ptimes.recorded_launch(call)
        t = ptimes.time_launch(entry, args, dev)
        del keep
        row.update(t)
        log(f"[8 probes] {row['shape']}: device {t['device_ms']:.5f} ms a "
            f"launch (a graph of 50, median of 20 replays, "
            f"{t['device_ms_range'][0]:.5f}-{t['device_ms_range'][1]:.5f}); "
            f"host {t['launch_us_device']:.2f} us a launch with device=, "
            f"{t['launch_us_stream']:.2f} us without; 50 launches under "
            f"events {t['events_ms']:.5f} ms each; through the wrapper "
            f"{row['ms']:.4f} ms; bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']})")

    inp = diag.probe_inputs(dev)
    rows = {}
    x = inp["x_a"]
    row = compare("probe_im2col (8,8,8,128)->(80,8,128)",
                  lambda: K.probe_im2col(x), lambda: K.probe_im2col_ref(x),
                  iters=20, exact=True, moved=nbytes(x) + 4 * 80 * 8 * 128,
                  tag="8 probes", repeats=True)
    row["per_run"] = 1
    rows["probe_im2col"] = [row]
    device_readings(row, lambda: K.probe_im2col(x))
    xb = inp["x_b"]
    row = compare("probe_slice_transpose (512,128)->2x(64,512)",
                  lambda: K.probe_slice_transpose(xb),
                  lambda: K.probe_slice_transpose_ref(xb), iters=20,
                  exact=True, moved=2 * nbytes(xb), tag="8 probes")
    row["per_run"] = 1
    rows["probe_slice_transpose"] = [row]
    first, second = K.probe_slice_transpose(xb), K.probe_slice_transpose(xb)
    if not all(torch.equal(a_, b_) for a_, b_ in zip(first, second)):
        raise RuntimeError("probe_slice_transpose: two calls differ")
    device_readings(row, lambda: K.probe_slice_transpose(xb))
    rows["probe_dot_f32"] = []
    a = inp["a"]
    for b in (inp["b"], inp["b64"]):
        m, kk = a.shape
        n = b.shape[1]
        scale = K.probe_dot_f32_ref(a, b).abs().max().item()
        row = compare(f"probe_dot_f32 ({m},{kk})@({kk},{n})",
                      lambda: K.probe_dot_f32(a, b),
                      lambda: K.probe_dot_f32_ref(a, b), iters=20,
                      atol=DOT_PROBE_TOL * scale,
                      library_fn=lambda: torch.matmul(a, b),
                      moved=nbytes(a, b) + 4 * m * n,
                      ops=[(2 * m * kk * n, "f32")], tag="8 probes")
        row["per_run"] = 1
        # the launch alone, as the wrapper makes it (``device=``), into a
        # preallocated output, beside the library call into one: 20
        # readings of each, in turns, 50 launches a reading; the medians
        # are compared
        out = torch.empty((m, n), device=dev)
        reads = {"launch": [], "library": []}
        for _ in range(20):
            reads["launch"].append(cuda_ms(lambda: _build.launch(
                "hp_probe_dot_f32", a.data_ptr(), b.data_ptr(),
                out.data_ptr(), m, kk, n, device=dev), iters=50))
            reads["library"].append(cuda_ms(
                lambda: torch.matmul(a, b, out=out), iters=50))
        row["launch_ms"] = float(np.median(reads["launch"]))
        row["library_out_ms"] = float(np.median(reads["library"]))
        row["launch_ms_range"] = [min(reads["launch"]), max(reads["launch"])]
        row["library_out_ms_range"] = [min(reads["library"]),
                                       max(reads["library"])]
        log(f"[8 probes] probe_dot_f32 ({m},{kk})@({kk},{n}): launch alone "
            f"{row['launch_ms']:.4f} ms (median of 20, "
            f"{row['launch_ms_range'][0]:.4f}-{row['launch_ms_range'][1]:.4f}"
            f"), through the wrapper {row['ms']:.4f} ms; torch.matmul(out=) "
            f"{row['library_out_ms']:.4f} ms "
            f"({row['library_out_ms_range'][0]:.4f}-"
            f"{row['library_out_ms_range'][1]:.4f}), allocating "
            f"{row['library_ms']:.4f} ms")
        if not torch.equal(K.probe_dot_f32(a, b), K.probe_dot_f32(a, b)):
            raise RuntimeError("probe_dot_f32: two calls differ")
        device_readings(row, lambda: K.probe_dot_f32(a, b))
        if row["launch_ms"] > PROBE_DOT_SLOWER * row["library_out_ms"]:
            raise RuntimeError(
                f"probe_dot_f32 at N = {n}: the launch takes "
                f"{row['launch_ms']:.4f} ms, more than {PROBE_DOT_SLOWER} x "
                f"torch.matmul(out=)'s {row['library_out_ms']:.4f} ms")
        rows["probe_dot_f32"].append(row)
    return rows, counts, results


# Phase 11: the train loop, its checkpoints, the frozen autoencoder, the
# evaluation harness and the two commands, at t128 on the card.
LOOP_STEPS = 4          # (a): 2 epochs x 2 steps
LOOP_SECONDS = 300      # each command's time limit


def _loop_losses(log_dir, tag="Train Loss"):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in recs if r["tag"] == tag}


def _state_diff(a, b):
    """The names where two TrainStates differ (model state_dict, optimizer
    state and param groups, step); [] when bit for bit equal."""
    bad = []
    sa, sb = a.model.state_dict(), b.model.state_dict()
    bad += [k for k in sa if not torch.equal(sa[k], sb[k].to(sa[k].device))]
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    if oa["param_groups"] != ob["param_groups"]:
        bad.append("param_groups")
    if oa["state"].keys() != ob["state"].keys():
        bad.append("optimizer state keys")
    else:
        bad += [f"optimizer {i} {k}" for i in oa["state"]
                for k in ("step", "exp_avg", "exp_avg_sq")
                if not torch.equal(oa["state"][i][k],
                                   ob["state"][i][k].to(
                                       oa["state"][i][k].device))]
    if a.step != b.step:
        bad.append("step")
    return bad


def _bare_default_steps(dev, cfg, weights, batch):
    """Three bare 'default' steps (what phase 10 times), for a run of
    phase 11 alone: ms of each by CUDA events."""
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose
    from hiddenpose_tpu_torch.train.state import TrainState
    from hiddenpose_tpu_torch.train.step import make_train_step

    model, lct = build_nlospose(cfg.model, device=dev)
    model.load_state_dict(weights)
    step = make_train_step(model, matmul_precision="default")
    state = TrainState.create(model, cfg.train)
    ms = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batch, lct)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return ms


def phase_train_loop(dev, smi, bare_steps=None):
    """(a) ``train()`` at t128 'default' from the peaked weights, 2 epochs of
    2 steps, 4 loader workers; (b) a restored state against the live one
    and a resume from epoch_0; (c) one step with the pretrained, frozen
    autoencoder of (a); (d) ``evaluate()`` against ``make_forward``; (e)
    ``cli.train`` then ``cli.test`` as commands."""
    import dataclasses
    import shutil
    import tempfile

    from hiddenpose_tpu_torch.config import t128_config
    from hiddenpose_tpu_torch.data.dataset import DataPipeline, SyntheticSource
    from hiddenpose_tpu_torch.data.device_prefetch import device_prefetch
    from hiddenpose_tpu_torch.eval.harness import evaluate
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose
    from hiddenpose_tpu_torch.ops import kernels as K
    from hiddenpose_tpu_torch.ops.lct import make_lct_params
    from hiddenpose_tpu_torch.train import checkpoint as ckpt
    from hiddenpose_tpu_torch.train.loop import train
    from hiddenpose_tpu_torch.train.pretrain import save_autoencoder
    from hiddenpose_tpu_torch.train.state import TrainState
    from hiddenpose_tpu_torch.train.step import make_eval_step, make_forward

    tag = "11 train loop"
    base = t128_config()
    m = base.model
    weights = t128_weights(base)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_loop_"))
    out = {}
    try:
        if bare_steps is None:
            from hiddenpose_tpu_torch.data.synthetic import make_batch

            batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
                [0, 1], m.time_size, m.image_size[0], m.grid_dim,
                m.heatmap_size[0], m.bin_len).items()}
            bare_steps = _bare_default_steps(dev, base, weights, batch)
            del batch
            torch.cuda.empty_cache()
        bare = float(np.median(bare_steps[1:]))

        # (a) the loop
        cfg = dataclasses.replace(
            base, num_workers=4, log_dir=str(tmp / "log_a"),
            train=dataclasses.replace(base.train, end_epoch=2))
        torch.cuda.reset_peak_memory_stats(dev)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = train(cfg, source=SyntheticSource(cfg, length=8),
                    workdir=str(tmp / "ck_a"), log_every=1,
                    ckpt_every_iters=3, max_steps_per_epoch=2,
                    weights=weights, device=dev)
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        losses = _loop_losses(cfg.log_dir)
        tm = res.timings
        step_ms = [1e3 * x for x in tm["step_s"]]
        wait_ms = [1e3 * x for x in tm["wait_s"]]
        saves = [dict(name=os.path.basename(p), ms=1e3 * sec,
                      bytes=os.path.getsize(p)) for p, sec in tm["ckpt"]]
        loop_ms = float(np.median(step_ms[1:]))
        log(f"[{tag}] (a) train(): {res.epochs_run} epochs, step "
            f"{res.state.step} in {wall:.1f} s; 'Train Loss' {losses}")
        log(f"[{tag}] (a) the loop's ms a step {[round(x, 2) for x in step_ms]}"
            f" (median after the first {loop_ms:.2f}) beside phase 10's bare "
            f"'default' step {[round(x, 2) for x in bare_steps]} (median "
            f"after the first {bare:.2f}): {loop_ms / bare:.3f} x; blocked "
            f"on the loader {[round(x, 2) for x in wait_ms]} ms a step; "
            f"peak memory {peak / 2**30:.3f} GiB  [{smi}]")
        for sv in saves:
            log(f"[{tag}] (a) checkpoint {sv['name']}: saved in "
                f"{sv['ms']:.1f} ms, {sv['bytes'] / 2**20:.1f} MiB on disk")
        want = {k: LOOP_STEPS * TRAIN_DEFAULT_PER_STEP.get(k, 0)
                for k in counts}
        log(f"[{tag}] (a) launch counts {counts}")
        files = sorted(os.listdir(tmp / "ck_a"))
        if counts != want:
            raise RuntimeError(f"loop launch counts {counts}, expected "
                               f"{want}")
        if sorted(losses) != [1, 2, 3, 4] or not all(
                np.isfinite(v) for v in losses.values()):
            raise RuntimeError(f"loop losses {losses}: want 4 finite")
        if files != ["epoch_0", "epoch_1", "iter_3"]:
            raise RuntimeError(f"loop checkpoints {files}")
        out["a"] = dict(seconds=wall, losses=losses, step_ms=step_ms,
                        loop_ms=loop_ms, bare_step_ms=bare_steps,
                        bare_ms=bare, loader_wait_ms=wait_ms,
                        checkpoints=saves, peak_memory_bytes=peak,
                        launches=counts)

        # (b) restore and resume
        model_b, _ = build_nlospose(m, device=dev)
        fresh = TrainState.create(model_b, cfg.train, steps_per_epoch=2)
        _, epoch, giter = ckpt.restore_checkpoint(str(tmp / "ck_a/epoch_1"),
                                                  fresh)
        diff = _state_diff(fresh, res.state)
        log(f"[{tag}] (b) epoch_1 restored into a fresh state: epoch "
            f"{epoch}, global_iter {giter}, step {fresh.step}; differs from "
            f"the live state in {len(diff)} tensors {diff[:5]}")
        if diff or (epoch, giter) != (1, 4):
            raise RuntimeError("a restored checkpoint is not the saved state")
        payload = torch.load(tmp / "ck_a/epoch_0", map_location=dev,
                             weights_only=True)
        ckpt.restore_checkpoint(str(tmp / "ck_a/epoch_0"), fresh)
        sd, opt = fresh.model.state_dict(), fresh.optimizer.state_dict()
        bad0 = [k for k, v in payload["model"].items()
                if not torch.equal(v, sd[k])]
        bad0 += [f"optimizer {i} {k}"
                 for i, st in payload["optimizer"]["state"].items()
                 for k, v in st.items()
                 if not torch.equal(v, opt["state"][i][k].to(v.device))]
        if bad0 or (payload["epoch"], payload["global_iter"],
                    fresh.step) != (0, 2, 2):
            raise RuntimeError(f"epoch_0 restore differs: {bad0[:5]}")
        log(f"[{tag}] (b) epoch_0 restored: equal to its file (parameters, "
            f"statistics, Adam moments and counts), epoch 0, global_iter 2, "
            f"step 2")
        del model_b, fresh, payload, sd, opt
        cfg_b = dataclasses.replace(cfg, log_dir=str(tmp / "log_b"))
        with deterministic(warn_only=True):
            res_b = train(cfg_b, source=SyntheticSource(cfg_b, length=8),
                          workdir=str(tmp / "ck_b"),
                          resume_from=str(tmp / "ck_a/epoch_0"), log_every=1,
                          max_steps_per_epoch=2, device=dev)
        losses_b = _loop_losses(cfg_b.log_dir)
        d3 = abs(losses_b.get(3, float("nan")) - losses[3])
        log(f"[{tag}] (b) resumed from epoch_0: epochs {res_b.epochs_run}, "
            f"'Train Loss' {losses_b}; the first loss against (a)'s at "
            f"iter 3: |d| {d3:.3e} (relative {d3 / abs(losses[3]):.3e}, "
            f"limit {TRAIN_LOSS_TOL}), "
            f"{'bit-identical' if d3 == 0 else 'not bit-identical'}")
        if sorted(losses_b) != [3, 4] or not d3 <= TRAIN_LOSS_TOL * abs(
                losses[3]):
            raise RuntimeError("the resumed loop's first loss differs")
        out["b"] = dict(losses=losses_b, first_loss_abs_diff=d3,
                        bit_identical=d3 == 0)
        del res_b
        shutil.rmtree(tmp / "ck_b")
        torch.cuda.empty_cache()

        # (c) the pretrained, frozen autoencoder
        unet = save_autoencoder(str(tmp / "unet.pth"), res.state.model)
        pre = torch.load(unet, map_location=dev, weights_only=True)
        cfg_c = dataclasses.replace(
            cfg, log_dir=str(tmp / "log_c"),
            model=dataclasses.replace(m, pretrain_autoencoder=True,
                                      pretrain_autoencoder_path=unet),
            train=dataclasses.replace(cfg.train, end_epoch=1))
        res_c = train(cfg_c, source=SyntheticSource(cfg_c, length=8),
                      workdir=str(tmp / "ck_c"), log_every=1,
                      max_steps_per_epoch=1, weights=weights, device=dev)
        named = dict(res_c.state.model.named_parameters())
        held = res_c.state.optimizer.state
        frozen_bad = [n for n, p in named.items()
                      if n.startswith("autoencoder.")
                      and (not torch.equal(p, pre[n[len("autoencoder."):]])
                           or p in held)]
        still = [n for n, p in named.items()
                 if not n.startswith("autoencoder.")
                 and torch.equal(p, weights[n].to(dev))]
        n_ae = sum(n.startswith("autoencoder.") for n in named)
        log(f"[{tag}] (c) one step with the pretrained autoencoder frozen: "
            f"loss {res_c.last_metrics}; {n_ae} autoencoder tensors, "
            f"{len(frozen_bad)} moved or with optimizer state "
            f"{frozen_bad[:3]}; {len(named) - n_ae} other tensors, "
            f"{len(still)} unmoved {still[:3]}")
        if frozen_bad or still or res_c.state.step != 1:
            raise RuntimeError("the frozen-autoencoder step is wrong")
        out["c"] = dict(loss=res_c.last_metrics, autoencoder_tensors=n_ae,
                        other_tensors=len(named) - n_ae)
        del res_c, named, held, pre
        shutil.rmtree(tmp / "ck_c")
        torch.cuda.empty_cache()

        # (d) evaluation
        model = res.state.model
        lct = make_lct_params(image_size=m.image_size[0],
                              time_size=m.time_size, bin_len=m.bin_len,
                              wall_size=m.wall_size, mode=m.mode,
                              material=m.material, device=dev)
        src = SyntheticSource(cfg, length=4)
        with deterministic():
            t0 = time.perf_counter()
            ev = evaluate(model, res.state, lct, src, batch_size=2,
                          num_workers=2, device=dev)
            ev_wall = time.perf_counter() - t0
            forward = make_forward(model)
            ref = torch.cat([forward(torch.from_numpy(np.stack(
                [src[i]["meas"] for i in (j, j + 1)])).to(dev), lct)[0]
                for j in (0, 2)]).float().cpu().numpy()
        jd = np.abs(ev["pred_joints"] - ref).max()
        eval_step = make_eval_step(model)
        with DataPipeline(src, 2, shuffle=False, num_workers=0) as pipe:
            batches = list(device_prefetch(iter(pipe), dev))
        ev_ms = []
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for bt in batches:
                eval_step(res.state, bt, lct)
            end.record()
            torch.cuda.synchronize()
            ev_ms.append(start.elapsed_time(end))
        ok = all(np.isfinite(ev[k]) for k in ("mpjpe", "pa_mpjpe", "pck"))
        log(f"[{tag}] (d) evaluate(): MPJPE {ev['mpjpe']:.4f}, PA-MPJPE "
            f"{ev['pa_mpjpe']:.4f}, PCK {ev['pck']:.4f} over "
            f"{ev['n_samples']}; joints against make_forward max |d| "
            f"{jd:.3e} voxel (limit {BATCH_TOL}); {ev['n_samples'] / ev_wall:.3f}"
            f" volumes/s over the call ({ev_wall:.2f} s, 2 workers started), "
            f"eval steps alone {[round(x, 2) for x in ev_ms]} ms for 4 "
            f"volumes: {4e3 / ev_ms[-1]:.2f} volumes/s  [{smi}]")
        if not ok or not jd <= BATCH_TOL:
            raise RuntimeError("evaluate() is not finite or disagrees with "
                               "make_forward")
        out["d"] = dict({k: ev[k] for k in ("mpjpe", "pa_mpjpe", "pck",
                                            "n_samples")},
                        joints_max_abs_diff=float(jd), seconds=ev_wall,
                        volumes_per_s=ev["n_samples"] / ev_wall,
                        eval_steps_ms=ev_ms,
                        eval_steps_volumes_per_s=4e3 / ev_ms[-1])
        del res, model, lct, batches, eval_step, forward
        shutil.rmtree(tmp / "ck_a")
        torch.cuda.empty_cache()

        # (e) the commands, each its own process on the card
        size = str(m.grid_dim)
        gpu = "cpu" if dev.type == "cpu" else str(dev.index or 0)
        cmds = {
            "cli.train": ["--synthetic", "--size", size, "--epochs", "1",
                          "--steps-per-epoch", "2", "--model",
                          str(tmp / "ck_e"), "--log", str(tmp / "log_e"),
                          "--device", gpu],
            "cli.test": ["--model", str(tmp / "ck_e"), "--synthetic",
                         "--size", size, "--max-batches", "2", "--out",
                         str(tmp / "out_e"), "--device", gpu],
        }
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        out["e"] = {}
        for name, args in cmds.items():
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", f"hiddenpose_tpu_torch.{name}", *args],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=LOOP_SECONDS)
            sec = time.perf_counter() - t0
            lines = [ln for ln in r.stdout.splitlines()
                     if ln.startswith(("restored", "MPJPE", "finished",
                                       "using"))]
            log(f"[{tag}] (e) python -m hiddenpose_tpu_torch.{name}: exit "
                f"{r.returncode} in {sec:.1f} s; {lines}  [{smi}]")
            out["e"][name] = dict(exit=r.returncode, seconds=sec,
                                  lines=lines)
            if r.returncode != 0:
                log(r.stderr[-4000:])
                raise RuntimeError(f"{name} exited {r.returncode}")
        text = " ".join(out["e"]["cli.test"]["lines"])
        if not ("restored" in text and "epoch_0" in text
                and "MPJPE" in text):
            raise RuntimeError(f"cli.test printed {text!r}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, out["a"]["launches"]


# Phase 12: the other objectives and the 2D pose models.
# 12a, the SimDR step on the full-width Sformer, one step with kernels vs
# one with the plain attention from the same weights: the loss within
# SIMDR_LOSS_TOL relative, every parameter's gradient within
# SIMDR_GRAD_L2_TOL relative L2, the new parameters within TRAIN_PARAM_TOL
# where the two gradients agree, TRAIN_SIGN_AGREE of the large gradient
# elements of one sign.  12d, TokenPose's 2D-heatmap step on the GPU
# against the same step on the CPU: loss and gradients within
# TOKENPOSE_TOL (relative; relative L2 over all), the new parameters as
# 12a's.
SIMDR_LOSS_TOL = 1e-4
# 12b, the posenet2d step, kernels vs plain.  The step cut at visible_net's
# output, its 2D-net part shared (one cotangent for both sides), holds the
# kernels' FeatureExtraction and UNet gradients and the voxel loss at
# TRAIN_* (readings, NVIDIA H100 80GB HBM3, 700 W; PERF.md: 2.4e-4, 2.1e-3,
# 1.1e-7).  The whole step is ill-conditioned in its 2D net: that net's
# part alone, its input's values moved by 1e-7 (relative) with the depths
# kept, moves its gradients 0.023-0.052 (relative L2, three seeds); and
# the plain step on a measurement moved by 1e-7 lies 2.8e-5-1.8e-4 (loss)
# and up to 0.148 (gradients: UNet 0.108-0.148, 2D net 0.077-0.096,
# FeatureExtraction 0.013-0.031) from itself, with no top-4 depth index
# and no min / max voxel of visible_net moving.  Kernels vs plain read
# 1.38e-4 and 0.096 / 0.086 / 0.049 there, inside that spread, so the
# whole step is held at about 1.5 x the spread's largest readings; the
# statistics, new parameters and signs at TRAIN_*.
POSENET2D_LOSS_TOL = 2.8e-4
POSENET2D_GRAD_L2_TOL = 0.21
SIMDR_GRAD_L2_TOL = 1e-3
SIMDR_LAUNCHES_PER_STEP = 16
TOKENPOSE_TOL = 1e-4
# 12b: launches of each kernel in one t128 b2 train step of the posenet2d
# NlosPose (FeatureExtraction and the UNet as in the 3D model; the 2D
# backbone runs no kernel), and in one serving forward
POSENET2D_PER_STEP = dict(TRAIN_PER_STEP, maxpool3d_k3s2p1=0,
                          maxpool3d_k3s2p1_vjp=0, conv3_mxu=0,
                          conv3_mxu_dx=0)
POSENET2D_PER_FORWARD = {"conv3_planes": K1_PER_FORWARD}


def _param_step(model, step_fn, use_kernels=True):
    """One optimizer step of a parameters-only model from its current
    weights, by ``step_fn(optimizer)``: loss, gradients, new parameters."""
    from hiddenpose_tpu_torch.config import TrainConfig
    from hiddenpose_tpu_torch.train.optim import make_optimizer

    if hasattr(model, "set_use_kernels"):
        model.set_use_kernels(use_kernels)
    opt = make_optimizer(TrainConfig(), model.parameters())[0]
    loss = step_fn(opt)["loss"].item()
    if hasattr(model, "set_use_kernels"):
        model.set_use_kernels(True)
    return dict(loss=loss,
                grads={n: p.grad.detach().clone()
                       for n, p in model.named_parameters()},
                params={n: p.detach().clone()
                        for n, p in model.named_parameters()})


def _param_readings(a, b):
    """How far param-step result ``a`` is from ``b``: the loss (relative),
    each parameter's gradient and all of them (relative L2), the new
    parameters where the two gradients agree, the share of large gradient
    elements of one sign."""
    rel = {}
    num_all = den_all = 0.0
    for n, gb in b["grads"].items():
        num = float((a["grads"][n].to(gb.device) - gb).double().pow(2).sum())
        den = float(gb.double().pow(2).sum())
        rel[n] = (num / max(den, 1e-60)) ** 0.5
        num_all, den_all = num_all + num, den_all + den
    param_err, agree, total = 0.0, 0, 0
    for n, gb in b["grads"].items():
        ga = a["grads"][n].to(gb.device)
        close = ((ga - gb).abs() <= 0.25 * gb.abs()) & (gb.abs() >= 1e-5)
        if close.any():
            param_err = max(param_err, float(
                (a["params"][n].to(gb.device) - b["params"][n])[close]
                .abs().max()))
        big = gb.abs() > 1e-2 * gb.abs().max()
        agree += int(((torch.sign(ga) == torch.sign(gb)) & big).sum())
        total += int(big.sum())
    worst = max(rel, key=rel.get)
    return dict(loss_rel=abs(a["loss"] - b["loss"]) / abs(b["loss"]),
                grad_rel_l2_all=(num_all / den_all) ** 0.5,
                grad_rel_l2_worst=(worst, rel[worst]),
                param_max_abs=param_err, sign_agree=agree / max(total, 1))


def _event_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def alt_simdr(dev, smi):
    """12a: the SimDR step on the full-width Sformer (phase 7's model,
    weights and video)."""
    from hiddenpose_tpu_torch.config import TrainConfig, t128_config
    from hiddenpose_tpu_torch.models.sformer import sformer_from_config
    from hiddenpose_tpu_torch.ops import kernels as K
    from hiddenpose_tpu_torch.train.alt_steps import make_simdr_step
    from hiddenpose_tpu_torch.train.optim import make_optimizer

    cfg = t128_config().model
    weights = sformer_weights(cfg)
    model = sformer_from_config(cfg, dtype="float32").to(dev)
    model.load_state_dict(weights)
    k = cfg.out_dim // 4
    g = torch.Generator(device=dev).manual_seed(0)
    batch = {"video": sformer_videos(dev, seeds=(0,))[0],
             "target_bins": torch.randint(0, k, (1, cfg.num_joints, 3),
                                          device=dev, generator=g),
             "target_weight": torch.ones(1, cfg.num_joints, device=dev)}

    # the main path: three steps at 'highest' and one at 'default'
    torch.cuda.reset_peak_memory_stats(dev)
    counts = {}
    steps = []
    for precision, n in (("highest", 3), ("default", 1)):
        step = make_simdr_step(model, matmul_precision=precision)
        opt = make_optimizer(TrainConfig(), model.parameters())[0]
        for _ in range(n):
            K.reset_launch_counts()
            ms, met = _event_ms(lambda: step(opt, batch))
            c = K.launch_counts()
            counts = {name: counts.get(name, 0) + v for name, v in c.items()}
            steps.append(dict(precision=precision, ms=ms,
                              loss=met["loss"].item(), attend=c["attend"]))
            log(f"[12a simdr] step at {precision!r}: loss "
                f"{steps[-1]['loss']:.6g} in {ms:.2f} ms, {c['attend']} K9 "
                f"launches")
            if c["attend"] != SIMDR_LAUNCHES_PER_STEP or any(
                    v for name, v in c.items() if name != "attend"):
                raise RuntimeError(f"12a: launch counts {c}, expected "
                                   f"{SIMDR_LAUNCHES_PER_STEP} of attend")
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(np.isfinite(s_["loss"]) for s_ in steps):
        raise RuntimeError("12a: a SimDR loss is not finite")
    _, f, _, h, w = batch["video"].shape
    tokens = cfg.num_joints + f * (h // cfg.patch_size) * (w // cfg.patch_size)
    log(f"[12a simdr] {tokens} tokens, dim {cfg.patch_feature_dim} depth "
        f"{cfg.depth}: 'highest' "
        f"steps 2 and 3 {steps[1]['ms']:.2f} / {steps[2]['ms']:.2f} ms, "
        f"'default' {steps[3]['ms']:.2f} ms; peak memory "
        f"{peak / 2**30:.3f} GiB  [{smi}]")

    step = make_simdr_step(model)
    res = {}
    for flag in (True, False):
        model.load_state_dict(weights)
        with deterministic(warn_only=True):
            res[flag] = _param_step(model, lambda o: step(o, batch), flag)
    vs = _param_readings(res[True], res[False])
    log(f"[12a simdr] kernels vs plain, one step: loss rel "
        f"{vs['loss_rel']:.3e} (tolerance {SIMDR_LOSS_TOL}); gradients rel "
        f"L2 over all {vs['grad_rel_l2_all']:.3e}, worst parameter "
        f"{vs['grad_rel_l2_worst']} (tolerance {SIMDR_GRAD_L2_TOL}); new "
        f"params max abs err where the gradients agree "
        f"{vs['param_max_abs']:.3e} ({TRAIN_PARAM_TOL}); large gradient "
        f"elements of one sign {vs['sign_agree']:.5f} "
        f"({TRAIN_SIGN_AGREE})")
    if not (vs["loss_rel"] <= SIMDR_LOSS_TOL
            and vs["grad_rel_l2_worst"][1] <= SIMDR_GRAD_L2_TOL
            and vs["param_max_abs"] <= TRAIN_PARAM_TOL
            and vs["sign_agree"] >= TRAIN_SIGN_AGREE):
        raise RuntimeError("12a: the SimDR step's kernels and plain "
                           "versions disagree")
    return dict(tokens=tokens, steps=steps, peak_memory_bytes=peak,
                kernels_vs_plain=vs), counts


def _posenet2d_cut(model, weights, batch, lct, use_kernels, cot=None,
                   meas=None):
    """The posenet2d training forward from ``weights``, cut at visible_net:
    its output and the voxels it picks (each channel's first min and max
    after the ReLU, the top-4 depth indices).  With ``cot``, a cotangent on
    that output, also the voxel loss and the gradients of ``voxel_loss +
    sum(out * cot)``: the step's FeatureExtraction and UNet gradients for a
    2D-net part held fixed."""
    import hiddenpose_tpu_torch.models.nlospose as nlospose_module
    from hiddenpose_tpu_torch.losses import bce_dice_loss

    seen, real = {}, nlospose_module.visible_net

    def spy(x, k=4):
        seen["volume"], seen["out"] = x, real(x, k)
        return seen["out"]

    model.load_state_dict(weights)
    model.set_use_kernels(use_kernels)
    model.zero_grad(set_to_none=True)
    res = {}
    with mock.patch.object(nlospose_module, "visible_net", spy), \
            torch.set_grad_enabled(cot is not None), \
            deterministic(warn_only=True):
        _, refine = model.train()(batch["meas"] if meas is None else meas,
                                  lct)
        if cot is not None:
            b = refine.shape[0]
            voxel = bce_dice_loss(refine.reshape(b, -1),
                                  batch["vol"].reshape(b, -1))
            (voxel + (seen["out"] * cot).sum()).backward()
            res["voxel_loss"] = voxel.item()
            res["grads"] = {n: p.grad.detach().clone()
                            for n, p in model.named_parameters()
                            if p.grad is not None}
    torch.cuda.synchronize()
    model.set_use_kernels(True)
    out = seen["out"].detach()
    x = torch.relu(seen["volume"].detach()).flatten(2)
    res.update(out=out, argmin=x.argmin(-1), argmax=x.argmax(-1),
               depths=out[:, out.shape[1] // 2:])
    return res


def _pick_changes(a, b):
    """How many of visible_net's picks differ between two cuts."""
    return {k: int((a[k] != b[k]).sum()) for k in ("argmin", "argmax",
                                                     "depths")}


def _posenet2d_head(model, weights, flat, batch):
    """The 2D net's part of the posenet2d step from visible_net's output
    ``flat``: the joint loss, its gradient in ``flat`` and in the 2D net's
    parameters."""
    from hiddenpose_tpu_torch.losses import l2_joint_location_loss

    model.load_state_dict(weights)
    net, cfg = model.pose_net.train(), model.cfg
    net.zero_grad(set_to_none=True)
    x = flat.detach().clone().requires_grad_(True)
    with deterministic(warn_only=True):
        hm = net(x)
        b, _, h, w = hm.shape
        loss = l2_joint_location_loss(
            hm.reshape(b, cfg.num_joints, cfg.heatmap_size[0], h, w),
            batch["joints"], batch["joints_vis"])
        loss.backward()
    return loss.item(), x.grad, {n: p.grad.detach().clone()
                                 for n, p in net.named_parameters()}


def alt_posenet2d(dev, smi):
    """12b: the posenet2d NlosPose at t128, batch 2: the serving forward
    and one train step, kernels against plain, whole and cut at
    visible_net's output; and the readings of the step's own spread."""
    import dataclasses

    from hiddenpose_tpu_torch.config import TrainConfig, t128_config
    from hiddenpose_tpu_torch.data.synthetic import make_batch
    from hiddenpose_tpu_torch.models.nlospose import NlosPose, build_nlospose
    from hiddenpose_tpu_torch.ops import kernels as K
    from hiddenpose_tpu_torch.ops.softargmax import softmax_integral
    from hiddenpose_tpu_torch.train.state import TrainState
    from hiddenpose_tpu_torch.train.step import make_train_step
    from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict

    cfg = t128_config()
    m = dataclasses.replace(cfg.model, backbone="posenet2d")
    with torch.device("meta"):
        template = NlosPose(m)
    weights = peaked_state_dict(template, seed=1)
    model, lct = build_nlospose(m, device=dev)
    model.load_state_dict(weights)
    _, caps = t128_captures(B)
    meas = torch.from_numpy(np.stack(caps)).to(dev)

    def forward():
        with torch.inference_mode():
            return model(meas, lct)[0]

    forward()  # warm-up
    K.reset_launch_counts()
    fwd_ms, hm = _event_ms(forward)
    counts = K.launch_counts()
    want = {k: POSENET2D_PER_FORWARD.get(k, 0) for k in counts}
    log(f"[12b posenet2d] serving forward b{B}: heatmaps "
        f"{tuple(hm.shape)} in {fwd_ms:.2f} ms, launch counts {counts}")
    side = m.image_size[0] // 4  # the 2D net's output: a quarter
    if counts != want or hm.shape != (B, m.num_joints, m.heatmap_size[0],
                                      side, side):
        raise RuntimeError(f"12b forward: launch counts {counts} (expected "
                           f"{want}), heatmaps {tuple(hm.shape)}")
    joints = softmax_integral(hm, m.num_joints).reshape(B, m.num_joints, 3)
    j_spread = float(joints.std(dim=1).min())
    outs = {}
    for flag in (True, False):
        model.set_use_kernels(flag)
        with deterministic():
            outs[flag] = forward()
    model.set_use_kernels(True)
    hm_rel = float((outs[True] - outs[False]).abs().max()
                   / outs[False].abs().max())
    j_err = float((softmax_integral(outs[True], m.num_joints)
                   - softmax_integral(outs[False], m.num_joints))
                  .abs().max())
    log(f"[12b posenet2d] joints spread over joints (smallest std of an "
        f"axis) {j_spread:.3f} voxels; kernels vs plain: heatmaps max rel "
        f"err {hm_rel:.3e} (tolerance {E2E_HM_TOL}), joints max err "
        f"{j_err:.3e} voxels ({E2E_JOINT_TOL})")
    if not bool(torch.isfinite(hm).all()) or j_spread < 0.5 \
            or not hm_rel <= E2E_HM_TOL or not j_err <= E2E_JOINT_TOL:
        raise RuntimeError("12b: the posenet2d forward is off")

    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        [0, 1], m.time_size, m.image_size[0], m.grid_dim, m.heatmap_size[0],
        m.bin_len).items()}
    step = make_train_step(model)
    # the main path: two steps, counted and timed
    model.load_state_dict(weights)
    state = TrainState.create(model, TrainConfig())
    torch.cuda.reset_peak_memory_stats(dev)
    train_counts, step_ms, losses = {}, [], []
    for _ in range(2):
        K.reset_launch_counts()
        ms, met = _event_ms(lambda: step(state, batch, lct))
        c = K.launch_counts()
        train_counts = {k: train_counts.get(k, 0) + v for k, v in c.items()}
        step_ms.append(ms)
        losses.append({k: v.item() for k, v in met.items()})
        if c != {k: POSENET2D_PER_STEP.get(k, 0) for k in c}:
            raise RuntimeError(f"12b step: launch counts {c}, expected "
                               f"{POSENET2D_PER_STEP}")
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[12b posenet2d] train steps at 'highest': "
        f"{[round(x, 2) for x in step_ms]} "
        f"ms, losses {losses}, peak memory {peak / 2**30:.3f} GiB; launch "
        f"counts of the last step: K1 {c['conv3_planes']}, K5 "
        f"{c['conv3_planes_adjoint']}, K6 {c['conv3_planes_wgrad']}, K8 "
        f"{c['max_pool2_bwd']}  [{smi}]")
    if not all(np.isfinite(v) for d in losses for v in d.values()):
        raise RuntimeError("12b: a train loss is not finite")
    kern = _step_result(model, weights, step, batch, lct, True)
    plain = _step_result(model, weights, step, batch, lct, False)
    vs = _train_readings(kern, plain)
    _log_readings("12b posenet2d", "train step, kernels vs plain", vs)
    # the step cut at visible_net's output, its 2D-net part held fixed: one
    # cotangent, from the plain forward's output, for both sides, so that
    # the kernels' FeatureExtraction and UNet gradients meet TRAIN_*
    plain_cut = _posenet2d_cut(model, weights, batch, lct, False)
    _, cot, _ = _posenet2d_head(model, weights, plain_cut["out"], batch)
    cut = {flag: _posenet2d_cut(model, weights, batch, lct, flag, cot)
           for flag in (True, False)}
    cut_vs = dict(voxel_loss_rel=abs(cut[True]["voxel_loss"]
                                     - cut[False]["voxel_loss"])
                  / abs(cut[False]["voxel_loss"]),
                  grad_rel_l2=_grad_rel_l2(cut[True]["grads"],
                                           cut[False]["grads"]),
                  picks_changed=_pick_changes(cut[True], cut[False]))
    log(f"[12b posenet2d] the step cut at visible_net's output, the 2D net's "
        f"cotangent shared, kernels vs plain: voxel loss rel "
        f"{cut_vs['voxel_loss_rel']:.3e} (tolerance {TRAIN_LOSS_TOL}), grads "
        f"rel L2 {cut_vs['grad_rel_l2']} ({TRAIN_GRAD_L2_TOL}); visible_net's "
        f"picks that differ {cut_vs['picks_changed']} of "
        f"{plain_cut['depths'].numel()} depths")
    # the amplifier: the plain step on a measurement moved by 1e-7
    # (relative) for three seeds, with visible_net's picks that move; and
    # the 2D net's part alone on its input's values moved by 1e-7
    spread, gain = [], []
    head = _posenet2d_head(model, weights, plain_cut["out"], batch)
    half = plain_cut["out"].shape[1] // 2
    for seed in range(3):
        g = torch.Generator(device=dev).manual_seed(seed)
        moved = dict(batch, meas=batch["meas"] * (1 + 1e-7 * torch.randn(
            batch["meas"].shape, generator=g, device=dev)))
        r = _train_readings(
            _step_result(model, weights, step, moved, lct, False), plain)
        r["picks_changed"] = _pick_changes(
            _posenet2d_cut(model, weights, batch, lct, False,
                           meas=moved["meas"]), plain_cut)
        spread.append(r)
        _log_readings("12b posenet2d", f"plain vs plain on a 1e-7 moved "
                      f"measurement (seed {seed}); picks that differ "
                      f"{r['picks_changed']}", r)
        flat = plain_cut["out"].clone()
        flat[:, :half] *= 1 + 1e-7 * torch.randn(
            flat[:, :half].shape, generator=g, device=dev)
        moved_head = _posenet2d_head(model, weights, flat, batch)
        gain.append(dict(loss_rel=abs(moved_head[0] - head[0]) / abs(head[0]),
                         input_grad_rel_l2=float((moved_head[1] - head[1])
                                                 .norm() / head[1].norm()),
                         grad_rel_l2=_grad_rel_l2(moved_head[2], head[2])))
        log(f"[12b posenet2d] the 2D net's part alone, its input's values "
            f"moved by 1e-7 (seed {seed}), depths kept: {gain[-1]}")
    ok = (max(vs["loss_rel"].values()) <= POSENET2D_LOSS_TOL
          and max(vs["grad_rel_l2"].values()) <= POSENET2D_GRAD_L2_TOL
          and vs["stats_max_rel"] <= TRAIN_STATS_TOL
          and vs["param_max_abs"] <= TRAIN_PARAM_TOL
          and vs["sign_agree"] >= TRAIN_SIGN_AGREE
          and cut_vs["voxel_loss_rel"] <= TRAIN_LOSS_TOL
          and max(cut_vs["grad_rel_l2"].values()) <= TRAIN_GRAD_L2_TOL)
    if not ok:
        raise RuntimeError("12b: the posenet2d train step's kernels and "
                           "plain versions disagree")
    return dict(forward_ms=fwd_ms, joints_spread=j_spread,
                heatmaps_rel_err=hm_rel, joints_err_voxels=j_err,
                step_ms=step_ms, losses=losses, peak_memory_bytes=peak,
                kernels_vs_plain=vs, cut_kernels_vs_plain=cut_vs,
                plain_vs_moved_plain=spread, net_2d_gain=gain), \
        {k: counts.get(k, 0) + train_counts.get(k, 0) for k in counts}


def alt_heatmap3d(dev, smi):
    """12c: the 3D-heatmap step on the t128 posenet3d_50 model, kernels
    against plain; its loss is make_train_step's joint loss."""
    from hiddenpose_tpu_torch.config import TrainConfig, t128_config
    from hiddenpose_tpu_torch.data.synthetic import make_batch
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose
    from hiddenpose_tpu_torch.ops import kernels as K
    from hiddenpose_tpu_torch.train.alt_steps import make_heatmap3d_step
    from hiddenpose_tpu_torch.train.state import TrainState
    from hiddenpose_tpu_torch.train.step import make_train_step

    cfg = t128_config()
    m = cfg.model
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        [0, 1], m.time_size, m.image_size[0], m.grid_dim, m.heatmap_size[0],
        m.bin_len).items()}
    weights = t128_weights(cfg)
    model, lct = build_nlospose(m, device=dev)
    step = make_heatmap3d_step(model)
    # the main path: one step, counted and timed
    model.load_state_dict(weights)
    state = TrainState.create(model, TrainConfig())
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    ms, met = _event_ms(lambda: step(state, batch, lct))
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[12c heatmap3d] one step: loss {met['loss'].item():.6g} in "
        f"{ms:.2f} ms (the first of this model: cuDNN's plans included), "
        f"peak memory {peak / 2**30:.3f} GiB, launch counts {counts}  "
        f"[{smi}]")
    if counts != {k: TRAIN_PER_STEP.get(k, 0) for k in counts}:
        raise RuntimeError(f"12c: launch counts {counts}, expected "
                           f"{TRAIN_PER_STEP}")
    kern = _step_result(model, weights, step, batch, lct, True)
    plain = _step_result(model, weights, step, batch, lct, False)
    full = _step_result(model, weights, make_train_step(model), batch, lct,
                        True)
    vs = _train_readings(kern, plain)
    _log_readings("12c heatmap3d", "kernels vs plain", vs)
    joint_rel = abs(kern["loss"]["loss"] - full["loss"]["joint_loss"]) \
        / abs(full["loss"]["joint_loss"])
    log(f"[12c heatmap3d] its loss vs make_train_step's joint loss on the "
        f"same weights and batch: rel {joint_rel:.3e} (tolerance "
        f"{TRAIN_LOSS_TOL})")
    ok = (max(vs["loss_rel"].values()) <= TRAIN_LOSS_TOL
          and max(vs["grad_rel_l2"].values()) <= TRAIN_GRAD_L2_TOL
          and vs["stats_max_rel"] <= TRAIN_STATS_TOL
          and vs["param_max_abs"] <= TRAIN_PARAM_TOL
          and vs["sign_agree"] >= TRAIN_SIGN_AGREE
          and joint_rel <= TRAIN_LOSS_TOL)
    if not ok:
        raise RuntimeError("12c: the heatmap3d step is off")
    return dict(ms=ms, loss=met["loss"].item(), peak_memory_bytes=peak,
                kernels_vs_plain=vs, vs_joint_loss_rel=joint_rel), counts


def alt_tokenpose(dev, smi):
    """12d: TokenPose at its published config, the 2D-heatmap step on the
    GPU against the same step on the CPU."""
    from hiddenpose_tpu_torch.config import TrainConfig
    from hiddenpose_tpu_torch.data.targets import generate_gaussian_heatmap_2d
    from hiddenpose_tpu_torch.models.tokenpose import build_tokenpose
    from hiddenpose_tpu_torch.train.optim import make_optimizer
    from hiddenpose_tpu_torch.train.alt_steps import make_heatmap2d_step
    from hiddenpose_tpu_torch.utils.peaked import (
        peaked_transformer_state_dict,
    )

    rng = np.random.RandomState(0)
    joints = rng.uniform(0, 64, (2, 24, 2))
    maps, w = zip(*(generate_gaussian_heatmap_2d(j) for j in joints))
    batch = {"feature": rng.randn(2, 128, 64, 64).astype(np.float32),
             "target_heatmaps": np.stack(maps),
             "target_weight": np.stack(w)[..., 0]}
    res, ms = {}, []
    for where in ("cpu", dev):
        model = build_tokenpose(device=where)
        if not res:
            weights = peaked_transformer_state_dict(model, 1)
        model.load_state_dict(weights)
        model.train()
        tb = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}

        def step_fn(opt):
            return make_heatmap2d_step(lambda b: model(b["feature"]),
                                       opt)(tb)

        if where != "cpu":
            opt = make_optimizer(TrainConfig(), model.parameters())[0]
            for _ in range(3):  # the main path: 3 steps, timed
                ms.append(_event_ms(lambda: step_fn(opt))[0])
            model.load_state_dict(weights)
            with deterministic(warn_only=True):
                res[where] = _param_step(model, step_fn)
        else:
            res[where] = _param_step(model, step_fn)
    vs = _param_readings(res[dev], res["cpu"])
    log(f"[12d tokenpose] published config (feature (2, 128, 64, 64), dim "
        f"192, 3 x 2 layers, 64 x 64 heatmaps, sine-full): GPU steps "
        f"{[round(x, 2) for x in ms]} ms (library ops only)  [{smi}]")
    log(f"[12d tokenpose] GPU vs CPU, one step: loss rel "
        f"{vs['loss_rel']:.3e}, gradients rel L2 {vs['grad_rel_l2_all']:.3e} "
        f"(tolerance {TOKENPOSE_TOL}); new params max abs err where the "
        f"gradients agree {vs['param_max_abs']:.3e} ({TRAIN_PARAM_TOL}); "
        f"one sign {vs['sign_agree']:.5f}")
    if not (vs["loss_rel"] <= TOKENPOSE_TOL
            and vs["grad_rel_l2_all"] <= TOKENPOSE_TOL
            and vs["param_max_abs"] <= TRAIN_PARAM_TOL
            and vs["sign_agree"] >= TRAIN_SIGN_AGREE):
        raise RuntimeError("12d: TokenPose's step differs between GPU and "
                           "CPU")
    return dict(step_ms=ms, gpu_vs_cpu=vs)


def phase_alt_objectives(dev, smi):
    """Phase 12: 12a-12d; the launch counts of their main-path runs."""
    out, counts = {}, {}
    for name, fn in (("simdr", alt_simdr), ("posenet2d", alt_posenet2d),
                     ("heatmap3d", alt_heatmap3d)):
        t0 = time.perf_counter()
        out[name], c = fn(dev, smi)
        out[name]["seconds"] = time.perf_counter() - t0
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["tokenpose"] = alt_tokenpose(dev, smi)
    out["tokenpose"]["seconds"] = time.perf_counter() - t0
    return out, counts


# Phase 13: the models and ops ported last.  13a, the SimDR step on phase
# 7's Sformer in the bf16 mode (bf16 Dense layers, f32 parameters), one
# step with K9's forward vs one whose attention forward rounds where K9
# rounds (``attend_online_ref`` on K9's own chunks: 64-key tiles, a
# running max, the unnormalised probability rounded to bf16; both through
# AttendFused, whose backward is the plain attention's gradient).  A bf16
# step rounds chaotically (one bf16 rounding that flips moves every later
# one), so kernels vs that plain step is held to BF16_SIMDR_SPREAD times
# the plain step's own spread: the largest over three moves of the video
# by BF16_SIMDR_MOVE (relative, seeds BF16_SIMDR_SEEDS), in the loss and in
# the gradients over all (relative L2), as 12b holds its step.  Each
# attention shape's first call is also held against K9 directly: equal
# bf16 outputs at BF16_K9_ORDER_EQUAL of the elements at least (float32
# rounding flips a probability's bf16 rounding now and then, which moves
# an output by up to 2^-8 of that key's |v| where the key dominates:
# 1.56e-2 at 0.055% of the grouped call's outputs, read where a first form
# of this check, one output ulp, failed; the joint-token read is equal
# throughout; attend_ref's outputs equal K9's at 80% and 95%; NVIDIA H100
# 80GB HBM3, 700 W; PERF.md).  The step through ``attend_ref``, which
# rounds the normalised probability, is printed beside it and not held:
# its first readings against K9 were 2.79e-4 (loss) and 1.19e-2
# (gradients), against a spread of 1.09e-4 and 1.13e-2 at a 1e-7 move.
BF16_K9_ORDER_EQUAL = 0.99
BF16_SIMDR_MOVE = 1e-7
BF16_SIMDR_SEEDS = (1, 2, 3)
BF16_SIMDR_SPREAD = 2.0
# 13b, PoseNet3D(block="basic", layers=(2, 2, 2, 2)), ResNet-18's layout at
# full width: launches of one serving forward at t128 b2 (K4 on both convs
# of every stride-1 block the JAX router admits: 4 at c64, 3 at c128, 3 at
# c256; c512 is past the router's weight budget), of the bf16 model's, and
# of one train forward + backward at 'highest'.
BASIC_LAYERS = (2, 2, 2, 2)
BASIC_K4_PER_FORWARD = 10
# the joints must spread by this much (voxels, the smallest axis's std
# over the 24 joints) for a comparison of joints to mean anything
BASIC_JOINT_SPREAD = 1.0
# The bf16 forward, kernels vs plain: the heatmaps within phase 9's
# BF16_KP_HM_RMS_TOL; the joints within BASIC_BF16_JOINTS x how far the
# plain bf16 forward's joints lie from the f32 forward's, read in the run:
# two independent bf16 roundings, each that far from the f32 forward, lie
# about sqrt(2) times that far from each other.  Phase 9's joint limit
# (1.7 voxels) was set on NlosPose's heatmaps; this net's joints, on the
# volumes NlosPose feeds it, move 2.41 voxels (mean) under the plain
# path's bf16 rounding alone (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
BASIC_BF16_JOINTS = 2 ** 0.5
BASIC_SERVE = {"stem_conv_raw": 1, "maxpool3d_k3s2p1": 1,
               "conv3_mxu": BASIC_K4_PER_FORWARD}
BASIC_SERVE_BF16 = {"stem_conv_raw_bf16": 1, "maxpool3d_k3s2p1_bf16": 1,
                    "conv3_mxu_bf16": BASIC_K4_PER_FORWARD}
BASIC_TRAIN = {"maxpool3d_k3s2p1": 1, "maxpool3d_k3s2p1_vjp": 1,
               "conv3_mxu": BASIC_K4_PER_FORWARD,
               "conv3_mxu_dx": BASIC_K4_PER_FORWARD}
# 13c, DeepVoxels at the reference's size against the same forward in
# float64 on the card (``dv_forward64``): max error over the output's max
# (f32 convs and 512 x 256 x 256 FFTs, then two normalisations; 1e-5 of
# the peak is the f32 LCT's own distance from JAX's, tests/test_torch_lct).
DV_F64_TOL = 1e-4
DV_CAPTURE = (512, 256)  # time bins, wall points a side: the defaults
# 13d, the resampler and wave ops on DeepVoxels' output, card vs CPU: max
# error over the output's max (the same formulas, FMA on the card)
DV_OPS_TOL = 1e-5


def _set_kernels(model, flag: bool) -> None:
    for m in model.modules():
        if hasattr(m, "use_kernels"):
            m.use_kernels = bool(flag)


def _counted(fn):
    """Run ``fn()`` with every launch count from 0: its result and the
    counts of the kernels it launched."""
    from hiddenpose_tpu_torch.ops import kernels as K

    K.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in K.launch_counts().items() if v}


def bf16_simdr(dev, smi):
    """13a: the SimDR step on the full-width Sformer in the bf16 mode."""
    from hiddenpose_tpu_torch.config import TrainConfig, t128_config
    from hiddenpose_tpu_torch.models.sformer import sformer_from_config
    from hiddenpose_tpu_torch.ops.kernels import attn as attn_module
    from hiddenpose_tpu_torch.train.alt_steps import make_simdr_step
    from hiddenpose_tpu_torch.train.optim import make_optimizer

    cfg = t128_config().model
    weights = sformer_weights(cfg)
    model = sformer_from_config(cfg, dtype="bfloat16").to(dev)
    model.load_state_dict(weights)
    k = cfg.out_dim // 4
    g = torch.Generator(device=dev).manual_seed(0)
    batch = {"video": sformer_videos(dev, seeds=(0,))[0],
             "target_bins": torch.randint(0, k, (1, cfg.num_joints, 3),
                                          device=dev, generator=g),
             "target_weight": torch.ones(1, cfg.num_joints, device=dev)}

    torch.cuda.reset_peak_memory_stats(dev)
    counts, steps = {}, []
    for precision, n in (("highest", 3), ("default", 1)):
        step = make_simdr_step(model, matmul_precision=precision)
        opt = make_optimizer(TrainConfig(), model.parameters())[0]
        for _ in range(n):
            (ms, met), c = _counted(lambda: _event_ms(lambda: step(opt,
                                                                   batch)))
            for name, v in c.items():
                counts[name] = counts.get(name, 0) + v
            steps.append(dict(precision=precision, ms=ms,
                              loss=met["loss"].item(), launches=c))
            log(f"[13a bf16 simdr] step at {precision!r}: loss "
                f"{steps[-1]['loss']:.6g} in {ms:.2f} ms, launches {c}")
            if c != {"attend": SIMDR_LAUNCHES_PER_STEP}:
                raise RuntimeError(f"13a: launch counts {c}, expected "
                                   f"{SIMDR_LAUNCHES_PER_STEP} of attend")
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(np.isfinite(s_["loss"]) for s_ in steps):
        raise RuntimeError("13a: a bf16 SimDR loss is not finite")
    log(f"[13a bf16 simdr] 'highest' steps 2 and 3 {steps[1]['ms']:.2f} / "
        f"{steps[2]['ms']:.2f} ms, 'default' {steps[3]['ms']:.2f} ms; peak "
        f"memory {peak / 2**30:.3f} GiB  [{smi}]")

    step = make_simdr_step(model)
    video = batch["video"]
    k9 = attn_module.attend
    captured = {}

    def kernel_order(q, k, v):
        """The plain attention in K9's order, on K9's chunks; the first
        call of each shape keeps its inputs, to hold K9 against it."""
        b_, lq, dh = q.shape
        lk = k.shape[1]
        key = (tuple(q.shape), lk)
        if key not in captured:
            captured[key] = (q.clone(), k.clone(), v.clone())
        return attn_module.attend_online_ref(
            q, k, v, attn_module.attend_chunk(b_, lq, lk, dh))

    def against_k9(q, k, v):
        """K9 (unpatched: its launch count is a global of its module)
        against its order in plain PyTorch, and against attend_ref."""
        b_, lq, dh = q.shape
        with torch.no_grad():
            ker = k9(q, k, v).float()
            want = attn_module.attend_online_ref(
                q, k, v, attn_module.attend_chunk(b_, lq, k.shape[1], dh))
            want = want.float()
            return dict(
                equal=(ker == want).float().mean().item(),
                max_abs=(ker - want).abs().max().item(),
                equal_vs_attend_ref=(attn_module.attend_ref(q, k, v).float()
                                     == ker).float().mean().item())

    def one(fwd, seed=None):
        """One step from the weights, the attention forward by ``fwd``
        inside ``AttendFused``, whose backward recomputes the plain
        attention either way (the plain attention under autograd keeps
        every layer's f32 scores and probabilities, 9 GB a layer, past
        the card's 80 GB in this mode); the video moved by
        BF16_SIMDR_MOVE in a pattern of ``seed``'s."""
        model.load_state_dict(weights)
        b = batch
        if seed is not None:
            noise = torch.from_numpy(np.random.RandomState(seed).randn(
                *video.shape).astype(np.float32)).to(dev)
            b = dict(batch, video=video * (1 + BF16_SIMDR_MOVE * noise))
        with deterministic(warn_only=True), \
                mock.patch.object(attn_module, "attend", fwd):
            return _param_step(model, lambda o: step(o, b))

    plain = one(kernel_order)
    direct = {key: against_k9(*qkv) for key, qkv in captured.items()}
    captured.clear()
    for (shape, lk), r in direct.items():
        log(f"[13a bf16 simdr] K9 vs its order in plain PyTorch, q {shape} "
            f"Lk {lk}: equal at {r['equal']:.6f} of the outputs (limit "
            f"{BF16_K9_ORDER_EQUAL}), max abs diff {r['max_abs']:.3e}; K9 "
            f"equal to attend_ref at {r['equal_vs_attend_ref']:.6f}")
    kern = one(k9)
    vs = _param_readings(kern, plain)
    vs_ref = _param_readings(kern, one(attn_module.attend_ref))
    spreads = {s_: _param_readings(one(kernel_order, s_), plain)
               for s_ in BF16_SIMDR_SEEDS}
    for s_, r in spreads.items():
        log(f"[13a bf16 simdr] the plain step on the video moved by "
            f"{BF16_SIMDR_MOVE:g} (seed {s_}): loss rel {r['loss_rel']:.3e}, "
            f"gradients rel L2 {r['grad_rel_l2_all']:.3e}, worst "
            f"{r['grad_rel_l2_worst']}, signs {r['sign_agree']:.4f}")
    ref = {k: max(r[k] for r in spreads.values())
           for k in ("loss_rel", "grad_rel_l2_all")}
    log(f"[13a bf16 simdr] kernels vs plain in K9's order: loss rel "
        f"{vs['loss_rel']:.3e} (limit "
        f"{BF16_SIMDR_SPREAD * ref['loss_rel']:.3e}), gradients rel L2 "
        f"{vs['grad_rel_l2_all']:.3e} (limit "
        f"{BF16_SIMDR_SPREAD * ref['grad_rel_l2_all']:.3e}), worst "
        f"{vs['grad_rel_l2_worst']}, signs {vs['sign_agree']:.4f}, new "
        f"params max abs err where the gradients agree "
        f"{vs['param_max_abs']:.3e}; kernels vs the attend_ref step (not "
        f"held): loss rel {vs_ref['loss_rel']:.3e}, gradients rel L2 "
        f"{vs_ref['grad_rel_l2_all']:.3e}")
    if not all(r["equal"] >= BF16_K9_ORDER_EQUAL for r in direct.values()):
        raise RuntimeError("13a: K9 does not round where its order in "
                           "plain PyTorch rounds")
    if not (vs["loss_rel"] <= BF16_SIMDR_SPREAD * ref["loss_rel"]
            and vs["grad_rel_l2_all"]
            <= BF16_SIMDR_SPREAD * ref["grad_rel_l2_all"]):
        raise RuntimeError("13a: the bf16 SimDR step's kernels and plain "
                           "versions disagree beyond the step's own spread")
    return dict(steps=steps, peak_memory_bytes=peak, kernels_vs_plain=vs,
                kernels_vs_attend_ref_step=vs_ref,
                k9_vs_its_order={f"{sh} Lk {lk}": r
                                 for (sh, lk), r in direct.items()},
                plain_spread={str(s_): r for s_, r in spreads.items()}), \
        counts


def _joints(hm):
    from hiddenpose_tpu_torch.ops.softargmax import softmax_integral

    return softmax_integral(hm.float(), hm.shape[1])


def posenet_inputs(dev):
    """What NlosPose feeds its PoseNet3D, feature + refinement (B, 1, 128,
    128, 128), for phase 4's first B captures through the f32 model on
    the peaked weights of phase 4."""
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose

    cfg, caps = t128_captures(B)
    model, lct = build_nlospose(cfg.model, device=dev)
    model.load_state_dict(t128_weights(cfg))
    seen = {}
    hook = model.pose_net.register_forward_pre_hook(
        lambda m, args: seen.__setitem__("x", args[0]))
    with torch.inference_mode():
        model(torch.from_numpy(np.stack(caps)).to(dev), lct)
    hook.remove()
    x = seen["x"].clone().contiguous()
    del model, seen
    torch.cuda.empty_cache()
    return x


def basic_posenet(dev, smi):
    """13b: PoseNet3D(block='basic', layers=(2, 2, 2, 2)) at full width on
    a t128 b2 volume, peaked weights."""
    from hiddenpose_tpu_torch.models.posenet3d import (
        PoseNet3D,
        build_posenet3d,
    )
    from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict

    kw = dict(block="basic", layers=BASIC_LAYERS)
    with torch.device("meta"):
        template = PoseNet3D(**kw)
    weights = peaked_state_dict(template, seed=1)

    def build(dtype=torch.float32, **more):
        m = build_posenet3d(device=dev, dtype=dtype, **kw, **more)
        m.load_state_dict(weights)
        return m

    x = posenet_inputs(dev)
    out, counts = {}, {}

    def add(c):
        for name, v in c.items():
            counts[name] = counts.get(name, 0) + v

    def serve(model, flag):
        _set_kernels(model, flag)
        with torch.inference_mode():
            model(x)  # cuDNN's plans
            (hm, c) = _counted(lambda: model(x))
            ms = cuda_ms(lambda: model(x), iters=3)
            with deterministic():
                hm = model(x).float()
        _set_kernels(model, True)
        return hm, c, ms

    # f32 serving, kernels vs plain
    model = build()
    hk, ck, ms_k = serve(model, True)
    hp, _, ms_p = serve(model, False)
    add(ck)
    jk, jp = _joints(hk), _joints(hp)
    hm_rel = ((hk - hp).abs().max() / hp.abs().max()).item()
    j_abs = (jk - jp).abs().max().item()
    spread = float(jp.std(dim=1).min())
    log(f"[13b basic] f32 forward b{B}: kernels {ms_k:.2f} ms, plain "
        f"{ms_p:.2f} ms; launches {ck}; heatmaps max rel err {hm_rel:.3e} "
        f"({E2E_HM_TOL}), joints max abs err {j_abs:.3e} voxels "
        f"({E2E_JOINT_TOL}); joints' spread (std over joints, smallest "
        f"axis) {spread:.2f} voxels; heatmaps {tuple(hp.shape)} in "
        f"[{hp.min().item():.3g}, {hp.max().item():.3g}]  [{smi}]")
    out["f32"] = dict(ms=ms_k, plain_ms=ms_p, launches=ck,
                      hm_max_rel_err=hm_rel, joints_max_abs_err=j_abs,
                      joint_spread=spread)
    if ck != BASIC_SERVE:
        raise RuntimeError(f"13b: f32 launches {ck}, expected {BASIC_SERVE}")
    if spread < BASIC_JOINT_SPREAD:
        raise RuntimeError("13b: the joints do not spread; the check "
                           "cannot tell a wrong model")
    if not (torch.isfinite(hk).all() and hm_rel <= E2E_HM_TOL
            and j_abs <= E2E_JOINT_TOL):
        raise RuntimeError("13b: f32 kernels and plain versions disagree")

    # bf16 serving, kernels vs plain (phase 9's limits), and vs f32
    m16 = build(torch.bfloat16)
    bk, cb, ms_bk = serve(m16, True)
    bp, _, ms_bp = serve(m16, False)
    add(cb)
    del m16

    def rms(t):
        return float(t.double().pow(2).mean().sqrt())

    kp_hm = rms(bk - bp) / rms(bp)
    kp_j = float((_joints(bk) - _joints(bp)).norm(dim=-1).mean())
    f_hm = rms(bk - hp) / rms(hp)
    f_j = float((_joints(bk) - jp).norm(dim=-1).mean())
    pf_hm = rms(bp - hp) / rms(hp)
    pf_j = float((_joints(bp) - jp).norm(dim=-1).mean())
    log(f"[13b basic] bf16 forward b{B}: kernels {ms_bk:.2f} ms, plain "
        f"{ms_bp:.2f} ms; launches {cb}; kernels vs plain heatmap RMS "
        f"{kp_hm:.3e} ({BF16_KP_HM_RMS_TOL}), joints mean {kp_j:.3f} voxels "
        f"(limit {BASIC_BF16_JOINTS * pf_j:.3f}); kernels vs f32 "
        f"{f_hm:.3e}, {f_j:.3f}; plain vs f32 {pf_hm:.3e}, {pf_j:.3f}")
    out["bf16"] = dict(ms=ms_bk, plain_ms=ms_bp, launches=cb,
                       hm_rms_vs_plain=kp_hm, joints_mean_vs_plain=kp_j,
                       hm_rms_vs_f32=f_hm, joints_mean_vs_f32=f_j,
                       plain_hm_rms_vs_f32=pf_hm,
                       plain_joints_mean_vs_f32=pf_j)
    if cb != BASIC_SERVE_BF16:
        raise RuntimeError(f"13b: bf16 launches {cb}, expected "
                           f"{BASIC_SERVE_BF16}")
    if not (torch.isfinite(bk).all() and kp_hm <= BF16_KP_HM_RMS_TOL
            and kp_j <= BASIC_BF16_JOINTS * pf_j):
        raise RuntimeError("13b: bf16 kernels and plain versions disagree")

    # one train forward + backward at 'highest', a shared cotangent
    g = torch.Generator(device=dev).manual_seed(2)
    cot = torch.randn(hp.shape, device=dev, generator=g)

    def train_once(flag):
        model.load_state_dict(weights)
        _set_kernels(model, flag)
        model.train().zero_grad(set_to_none=True)
        with deterministic(warn_only=True):
            y = model(x)
            (y * cot).sum().backward()
        torch.cuda.synchronize()
        _set_kernels(model, True)
        return dict(y=y.detach().float(),
                    grads={n: p.grad.detach().clone()
                           for n, p in model.named_parameters()},
                    stats={n: b.detach().clone()
                           for n, b in model.named_buffers()
                           if b.is_floating_point()})

    torch.cuda.reset_peak_memory_stats(dev)
    tk, ct = _counted(lambda: train_once(True))
    peak = torch.cuda.max_memory_allocated(dev)
    add(ct)
    tp = train_once(False)
    model.train()
    ms_t, _ = _event_ms(lambda: (model(x) * cot).sum().backward())
    grad_l2 = _grad_rel_l2(tk["grads"], tp["grads"])
    stats = max(float((tk["stats"][n] - tp["stats"][n]).abs().max())
                / max(float(tp["stats"][n].abs().max()), 1e-30)
                for n in tp["stats"])
    y_rel = ((tk["y"] - tp["y"]).abs().max() / tp["y"].abs().max()).item()
    log(f"[13b basic] train forward + backward at 'highest': {ms_t:.2f} ms, "
        f"peak memory {peak / 2**30:.3f} GiB; launches {ct}; kernels vs "
        f"plain: output max rel {y_rel:.3e}, gradients rel L2 by module "
        f"{ {k: round(v, 6) for k, v in grad_l2.items()} } "
        f"({TRAIN_GRAD_L2_TOL}), new statistics {stats:.3e} "
        f"({TRAIN_STATS_TOL})")
    out["train"] = dict(ms=ms_t, peak_memory_bytes=peak, launches=ct,
                        out_max_rel=y_rel, grad_rel_l2=grad_l2,
                        stats_max_rel=stats)
    if ct != BASIC_TRAIN:
        raise RuntimeError(f"13b: train launches {ct}, expected "
                           f"{BASIC_TRAIN}")
    if not (max(grad_l2.values()) <= TRAIN_GRAD_L2_TOL
            and stats <= TRAIN_STATS_TOL and y_rel <= E2E_HM_TOL):
        raise RuntimeError("13b: the train step's kernels and plain "
                           "versions disagree")
    del model
    torch.cuda.empty_cache()

    # the library stem: conv1_t_stride=2, no max-pool
    lib = build(conv1_t_stride=2, no_max_pool=True)
    lk, cl, ms_l = serve(lib, True)
    lp, _, _ = serve(lib, False)
    add(cl)
    l_rel = ((lk - lp).abs().max() / lp.abs().max()).item()
    log(f"[13b basic] library stem (conv1_t_stride=2, no_max_pool): "
        f"heatmaps {tuple(lk.shape)}, {ms_l:.2f} ms, launches {cl}, kernels "
        f"vs plain max rel {l_rel:.3e} ({E2E_HM_TOL})")
    out["library_stem"] = dict(ms=ms_l, launches=cl, hm_max_rel_err=l_rel,
                               shape=list(lk.shape))
    if "stem_conv_raw" in cl or "maxpool3d_k3s2p1" in cl:
        raise RuntimeError(f"13b: the library stem launched {cl}")
    if not (torch.isfinite(lk).all() and l_rel <= E2E_HM_TOL):
        raise RuntimeError("13b: the library stem's kernels and plain "
                           "versions disagree")
    del lib
    torch.cuda.empty_cache()
    return out, counts


def dv_forward64(model, lct, x):
    """DeepVoxels' forward in float64, written out with library ops from
    the model's weights and the LCT constants widened."""
    import torch.nn.functional as F

    from hiddenpose_tpu_torch.ops.normalize import normalize

    down = model.downnet
    d = torch.float64

    def conv(m, h, stride=1):
        return F.conv3d(h, m.weight.to(d), m.bias.to(d), stride)

    def edge(h):
        return F.pad(h, (1,) * 6, mode="replicate")

    x = normalize(x.to(d))
    h = conv(down.conv1[1], edge(x), 2)
    for res in (down.conv1[2], down.conv1[3]):
        a = F.leaky_relu(conv(res.tmp[1], edge(h)), 0.2)
        h = F.leaky_relu(conv(res.tmp[4], edge(a)) + h, 0.2)
    h2 = F.conv3d(x, down.weights.to(d), None, 2, 1)
    h = torch.cat([h2, h], dim=1)
    b, ch = h.shape[:2]
    v = h.reshape(b * ch, *h.shape[2:])
    t, n = lct.time_size, lct.image_size
    v = v * (lct.gridz.to(d) ** 4)[None, :, None, None]
    v = torch.matmul(lct.mtx.to(d), v.reshape(b * ch, t, n * n)).reshape(
        v.shape)
    f = torch.fft.rfftn(v, s=(2 * t, 2 * n, 2 * n), dim=(1, 2, 3))
    v = torch.fft.irfftn(f * lct.invpsf.to(torch.complex128)[None],
                         s=(2 * t, 2 * n, 2 * n), dim=(1, 2, 3))
    del f
    v = v[:, :t, :n, :n]
    v = torch.matmul(lct.mtxi.to(d), v.reshape(b * ch, t, n * n)).reshape(
        b, ch, t, n, n)
    v = v[:, :, : t * 100 // 128]
    return normalize(torch.relu(v)) * 1.0e5


def deepvoxels_phase(dev, smi):
    """13c and 13d: DeepVoxels at the reference's size (``build_deepvoxels``
    defaults: a (1, 1, 512, 256, 256) capture), then the resampler and
    wave ops on its output."""
    from hiddenpose_tpu_torch.models.deepvoxels import build_deepvoxels
    from hiddenpose_tpu_torch.ops.resample import MultiViewResampler
    from hiddenpose_tpu_torch.ops.wave import wave_convolve

    t, n = DV_CAPTURE
    model, lct = build_deepvoxels(time_size=t, image_size=n, device=dev,
                                  seed=0)
    x = torch.from_numpy(np.random.RandomState(0).rand(
        1, 1, t, n, n).astype(np.float32)).to(dev)
    with torch.inference_mode():
        model(x, lct)  # cuFFT's and cuDNN's plans
        torch.cuda.reset_peak_memory_stats(dev)
        (y, c) = _counted(lambda: model(x, lct))
        peak = torch.cuda.max_memory_allocated(dev)
        ms = cuda_ms(lambda: model(x, lct), iters=3)
        ref = dv_forward64(model, lct, x)
    err = ((y.double() - ref).abs().max() / ref.abs().max()).item()
    log(f"[13c deepvoxels] {tuple(x.shape)} -> {tuple(y.shape)} "
        f"{y.dtype}: {ms:.2f} ms, peak memory {peak / 2**30:.3f} GiB, "
        f"launches {c}; against float64 max err {err:.3e} of the max "
        f"({DV_F64_TOL}); output in [{y.min().item():.4g}, "
        f"{y.max().item():.4g}]  [{smi}]")
    out = dict(ms=ms, peak_memory_bytes=peak, launches=c,
               err_vs_f64=err, shape=list(y.shape))
    want_shape = (1, 17, t // 2 * 100 // 128, n // 2, n // 2)
    if tuple(y.shape) != want_shape or not bool(
            torch.isfinite(y).all()) or err > DV_F64_TOL:
        raise RuntimeError("13c: DeepVoxels' forward is wrong")
    del ref
    torch.cuda.empty_cache()

    # 13d: the ops on DeepVoxels' output, card vs CPU
    kw = dict(spatial=n // 2, tdim=y.shape[2], trange=t * 0.01,
              wall_size=2.0)
    t0 = time.perf_counter()
    got = MultiViewResampler(**kw, device=dev)(y, [5])
    want = MultiViewResampler(**kw, device="cpu")(y.cpu(), [5])
    r_err = ((got.cpu() - want).abs().max() / want.abs().max()).item()
    wk = dict(bin_resolution=0.02 / 3e8, virtual_wavelength=0.2, cycles=5)
    wg = wave_convolve(y[0, 0], **wk)
    wc = wave_convolve(y[0, 0].cpu(), **wk)
    w_err = max(((a.cpu() - b).abs().max() / b.abs().max()).item()
                for a, b in zip(wg, wc))
    log(f"[13d ops] MultiViewResampler view 5 {tuple(got.shape)}, card vs "
        f"CPU max err {r_err:.3e} of the max; wave_convolve of channel 0 "
        f"{tuple(wg[0].shape)} x 2, {w_err:.3e} ({DV_OPS_TOL}); "
        f"{time.perf_counter() - t0:.1f} s")
    out.update(resample_err=r_err, wave_err=w_err)
    if not (r_err <= DV_OPS_TOL and w_err <= DV_OPS_TOL
            and float(want.abs().max()) > 0):
        raise RuntimeError("13d: the card and the CPU disagree")
    del model, x, y
    torch.cuda.empty_cache()
    return out


def phase_models(dev, smi):
    """Phase 13: 13a-13d; the launch counts of their main-path runs."""
    out, counts = {}, {}
    for name, fn in (("bf16_simdr", bf16_simdr),
                     ("basic_posenet", basic_posenet)):
        t0 = time.perf_counter()
        out[name], c = fn(dev, smi)
        out[name]["seconds"] = time.perf_counter() - t0
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["deepvoxels"] = deepvoxels_phase(dev, smi)
    out["deepvoxels"]["seconds"] = time.perf_counter() - t0
    return out, counts


# Phase 14 (the parallel paths, the remat knobs, posenet2d in bf16, the
# graft entry points).  14a: the data-parallel step on a one-rank NCCL
# mesh against the step without a mesh, at 'highest' within TRAIN_* and
# at 'default' within DEFAULT_* (phase 6's and 10's limits: the step's
# BatchNorm then takes its moments through two all-reduces, in another
# order than cuDNN's batch norm).  14b: each knob on against all off at
# 'highest', within TRAIN_*; the buffers updated once.  14c: the sharded
# LCT on a (1, 1) mesh against lct_apply, forward and VJP, at the JAX
# package's limits (rtol 2e-4, atol 2e-5 of the largest value).  14d's
# limits are the plain path's own spread: REMAT_BATCH_LIMIT caps the batch
# search of 14b.
SHARDED_LCT_TOL = (2e-4, 2e-5)
KNOBS = {
    "off": dict(stage_remat=False, posenet_remat=False,
                posenet_remat_stem=False),
    "stage_remat": dict(stage_remat=True, posenet_remat=False,
                        posenet_remat_stem=False),
    "posenet_remat": dict(stage_remat=False, posenet_remat=True,
                          posenet_remat_stem=False),
    "posenet_remat_stem": dict(stage_remat=False, posenet_remat=False,
                               posenet_remat_stem=True),
    "all": dict(stage_remat=True, posenet_remat=True,
                posenet_remat_stem=True),
}
REMAT_BATCH_LIMIT = 64
# Launches of a train step with each knob: the recompute launches the
# kernels of what it recomputes once more (K1 in FeatureExtraction and the
# UNet with stage_remat, K4 in the Bottlenecks with posenet_remat, K3 in
# the stem with posenet_remat_stem).
_K4_STEP = sum(r[2] for r in K4_SHAPES)


def _knob_per_step(knobs):
    return dict(
        TRAIN_PER_STEP,
        conv3_planes=(1 + knobs["stage_remat"]) * K1_PER_FORWARD,
        conv3_mxu=(1 + knobs["posenet_remat"]) * _K4_STEP,
        maxpool3d_k3s2p1=1 + knobs["posenet_remat_stem"])


def _set_knobs(model, knobs):
    """The knobs of a built model, in place: NlosPose reads
    ``cfg.stage_remat`` and its PoseNet3D ``remat`` / ``remat_stem`` at
    each forward."""
    import dataclasses

    model.cfg = dataclasses.replace(model.cfg, **knobs)
    model.pose_net.remat = knobs["posenet_remat"]
    model.pose_net.remat_stem = knobs["posenet_remat_stem"]


def _fits(model, lct, weights, batch2, b, precision):
    """Peak memory of one t128 step at batch ``b`` (batch2 tiled), or None
    when it runs out of the card's memory."""
    import gc

    from hiddenpose_tpu_torch.config import TrainConfig
    from hiddenpose_tpu_torch.train.state import TrainState
    from hiddenpose_tpu_torch.train.step import make_train_step

    batch = {k: v.repeat(b // 2, *([1] * (v.dim() - 1)))
             for k, v in batch2.items()}
    model.load_state_dict(weights)
    state = TrainState.create(model, TrainConfig())
    dev = batch["meas"].device
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        make_train_step(model, precision)(state, batch, lct)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(dev)
    except torch.cuda.OutOfMemoryError:
        return None
    finally:
        model.zero_grad(set_to_none=True)
        del state, batch
        gc.collect()
        torch.cuda.empty_cache()


def _largest_batch(model, lct, weights, batch2, precision, tag):
    """The largest even t128 batch whose step fits: the peaks at 2 and 4
    extrapolated, then confirmed (it fits, 2 more does not)."""
    p2 = _fits(model, lct, weights, batch2, 2, precision)
    p4 = _fits(model, lct, weights, batch2, 4, precision)
    total = torch.cuda.get_device_properties(batch2["meas"].device)\
        .total_memory
    b = int(2 + 2 * (total - p2) // max(p4 - p2, 1))
    b = max(2, min(REMAT_BATCH_LIMIT, b - b % 2))
    tries = {2: p2, 4: p4}
    while b > 2 and tries.setdefault(
            b, _fits(model, lct, weights, batch2, b, precision)) is None:
        b -= 2
    while b < REMAT_BATCH_LIMIT and tries.setdefault(
            b + 2, _fits(model, lct, weights, batch2, b + 2,
                         precision)) is not None:
        b += 2
    log(f"[14b remat] {tag}: peak {p2 / 2**30:.3f} GiB at b2, "
        f"{p4 / 2**30:.3f} at b4; largest batch that fits {b} "
        f"({tries[b] / 2**30:.3f} GiB; tried "
        f"{ {k: (None if v is None else round(v / 2**30, 3)) for k, v in sorted(tries.items())} })")
    return dict(peak_b2=p2, peak_b4=p4, largest_batch=b,
                peak_largest=tries[b],
                tried={k: v for k, v in sorted(tries.items())})


def _median_step_ms(step, model, weights, batch, lct, runs=3):
    """Median ms of ``runs`` steps from fresh states (after one warm-up),
    and the peak memory of one."""
    from hiddenpose_tpu_torch.config import TrainConfig
    from hiddenpose_tpu_torch.train.state import TrainState

    out = []
    dev = batch["meas"].device
    for i in range(runs + 1):
        model.load_state_dict(weights)
        st = TrainState.create(model, TrainConfig())
        torch.cuda.reset_peak_memory_stats(dev)
        ms, _ = _event_ms(lambda: step(st, batch, lct))
        if i:
            out.append(ms)
    return float(np.median(out)), torch.cuda.max_memory_allocated(dev)


def phase_parallel(dev, smi):
    """14: the data-parallel step on a one-rank NCCL mesh, the remat knobs,
    the sharded LCT, posenet2d in bf16, and the graft entry points."""
    import torch.distributed as dist

    from hiddenpose_tpu_torch.config import t128_config
    from hiddenpose_tpu_torch.data.synthetic import make_batch
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose
    from hiddenpose_tpu_torch.ops import kernels as K
    from hiddenpose_tpu_torch.parallel.distributed import free_port
    from hiddenpose_tpu_torch.parallel.mesh import make_mesh
    from hiddenpose_tpu_torch.train.step import make_train_step

    torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0)
    out, counts = {}, {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    try:
        mesh = make_mesh(1, 1)
        log(f"[14a dp] NCCL mesh (data {mesh.n_data} x model {mesh.n_model})"
            f" on {mesh.device}, backend {dist.get_backend()}")
        cfg = t128_config()
        m = cfg.model
        weights = t128_weights(cfg)
        model, lct = build_nlospose(m, device=dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
            [0, 1], m.time_size, m.image_size[0], m.grid_dim,
            m.heatmap_size[0], m.bin_len).items()}

        # 14a: the data-parallel step against the step without a mesh
        dp = {}
        for precision, per_step, tols in (
                ("highest", TRAIN_PER_STEP, (TRAIN_LOSS_TOL,
                                             TRAIN_GRAD_L2_TOL,
                                             TRAIN_STATS_TOL,
                                             TRAIN_PARAM_TOL,
                                             TRAIN_SIGN_AGREE)),
                ("default", TRAIN_DEFAULT_PER_STEP, (DEFAULT_LOSS_TOL,
                                                     DEFAULT_GRAD_L2_TOL,
                                                     DEFAULT_STATS_TOL,
                                                     None,
                                                     DEFAULT_SIGN_AGREE))):
            on = make_train_step(model, precision, mesh=mesh)
            off = make_train_step(model, precision)
            r = _train_readings(
                _step_result(model, weights, on, batch, lct, True),
                _step_result(model, weights, off, batch, lct, True))
            _log_readings("14a dp", f"'{precision}': the step on the mesh vs"
                          " without", r)
            ok = (max(r["loss_rel"].values()) <= tols[0]
                  and max(r["grad_rel_l2"].values()) <= tols[1]
                  and r["stats_max_rel"] <= tols[2]
                  and (tols[3] is None or r["param_max_abs"] <= tols[3])
                  and r["sign_agree"] >= tols[4])
            if not ok:
                raise RuntimeError(f"14a: the data-parallel step at "
                                   f"'{precision}' is off")
            K.reset_launch_counts()
            ms_on, peak_on = _median_step_ms(on, model, weights, batch, lct)
            c = K.launch_counts()
            if c != {k: 4 * per_step.get(k, 0) for k in c}:
                raise RuntimeError(f"14a: launch counts {c} over 4 steps, "
                                   f"expected 4 x {per_step}")
            add(c)
            ms_off, peak_off = _median_step_ms(off, model, weights, batch,
                                               lct)
            ms_on2, _ = _median_step_ms(on, model, weights, batch, lct)
            dp[precision] = dict(readings=r, ms_mesh=[ms_on, ms_on2],
                                 ms_no_mesh=ms_off, peak_mesh=peak_on,
                                 peak_no_mesh=peak_off)
            log(f"[14a dp] '{precision}': step ms on the mesh {ms_on:.2f} / "
                f"{ms_on2:.2f}, without {ms_off:.2f} (adds "
                f"{(ms_on + ms_on2) / 2 - ms_off:+.2f} ms); peak "
                f"{peak_on / 2**30:.3f} / {peak_off / 2**30:.3f} GiB  [{smi}]")
        out["14a"] = dp

        # 14b: each remat knob against all off, at 'highest'
        step = make_train_step(model, "highest")
        knobs = {}
        _set_knobs(model, KNOBS["off"])
        base = _step_result(model, weights, step, batch, lct, True)
        for name, kn in KNOBS.items():
            _set_knobs(model, kn)
            tracked = {n: int(b) for n, b in weights.items()
                       if n.endswith("num_batches_tracked")}
            res = _step_result(model, weights, step, batch, lct, True)
            once = all(int(model.state_dict()[n]) == v + 1
                       for n, v in tracked.items())
            r = _train_readings(res, base) if name != "off" else None
            K.reset_launch_counts()
            ms, peak = _median_step_ms(step, model, weights, batch, lct,
                                       runs=2)
            c = K.launch_counts()
            want = _knob_per_step(kn)
            if c != {k: 3 * want.get(k, 0) for k in c} or not once:
                raise RuntimeError(f"14b {name}: launch counts {c} over 3 "
                                   f"steps (expected 3 x {want}); buffers "
                                   f"updated once: {once}")
            add(c)
            knobs[name] = dict(ms=ms, peak_memory_bytes=peak, readings=r,
                               launches_per_step={k: v // 3
                                                  for k, v in c.items()})
            if r is not None:
                _log_readings("14b remat", f"{name} vs all off", r)
                ok = (max(r["loss_rel"].values()) <= TRAIN_LOSS_TOL
                      and max(r["grad_rel_l2"].values()) <= TRAIN_GRAD_L2_TOL
                      and r["stats_max_rel"] <= TRAIN_STATS_TOL
                      and r["param_max_abs"] <= TRAIN_PARAM_TOL
                      and r["sign_agree"] >= TRAIN_SIGN_AGREE)
                if not ok:
                    raise RuntimeError(f"14b: {name} changes the step")
            log(f"[14b remat] {name}: step {ms:.2f} ms (median of 2), peak "
                f"{peak / 2**30:.3f} GiB, buffers updated once: {once}  "
                f"[{smi}]")
        for name in ("off", "all"):
            _set_knobs(model, KNOBS[name])
            knobs[f"largest_batch_{name}"] = _largest_batch(
                model, lct, weights, batch, "default", f"knobs {name}, "
                "'default'")
        _set_knobs(model, KNOBS["stage_remat"])  # the default
        out["14b"] = knobs
        del model
        torch.cuda.empty_cache()

        # 14c: the sharded LCT on the one-rank mesh
        out["14c"] = _sharded_lct_rows(dev, mesh, lct)
        # 14d: posenet2d in bf16
        d, c = _posenet2d_bf16(dev, smi)
        out["14d"] = d
        add(c)
    finally:
        dist.destroy_process_group()
    # 14e: the port's entry() and dryrun_multichip(1) (a process of its own)
    e, c = _entry_points(dev, smi)
    out["14e"] = e
    add(c)
    return out, counts


def _sharded_lct_rows(dev, mesh, lct):
    """14c: ``lct_apply_sharded`` on ``mesh`` against ``lct_apply`` at the
    t128 train step's LCT call (b2 x basedim 1), forward and VJP."""
    from hiddenpose_tpu_torch.ops.lct import lct_apply, lct_apply_sharded

    g = torch.Generator(device=dev).manual_seed(14)
    n = lct.image_size
    x = torch.rand((2, lct.time_size, n, n), generator=g, device=dev)
    w = torch.randn(x.shape, generator=g, device=dev)
    res = {}
    for name, fn in (("plain", lambda v: lct_apply(v, lct)),
                     ("sharded", lambda v: lct_apply_sharded(v, lct, mesh))):
        v = x.clone().requires_grad_(True)
        with deterministic():
            y = fn(v)
            (y * w).sum().backward()
        ms, _ = _event_ms(lambda: fn(x))
        res[name] = (y.detach(), v.grad, ms)
    rtol, atol = SHARDED_LCT_TOL
    errs = {}
    for i, what in ((0, "out"), (1, "vjp")):
        got, want = res["sharded"][i], res["plain"][i]
        err = (got - want).abs()
        lim = atol * float(want.abs().max()) + rtol * want.abs()
        errs[what] = dict(max_abs=float(err.max()),
                          max_rel_of_max=float(err.max()
                                               / want.abs().max()),
                          ok=bool((err <= lim).all()))
    log(f"[14c sharded lct] (1, 1) mesh vs lct_apply at (2, {lct.time_size},"
        f" {n}, {n}): {errs}; forward ms {res['sharded'][2]:.3f} vs "
        f"{res['plain'][2]:.3f}")
    if not all(e["ok"] for e in errs.values()):
        raise RuntimeError("14c: the sharded LCT disagrees with lct_apply")
    return dict(errors=errs, ms_sharded=res["sharded"][2],
                ms_plain=res["plain"][2])


# 14d: the posenet2d NlosPose in bf16, f32 parameters cast at use.  Its
# serving forward with the kernels against the plain versions, by heatmap
# RMS and joints, within POSENET2D_BF16_SPREAD x the plain bf16 forward's
# own distance from the f32 forward on the same weights (two bf16
# forwards that round independently lie about sqrt(2) x that apart), and
# its heatmaps at least POSENET2D_BF16_AWAY x that distance from f32 (it
# rounds as bf16); the joints' mean distance within the larger of
# POSENET2D_BF16_SPREAD x the plain forward's from f32 and phase 9's
# BF16_KP_JOINT_MEAN_TOL (at the peaked weights a joint sits on a voxel,
# and the bf16 and f32 joints may be equal).  The step by parts, as 12b's:
# the whole step kernels vs plain, and the step cut at visible_net's
# output with the 2D net's cotangent shared, each within
# POSENET2D_BF16_SPREAD x the largest reading of the plain path against
# itself on a measurement moved by BF16_MOVE (relative, three seeds): half
# a bf16 ulp, the move of the first conv's output that its rounding to
# bf16 resolves (a 1e-7 move, 12b's, is below it: the rounding absorbs
# it, and its readings are printed beside).
POSENET2D_BF16_SPREAD = 2.0
POSENET2D_BF16_AWAY = 0.25
BF16_MOVE = 2.0 ** -9
# Those whole-step limits are bf16's distance from itself and tell a wrong
# backward only by a large error.  The kernels are also held one call at a
# time inside the step (_held_in_step): every launch of the step's kernels
# on the very arguments the step gave it, at phase 3's and 7's limits, K1
# and K5 against their plain versions within CONV_TOL of the plain
# result's max, K1-bf16 within one bf16 ulp + BF16_ATOL, K8 exactly; both
# sides round at the same places there, so the limit is the kernel's own.
# K6 is held against its function in float64 (_wgrad64) within CONV_TOL:
# dk of dk's max, db of the largest sum of |dz| (a conv that a GroupNorm
# follows has a bias gradient near 0, so db's own max is no scale).  Its
# plain version is not the reference there: on this step's data cuDNN's
# f32 weight gradient lies up to 1.2e-2 of the max from float64 (K6 6.3e-6;
# the first reading held K6 against it: 122 x CONV_TOL), and both are
# printed.
STEP_HELD = {"conv3_planes": "conv", "conv3_planes_bf16": "bf16",
             "conv3_planes_adjoint": "conv", "conv3_planes_wgrad": "wgrad",
             "max_pool2_bwd": "exact"}


def _wgrad64(x, dz, *, pad_mode="zero", has_bias=True):
    """K6's function in float64 (dk in K6's (3, 3, 3, cin, cout) layout,
    db or None)."""
    mode = "replicate" if pad_mode == "edge" else "constant"
    xp = torch.nn.functional.pad(x.double(), (1,) * 6, mode=mode)
    dz = dz.double()
    dk = torch.nn.grad.conv3d_weight(xp, (dz.shape[1], x.shape[1], 3, 3, 3),
                                     dz).permute(2, 3, 4, 1, 0)
    return dk, (dz.sum(dim=(0, 2, 3, 4)) if has_bias else None)


def _held_in_step(run, names=STEP_HELD):
    """Run ``run()`` with each named kernel wrapper replaced, wherever the
    port's modules hold it, by one that launches the kernel, calls its
    plain version on the same arguments and measures the distance
    (``names``: kernel -> limit kind).  Returns run()'s result and
    {kernel: dict(calls, worst[, at_worst])}, ``worst`` the largest error
    over the limit (a pass <= 1; exact: the largest |difference|; inf
    where the kernel's result is not finite), and for K6 at that call
    K6's and the plain version's [dk, db] readings against float64."""
    import sys

    from hiddenpose_tpu_torch.ops import kernels as K

    seen = {n: dict(calls=0, worst=0.0) for n in names}
    patched = []

    def holder(name, orig, plain):
        def held(*args, **kwargs):
            got = orig(*args, **kwargs)
            want = plain(*args, **kwargs)
            pairs = [(g, w) for g, w in zip(
                got if isinstance(got, tuple) else (got,),
                want if isinstance(want, tuple) else (want,))
                if g is not None and w is not None]
            kind, worst, detail = names[name], 0.0, None
            if not all(bool(torch.isfinite(g).all()) for g, _ in pairs):
                worst = float("inf")
            elif kind == "wgrad":
                want64 = [t for t in _wgrad64(*args, **kwargs)
                          if t is not None]
                scales = [want64[0].abs().max().item()]
                if len(pairs) > 1:
                    scales.append(args[1].abs().double().sum(
                        dim=(0, 2, 3, 4)).max().item())
                detail = {side: [
                    (t.double() - t64).abs().max().item()
                    / (CONV_TOL * max(sc, 1e-30))
                    for t, t64, sc in zip(ts, want64, scales)]
                    for side, ts in (("kernel", [g for g, _ in pairs]),
                                     ("plain", [w for _, w in pairs]))}
                worst = max(detail["kernel"])
            else:
                for g, w in pairs:
                    g, w = g.float(), w.float()
                    scale = max(w.abs().max().item(), 1e-30)
                    if kind == "exact":
                        worst = max(worst, (g - w).abs().max().item())
                    elif kind == "bf16":
                        excess = K.bf16_ulp_excess(g, w, BF16_ATOL * scale)
                        worst = max(worst, 0.0 if excess <= 0 else
                                    1.0 + excess / (BF16_ATOL * scale))
                    else:
                        worst = max(worst, (g - w).abs().max().item()
                                    / (CONV_TOL * scale))
            seen[name]["calls"] += 1
            if worst >= seen[name]["worst"]:
                seen[name]["worst"] = worst
                if detail is not None:
                    seen[name]["at_worst"] = detail
            return got

        held.launches = 0
        return held

    for name in names:
        orig, plain = K.KERNELS[name][:2]
        held = holder(name, orig, plain)
        for mod in [m for k, m in sys.modules.items()
                    if k.startswith("hiddenpose_tpu_torch") and m]:
            for attr, val in list(vars(mod).items()):
                if val is orig:
                    setattr(mod, attr, held)
                    patched.append((mod, attr, orig))
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        for mod, attr, orig in patched:
            setattr(mod, attr, orig)
    return out, seen


def _bf16_2d_counts(train):
    """Launches of the bf16 posenet2d NlosPose's serving forward (its
    measurement in bf16) or train step (the measurement f32, as the batch
    holds it)."""
    f32_in = K1_F32_INPUT_TRAIN if train else K1_F32_INPUT_SERVE
    f32 = sum(K1_SHAPES[i][6] for i in f32_in)
    runs = STAGE_RUNS if train else 1
    out = {"conv3_planes": runs * f32,
           "conv3_planes_bf16": runs * (K1_PER_FORWARD - f32)}
    if train:
        out.update(conv3_planes_adjoint=TRAIN_PER_STEP["conv3_planes_adjoint"],
                   conv3_planes_wgrad=TRAIN_PER_STEP["conv3_planes_wgrad"],
                   max_pool2_bwd=TRAIN_PER_STEP["max_pool2_bwd"])
    return out


def _hm_joints(a, b, num_joints):
    """Heatmap RMS difference over b's RMS, and the joints' mean distance
    (voxels)."""
    from hiddenpose_tpu_torch.ops.softargmax import softmax_integral

    a, b = a.float(), b.float()
    rms = float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())
    ja = softmax_integral(a, num_joints).reshape(a.shape[0], -1, 3)
    jb = softmax_integral(b, num_joints).reshape(b.shape[0], -1, 3)
    return rms, float((ja - jb).norm(dim=-1).mean())


def _posenet2d_bf16(dev, smi):
    """14d: the posenet2d NlosPose in bf16 at t128, batch 2."""
    import dataclasses

    from hiddenpose_tpu_torch.config import TrainConfig, t128_config
    from hiddenpose_tpu_torch.data.synthetic import make_batch
    from hiddenpose_tpu_torch.models.nlospose import NlosPose, build_nlospose
    from hiddenpose_tpu_torch.ops import kernels as K
    from hiddenpose_tpu_torch.train.state import TrainState
    from hiddenpose_tpu_torch.train.step import make_train_step
    from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict

    m32 = dataclasses.replace(t128_config().model, backbone="posenet2d")
    m = dataclasses.replace(m32, compute_dtype="bfloat16")
    with torch.device("meta"):
        template = NlosPose(m32)
    weights = peaked_state_dict(template, seed=1)
    model, lct = build_nlospose(m, device=dev)
    model.load_state_dict(weights)
    _, caps = t128_captures(B)
    meas = torch.from_numpy(np.stack(caps)).to(dev).to(torch.bfloat16)

    def forward(mdl, x):
        with torch.inference_mode():
            return mdl(x, lct)[0]

    forward(model, meas)  # warm-up
    K.reset_launch_counts()
    fwd_ms, hm = _event_ms(lambda: forward(model, meas))
    counts = K.launch_counts()
    want = {k: _bf16_2d_counts(False).get(k, 0) for k in counts}
    if counts != want or hm.dtype != torch.bfloat16 \
            or not bool(torch.isfinite(hm.float()).all()):
        raise RuntimeError(f"14d forward: launch counts {counts} (expected "
                           f"{want}), heatmaps {hm.dtype}")
    outs = {}
    for flag in (True, False):
        model.set_use_kernels(flag)
        with deterministic():
            outs[flag] = forward(model, meas)
    model.set_use_kernels(True)
    f32_model, _ = build_nlospose(m32, device=dev)
    f32_model.load_state_dict(weights)
    with deterministic():
        outs["f32"] = forward(f32_model, meas.float())
    del f32_model
    nj = m.num_joints
    kp = _hm_joints(outs[True], outs[False], nj)
    plain_f32 = _hm_joints(outs[False], outs["f32"], nj)
    kern_f32 = _hm_joints(outs[True], outs["f32"], nj)
    fwd = dict(ms=fwd_ms, launches=counts, kernels_vs_plain=kp,
               plain_vs_f32=plain_f32, kernels_vs_f32=kern_f32)
    log(f"[14d posenet2d bf16] serving forward b{B} {fwd_ms:.2f} ms, "
        f"launches {counts}; (heatmap RMS rel, joints mean voxels): kernels"
        f" vs plain {kp}, plain vs f32 {plain_f32}, kernels vs f32 "
        f"{kern_f32}; limits {POSENET2D_BF16_SPREAD} x and at least "
        f"{POSENET2D_BF16_AWAY} x plain vs f32  [{smi}]")
    if not (kp[0] <= POSENET2D_BF16_SPREAD * plain_f32[0]
            and kp[1] <= max(POSENET2D_BF16_SPREAD * plain_f32[1],
                             BF16_KP_JOINT_MEAN_TOL)
            and kern_f32[0] >= POSENET2D_BF16_AWAY * plain_f32[0]):
        raise RuntimeError("14d: the bf16 posenet2d forward is off")

    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        [0, 1], m.time_size, m.image_size[0], m.grid_dim, m.heatmap_size[0],
        m.bin_len).items()}
    step = make_train_step(model)
    model.load_state_dict(weights)
    state = TrainState.create(model, TrainConfig())
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    step_ms = [_event_ms(lambda: step(state, batch, lct))[0]
               for _ in range(2)]
    train_counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    per = _bf16_2d_counts(True)
    if train_counts != {k: 2 * per.get(k, 0) for k in train_counts}:
        raise RuntimeError(f"14d step: launch counts {train_counts}, "
                           f"expected 2 x {per}")
    log(f"[14d posenet2d bf16] train steps at 'highest': "
        f"{[round(x, 2) for x in step_ms]} ms, peak {peak / 2**30:.3f} GiB, "
        f"launches {train_counts}  [{smi}]")
    _, held = _held_in_step(
        lambda: _step_result(model, weights, step, batch, lct, True))
    log(f"[14d posenet2d bf16] each kernel call of the step against its "
        f"plain version on the step's own arguments (calls, largest error "
        f"over its limit; max_pool2_bwd: largest |difference|, exact): "
        f"{held}")
    if any(held[k]["calls"] != per.get(k, 0) for k in held) \
            or any(v["worst"] > (0.0 if STEP_HELD[k] == "exact" else 1.0)
                   for k, v in held.items()):
        raise RuntimeError(f"14d step: a kernel call disagrees with its "
                           f"plain version, or was not seen: {held}")
    kern = _step_result(model, weights, step, batch, lct, True)
    plain = _step_result(model, weights, step, batch, lct, False)
    vs = _train_readings(kern, plain)
    _log_readings("14d posenet2d bf16", "train step, kernels vs plain", vs)
    plain_cut = _posenet2d_cut(model, weights, batch, lct, False)
    _, cot, _ = _posenet2d_head(model, weights, plain_cut["out"], batch)
    cut = {flag: _posenet2d_cut(model, weights, batch, lct, flag, cot)
           for flag in (True, False)}

    def cut_readings(a, b):
        return dict(voxel_loss_rel=abs(a["voxel_loss"] - b["voxel_loss"])
                    / abs(b["voxel_loss"]),
                    grad_rel_l2=_grad_rel_l2(a["grads"], b["grads"]))

    cut_vs = cut_readings(cut[True], cut[False])
    moves = {}
    for move in (1e-7, BF16_MOVE):
        spread, cut_spread = [], []
        for seed in range(3):
            g = torch.Generator(device=dev).manual_seed(seed)
            moved = batch["meas"] * (1 + move * torch.randn(
                batch["meas"].shape, generator=g, device=dev))
            spread.append(_train_readings(_step_result(
                model, weights, step, dict(batch, meas=moved), lct, False),
                plain))
            cut_spread.append(cut_readings(_posenet2d_cut(
                model, weights, batch, lct, False, cot, meas=moved),
                cut[False]))
        moves[move] = (spread, cut_spread)
        log(f"[14d posenet2d bf16] the plain step against itself on a "
            f"{move:.3g} moved measurement: loss rel "
            f"{[max(r['loss_rel'].values()) for r in spread]}, grads rel L2 "
            f"{[r['grad_rel_l2'] for r in spread]}, stats "
            f"{[r['stats_max_rel'] for r in spread]}; the cut: {cut_spread}")
    spread, cut_spread = moves[BF16_MOVE]
    lim = dict(
        loss=POSENET2D_BF16_SPREAD * max(max(r["loss_rel"].values())
                                         for r in spread),
        grads=POSENET2D_BF16_SPREAD * max(max(r["grad_rel_l2"].values())
                                          for r in spread),
        stats=POSENET2D_BF16_SPREAD * max(r["stats_max_rel"]
                                          for r in spread),
        cut_voxel=POSENET2D_BF16_SPREAD * max(r["voxel_loss_rel"]
                                              for r in cut_spread),
        cut_grads=POSENET2D_BF16_SPREAD * max(max(r["grad_rel_l2"].values())
                                              for r in cut_spread))
    log(f"[14d posenet2d bf16] kernels vs plain cut {cut_vs}; limits {lim}")
    ok = (max(vs["loss_rel"].values()) <= lim["loss"]
          and max(vs["grad_rel_l2"].values()) <= lim["grads"]
          and vs["stats_max_rel"] <= lim["stats"]
          and cut_vs["voxel_loss_rel"] <= lim["cut_voxel"]
          and max(cut_vs["grad_rel_l2"].values()) <= lim["cut_grads"])
    if not ok:
        raise RuntimeError("14d: the bf16 posenet2d step's kernels and "
                           "plain versions disagree")
    return dict(forward=fwd, step_ms=step_ms, peak_memory_bytes=peak,
                kernel_calls_in_step=held, kernels_vs_plain=vs, cut_kernels_vs_plain=cut_vs,
                plain_vs_moved_plain={str(k): v for k, v in moves.items()},
                limits=lim), \
        {k: counts.get(k, 0) + train_counts.get(k, 0)
         for k in set(counts) | set(train_counts)}


def _entry_points(dev, smi):
    """14e: the port's ``entry()`` forward at HP_ENTRY_SIZE=64 on the card,
    kernels against plain, and ``dryrun_multichip(1)`` over NCCL."""
    from hiddenpose_tpu_torch.graft_entry import dryrun_multichip, entry
    from hiddenpose_tpu_torch.ops import kernels as K

    saved = os.environ.get("HP_ENTRY_SIZE")
    os.environ["HP_ENTRY_SIZE"] = "64"
    try:
        fn, args = entry()
    finally:
        if saved is None:
            del os.environ["HP_ENTRY_SIZE"]
        else:
            os.environ["HP_ENTRY_SIZE"] = saved
    model = args[0]
    fn(*args)  # warm-up
    K.reset_launch_counts()
    ms, (joints, hm) = _event_ms(lambda: fn(*args))
    counts = K.launch_counts()
    outs = {}
    for flag in (True, False):
        model.set_use_kernels(flag)
        with deterministic():
            outs[flag] = fn(*args)[1]
    model.set_use_kernels(True)
    rel = float((outs[True] - outs[False]).abs().max()
                / outs[False].abs().max())
    log(f"[14e entry] entry() forward at 64^3: joints {tuple(joints.shape)}"
        f", heatmaps {tuple(hm.shape)} in {ms:.2f} ms, launches {counts}; "
        f"kernels vs plain heatmaps max rel {rel:.3e} ({E2E_HM_TOL})")
    if not (bool(torch.isfinite(joints).all()) and rel <= E2E_HM_TOL
            and min(counts.values()) >= 0 and sum(counts.values()) > 0):
        raise RuntimeError("14e: entry()'s forward is off")
    del model, args, fn
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dry = dryrun_multichip(1)
    dry_s = time.perf_counter() - t0
    log(f"[14e entry] dryrun_multichip(1) over NCCL: {dry} in {dry_s:.1f} s"
        f" (a process of its own)")
    if not (np.isfinite(dry["loss"]) and dry["device"].startswith("cuda")):
        raise RuntimeError(f"14e: dryrun_multichip(1) gave {dry}")
    return dict(entry_ms=ms, entry_launches=counts, entry_hm_rel=rel,
                dryrun=dry, dryrun_seconds=dry_s), counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke test runs only on a GPU", file=sys.stderr)
        return 2
    try:
        import hiddenpose_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import hiddenpose_tpu_torch ({e}); run it "
              "from the root of a checkout, beside the package",
              file=sys.stderr)
        return 1
    adopt_orphans()
    try:
        return run()
    finally:
        t0 = time.perf_counter()
        stopped = stop_children()
        # stderr: the result line stays the last line of stdout
        print(f"chip_smoke: the loader's fork server stopped and children "
              f"reaped in {time.perf_counter() - t0:.3f} s; killed "
              f"{len(stopped)} child processes still running {stopped}",
              file=sys.stderr, flush=True)


def run() -> int:
    """Phases 1-14 (1, 2 and 11 with ``--loop``, 1, 2 and 12 with
    ``--alt``, 1, 2 and 13 with ``--models``, 1, 2 and 14 with
    ``--parallel``) and the result lines."""
    # cuBLAS is deterministic only with a fixed workspace; set before the
    # first CUDA call (deterministic() checks for it)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # full f32 for the plain versions and the library convs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda:0")

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log(f"[{name}] phase done in {seconds[name]:.1f} s")
        return out

    smi = timed("1 toolchain", phase_toolchain)
    timed("2 build", phase_build)
    if sys.argv[1:] == ["--loop"]:  # phase 11 alone, with its own bare step
        train_loop, _ = timed("11 train loop", phase_train_loop, dev, smi)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_loop.json").write_text(json.dumps(dict(
            device=smi, seconds=seconds, train_loop=train_loop), indent=1))
        log(f"[11 train loop] alone: done  [{smi}]")
        return 0
    if sys.argv[1:] == ["--models"]:  # phase 13 alone
        models, model_counts = timed("13 models", phase_models, dev, smi)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_models.json").write_text(json.dumps(dict(
            device=smi, seconds=seconds, models=models,
            launches=model_counts), indent=1, default=str))
        log(f"[13 models] alone: done  [{smi}]")
        return 0
    if sys.argv[1:] == ["--parallel"]:  # phase 14 alone
        par, par_counts = timed("14 parallel", phase_parallel, dev, smi)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_parallel.json").write_text(json.dumps(dict(
            device=smi, seconds=seconds, parallel=par,
            launches=par_counts), indent=1, default=str))
        log(f"[14 parallel] alone: done  [{smi}]")
        return 0
    if sys.argv[1:] == ["--alt"]:  # phase 12 alone
        alt, alt_counts = timed("12 alt objectives", phase_alt_objectives,
                                dev, smi)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_alt.json").write_text(json.dumps(dict(
            device=smi, seconds=seconds, alt_objectives=alt,
            launches=alt_counts), indent=1, default=str))
        log(f"[12 alt objectives] alone: done  [{smi}]")
        return 0
    rows, stem_vjp = timed("3 kernels", phase_kernels, dev)
    server, caps, serve, serve_counts = timed("4 serve", phase_serve, dev,
                                              smi)
    e2e = timed("5 e2e", phase_end_to_end, server, caps)
    del server
    torch.cuda.empty_cache()
    train, train_counts, highest = timed("6 train", phase_train, dev, smi)
    torch.cuda.empty_cache()
    sformer, sformer_counts = timed("7 sformer", phase_sformer, dev, smi)
    probe_rows, probe_counts, probes = timed("8 probes", phase_probes, dev)
    rows.update(probe_rows)
    torch.cuda.empty_cache()
    bf16_rows_, bf16_counts, serve_bf16 = timed(
        "9 serve bf16", phase_serve_bf16, dev, smi, serve)
    rows.update(bf16_rows_)
    torch.cuda.empty_cache()
    prec_rows, prec_counts, train_precision = timed(
        "10 train precision", phase_train_precision, dev, smi, highest)
    rows.update(prec_rows)
    del highest
    torch.cuda.empty_cache()
    train_loop, loop_counts = timed(
        "11 train loop", phase_train_loop, dev, smi,
        [s_["ms"] for s_ in train_precision["f32 default"]["steps"]])
    torch.cuda.empty_cache()
    alt, alt_counts = timed("12 alt objectives", phase_alt_objectives, dev,
                            smi)
    torch.cuda.empty_cache()
    models, model_counts = timed("13 models", phase_models, dev, smi)
    torch.cuda.empty_cache()
    par, par_counts = timed("14 parallel", phase_parallel, dev, smi)

    from hiddenpose_tpu_torch.ops.kernels import KERNELS

    kernels = []
    for name, (_, _, source, replaces) in KERNELS.items():
        # Times are summed over one unit of the kernel's main path: one b2
        # train step's calls (one b2 serving forward's for the stem conv
        # and for the bf16 kernels, one f32 Sformer forward's for attend,
        # one run of the probe script for a probe); a shape the unit does
        # not call weighs 0.
        r = rows[name]
        per = [x.get("per_step", x.get("per_forward", x.get("per_run")))
               for x in r]
        on_path = [x for x, n in zip(r, per) if n]

        def total(key):
            return sum(x[key] * n for x, n in zip(r, per) if n)

        by_bytes = sum(x["bound_ms"] * n for x, n in zip(r, per)
                       if n and x["bound_by"] == "bytes")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            # each main path's launches, counted from 0 just before it:
            # the serving burst, the 3 train steps, the 3 Sformer
            # captures, the probe script, the bf16 serving burst, phase
            # 10's 3 + 1 + 3 train steps at 'default', 'high' and bf16,
            # phase 11's train loop (4 steps at 'default'), phase 12's
            # 3 + 1 SimDR steps, posenet2d forward and 2 steps, and
            # heatmap3d step, phase 13's 3 + 1 bf16 SimDR steps and
            # the basic PoseNet3D's f32 and bf16 forwards, train forward +
            # backward and library-stem forward, and phase 14's timed
            # data-parallel steps (4 + 4), remat-knob steps (5 x 3), bf16
            # posenet2d forward and 2 steps, and entry() forward
            launches=(serve_counts[name] + train_counts[name]
                      + sformer_counts[name] + probe_counts[name]
                      + bf16_counts[name] + prec_counts[name]
                      + loop_counts[name] + alt_counts.get(name, 0)
                      + model_counts.get(name, 0)
                      + par_counts.get(name, 0)),
            max_abs_err=max(x["max_abs_err"] for x in on_path),
            max_abs_err_all_shapes=max(x["max_abs_err"] for x in r),
            ms=total("ms"), plain_ms=total("plain_ms"),
            bound_ms=total("bound_ms"),
            bound_by=("bytes" if by_bytes >= total("bound_ms") / 2
                      else "operations"),
            library_ms=(total("library_ms") if all(
                x["library_ms"] is not None for x in on_path) else None)))
        if "device_ms" in on_path[0]:  # the probes: a CUDA graph's replay
            kernels[-1].update(device_ms=total("device_ms"))
        if "bound_fma_ms" in on_path[0]:  # K2, K4, K4-dx, K9: FMA bound
            kernels[-1].update(bound_fma_ms=total("bound_fma_ms"))
        if "err_vs_f64" in on_path[0]:  # those, K6, K2-/K4-bf16: float64
            kernels[-1].update(
                err_vs_f64=max(x["err_vs_f64"] for x in on_path),
                plain_err_vs_f64=max(x["plain_err_vs_f64"] for x in on_path))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(dict(
        device=smi, seconds=seconds, kernels=rows, kernels_line=kernels,
        stem_vjp=stem_vjp,
        serve=serve, end_to_end=e2e, train=train, sformer=sformer,
        probes=probes, serve_bf16=serve_bf16,
        train_precision=train_precision, train_loop=train_loop,
        alt_objectives=alt, models=models, parallel=par), indent=1,
        default=str))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
