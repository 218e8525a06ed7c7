"""The yardstick's arithmetic: the card's peaks, the operations and bytes
of each of the program's kernels at the shapes a configuration gives
them, and the FLOP of a unit of work.

Peaks are NVIDIA's published figures for one H100 SXM at its full 700 W
limit, dense: a card set to a lower ``power.limit`` (printed beside every
run) reaches less.  A kernel call's bound is the larger of its FLOP over
the peak of the type it computes in and its bytes over the memory rate,
each input read once and each output written once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

BANDWIDTH = 3.35e12                    # bytes/s of HBM3
PEAK = {"f32": 67e12,                  # fp32 FMA outside the tensor cores
        "tf32": 495e12,                # tensor cores, TF32 operands
        "bf16": 989e12}                # tensor cores, bf16 operands

# The CUDA kernels the program's kernel library defines (its __global__
# functions), by the name the profiler gives them before any template
# argument or parameter list.
PROGRAM_KERNELS = (
    "conv3p_tile_kernel", "conv3p_wgrad_partial", "conv3p_wgrad_reduce",
    "conv3_tf32x3_kernel", "prep_kernel", "conv3_bf16_kernel",
    "prep_bf16_kernel", "maxpool_k3s2p1_kernel",
    "maxpool_k3s2p1_bf16_kernel", "maxpool_k3s2p1_vjp_kernel",
    "maxpool2_bwd_kernel", "stem_conv_tc_kernel", "stem_weights_kernel",
    "stem_conv_bf16_kernel", "stem_weights_bf16_kernel", "attend_tc_kernel",
    "attend_tc_split_kernel", "attend_simt_kernel", "combine_kernel",
    "probe_im2col_kernel", "probe_slice_transpose_kernel",
    "probe_dot_kernel")

Call = Tuple[str, float, str, float]   # (wrapper, FLOP, peak type, bytes)


def bound_s(flop: float, peak: str, nbytes: float) -> float:
    """The least time the card could take for one call, in seconds."""
    return max(flop / PEAK[peak] if flop else 0.0, nbytes / BANDWIDTH)


def k1_rows(model: dict, arch: dict):
    """The 3^3 stencil convs of one forward, FeatureExtraction then the
    UNet level by level: (c_in, c_out, extent, residual, input needs a
    gradient, bias)."""
    n, b, g = arch["unet_width"], model["basedim"], model["grid_dim"]
    c = model["in_channels"]
    rows = [(c, b, g, False, False, True)]                   # conv_in
    rows += [(b, b, g, False, True, True), (b, b, g, True, True, True)] * 2
    rows += [(c, 1, g, True, False, False)]                  # corner conv
    widths = [n, 2 * n, 4 * n, 8 * n, 8 * n]
    cin = c
    for lvl, w in enumerate(widths):                         # conv, enc1-4
        e = g >> lvl
        rows += [(cin, w, e, False, True, True), (w, w, e, False, True, True)]
        cin = w
    for lvl, (cin, w) in zip((3, 2, 1, 0), ((16 * n, 4 * n), (8 * n, 2 * n),
                                           (4 * n, n), (2 * n, n))):
        e = g >> lvl                                          # dec1-4
        rows += [(cin, w, e, False, True, True), (w, w, e, False, True, True)]
    return rows


def k1_call(cin: int, cout: int, extent: int, residual: bool, bias: bool,
            batch: int, in_bytes: int, out_bytes: int):
    """(FLOP, bytes) of one serving K1 call: f32 weights, bias and sums,
    the input and output (and a residual) in their types."""
    vox = batch * extent ** 3
    nbytes = (in_bytes * cin * vox + 4 * 27 * cin * cout + 4 * cout * bias
              + out_bytes * cout * vox * (1 + residual))
    return 2 * 27 * cin * cout * vox, nbytes


def serve_calls(model: dict, arch: dict, batch: int) -> List[Call]:
    """The program's kernel calls of one serving forward of the bfloat16
    model at ``batch``: K1-bf16 on every stencil conv but the UNet's first
    (its input is the float32 normalised feature: K1, f32 out), and for
    the 3D backbone the stem K2-bf16, its pool K3-bf16 and K4-bf16 on the
    stride-1 conv2 of every block of width 64-256."""
    calls = []
    unet_first = 6
    for i, (cin, cout, e, res, _, bias) in enumerate(k1_rows(model, arch)):
        isz = 4 if i == unet_first else 2
        flop, nbytes = k1_call(cin, cout, e, res, bias, batch, isz, isz)
        calls.append(("conv3_planes" if i == unet_first
                      else "conv3_planes_bf16", flop, "f32", nbytes))
    if model["backbone"] != "posenet3d_50":
        return calls
    p = arch["posenet3d"]
    g, w0 = model["grid_dim"], p["widths"][0]
    k = p["stem_kernel"] ** 3
    vox = batch * g ** 3
    calls.append(("stem_conv_raw_bf16", 2 * k * w0 * vox, "bf16",
                  2 * vox + 2 * k * w0 + 8 * w0 + 2 * w0 * vox))
    calls.append(("maxpool3d_k3s2p1_bf16", 0.0, "bf16",
                  2 * w0 * vox + 2 * w0 * vox // 8))
    calls += [("conv3_mxu_bf16", *c) for c in _k4(model, p, batch, "serve")]
    return calls


def _k4(model, p, batch, kind):
    """(FLOP, peak, bytes) of K4-bf16 (serving, bf16 in and out, the bn2
    affine in f32) or of K4-dx-bf16 in the float32 model's step (bf16 dz
    and taps, f32 out) on every stride-1 3^3 conv of width 64-256."""
    out = []
    e = model["grid_dim"] // 2
    for s, (w, blocks) in enumerate(zip(p["widths"], p["layers"])):
        if s > 0:
            e //= 2
        if w > 256:
            continue
        vox = batch * e ** 3
        n = blocks - (1 if s > 0 else 0)
        flop = 2 * 27 * w * w * vox
        if kind == "serve":
            nbytes = 2 * w * vox + 2 * 27 * w * w + 8 * w + 2 * w * vox
        else:
            nbytes = 2 * w * vox + 2 * 27 * w * w + 4 * w * vox
        out += [(flop, "bf16", nbytes)] * n
    return out


def train_calls(model: dict, arch: dict, batch: int) -> List[Call]:
    """The program's kernel calls of one float32 train step at the
    'default' precision: each stencil conv's K1 forward, twice with
    ``stage_remat`` (FeatureExtraction and the UNet recompute in the
    backward), K6 for its weight gradient, K5 for its input's where the
    input needs one; the UNet's four pools' backward K8; the stem pool's
    K3, twice with ``posenet_remat_stem``, and its backward K7; K4-dx-bf16
    for the Bottleneck conv2s' input gradient (at 'default' their forward
    is the library's, so ``posenet_remat`` adds no kernel call)."""
    stage_runs = 2 if model["stage_remat"] else 1
    stem_runs = 2 if model["posenet_remat_stem"] else 1
    calls = []
    for cin, cout, e, res, dx, bias in k1_rows(model, arch):
        vox = batch * e ** 3
        flop = 2 * 27 * cin * cout * vox
        w = 4 * 27 * cin * cout
        fwd = (4 * cin * vox + w + 4 * cout * bias + 4 * cout * vox * res
               + 4 * cout * vox)
        calls += [("conv3_planes", flop, "f32", fwd)] * stage_runs
        calls.append(("conv3_planes_wgrad", flop, "f32",
                      4 * cin * vox + 4 * cout * vox + w + 4 * cout * bias))
        if dx:
            calls.append(("conv3_planes_adjoint", flop, "f32",
                          4 * cout * vox + w + 4 * cin * vox))
    n, g = arch["unet_width"], model["grid_dim"]
    for lvl, c in enumerate((n, 2 * n, 4 * n, 8 * n)):
        vox = batch * (g >> lvl) ** 3
        calls.append(("max_pool2_bwd", 0.0, "f32",
                      4 * c * vox + 4 * c * vox // 8 + 4 * c * vox))
    if model["backbone"] != "posenet3d_50":
        return calls
    p = arch["posenet3d"]
    vox, w0 = batch * g ** 3, p["widths"][0]
    calls += [("maxpool3d_k3s2p1", 0.0, "f32",
               4 * w0 * vox + 4 * w0 * vox // 8)] * stem_runs
    calls.append(("maxpool3d_k3s2p1_vjp", 0.0, "f32",
                  4 * w0 * vox + 4 * w0 * vox // 8 + 4 * w0 * vox))
    calls += [("conv3_mxu_dx_bf16", *c) for c in _k4(model, p, batch, "dx")]
    return calls


def per_unit(calls: List[Call]) -> Tuple[Dict[str, int], Dict[str, float]]:
    """(launches, summed bound in seconds) of each wrapper in ``calls``."""
    n: Dict[str, int] = {}
    s: Dict[str, float] = {}
    for name, flop, peak, nbytes in calls:
        n[name] = n.get(name, 0) + 1
        s[name] = s.get(name, 0.0) + bound_s(flop, peak, nbytes)
    return n, s


def busy_seconds(intervals) -> float:
    """Length of the union of [start, end) intervals, in their unit."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def kernel_name(name: str) -> str:
    """A device kernel's function name: no return type, template arguments
    or parameter list."""
    head = name.replace("(anonymous namespace)::", "")
    head = head.split("(")[0].split("<")[0].strip()
    return head.split()[-1].split("::")[-1] if head else name


def count_flop(fn) -> int:
    """The FLOP that ``torch.utils.flop_counter`` counts for ``fn()``
    (matrix products and convolutions, forward and backward; FFTs are not
    counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())
