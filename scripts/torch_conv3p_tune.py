"""K1 and K5 (``hiddenpose_tpu_torch/csrc/conv3p_tile.cuh``) shape by shape
on one GPU: each call shape of a t128 batch-2 train step against its plain
version and beside its library call, the wrappers' host time, and a sweep
of the plan's constants.

    python3 scripts/torch_conv3p_tune.py [--sweep [CONSTANT ...]] [--host]
                                         [--diag]

Run from the root of a checkout on a host with an NVIDIA H100 and ``nvcc``.
For every row of ``chip_smoke.K1_SHAPES`` it checks ``conv3_planes`` (and,
where the input needs a gradient, ``conv3_planes_adjoint``) against the
plain version (``CONV_TOL``) and a second call bit for bit, then reads the
kernel's and the library call's device time (and the kernel's launch
alone, into a preallocated output, which the host does not hold back):
medians of 20 readings of 10 launches each, taken in turns.  The library calls are ``F.conv3d`` on a
padded copy and ``conv3d_input`` with padding 1 (TF32 off).

``--host`` reads the host time of a call: a ``time.perf_counter`` loop of
1000 calls with no synchronisation inside, the wrapper beside the library
call, at the smallest shapes (where the device finishes before the host
has enqueued the next call).

``--sweep`` repeats the timing under other values of the plan's constants
(``TILE_FORMS``, ``TILE_POSITIONS``, ``TILE_BLOCKS_LONG``, ``TILE_LONG_CHUNK``, ``TILE_BLOCKS``, ``TILE_SM_THREADS``,
``TILE_SLOT_BYTES``, ``TILE_TAPS_BYTES`` of ``ops/kernels/conv3p.py``), one at a time, and prints each setting's
sum over a step's calls beside the shipped one's.

``--diag`` takes the kernel apart, since no profiler that reads a kernel's
pipes runs everywhere: it rebuilds ``csrc/conv3p_tile.cuh`` with one part
left out at a time, by text substitution (the results are wrong on
purpose; only the times are read), and times the launch alone at the
largest shapes: without the taps' shared-memory loads (constants instead),
without the values' loads, without the FMAs (staging, barriers and
epilogue alone), without the staging copies, and the FMA-less build again
without its output stores, its halo-column copies, its taps' copies and
all of its copies.  The source is restored at
the end.

Prints one line a shape and writes ``chiprun_out/torch_conv3p_tune.json``.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.grad import conv3d_input

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the call shapes, cuda_ms, CONV_TOL)
from hiddenpose_tpu_torch.ops import kernels as K  # noqa: E402
from hiddenpose_tpu_torch.ops.kernels import _build  # noqa: E402
from hiddenpose_tpu_torch.ops.kernels import conv3p  # noqa: E402

B = chip_smoke.B
SWEEP = {
    "TILE_FORMS": (((4, 4),),),
    "TILE_POSITIONS": (64, 256),
    "TILE_BLOCKS_LONG": (132, 528),
    "TILE_LONG_CHUNK": (4, 8),
    "TILE_BLOCKS": (64, 264),
    "TILE_SM_THREADS": (256, 1024),
    "TILE_SLOT_BYTES": (16 * 1024, 32 * 1024),
    "TILE_TAPS_BYTES": (16 * 1024, 32 * 1024),
}


HEADER = _build.CSRC / "conv3p_tile.cuh"
# name -> [(text of the shipped header, its replacement), ...]
DIAG = {
    "no tap loads": [
        ("""          const float4 w4 = *reinterpret_cast<const float4*>(
              wc + (kh * 3 + kw) * CB + 4 * q);""",
         """          const float4 w4 = make_float4(kh + 1.f, kw + 2.f, q + 3.f,
                                        kh * 3 + kw + 4.f);"""),
        ("w[j] = wc[(kh * 3 + kw) * CB + j];", "w[j] = kh * 3 + kw + j + 1.f;"),
    ],
    "no value loads": [
        ("v[yy][kw] = xb[yy * XW + kw];",
         "v[yy][kw] = (float)(yy * 3 + kw + ch);"),
    ],
    "no FMAs (staging, barriers, epilogue)": [
        ("for (int ch = c.split; ch < nc; ch += a.splits) {",
         "for (int ch = c.split; ch < 0; ch += a.splits) {"),
    ],
    "no staging copies": [
        ("if (u + NSLOT - 1 < c.nunits) stage",
         "if (u + NSLOT - 1 < -1) stage"),
    ],
}
_NO_FMAS = DIAG["no FMAs (staging, barriers, epilogue)"]
DIAG.update({
    "no FMAs, no output stores": _NO_FMAS + [
        ("a.out[o] = v;", "if (v == 1.2345f) a.out[o] = v;")],
    "no FMAs, no halo-column copies": _NO_FMAS + [
        ("it < (c.halo_zeroed ? 0 : nc * XH * 2);", "it < 0;")],
    "no FMAs, no taps staged": _NO_FMAS + [
        ("if (!c.w_resident || u < c.G) {", "if (u < -9) {")],
    "no FMAs, no staging copies": _NO_FMAS + DIAG["no staging copies"],
})
DIAG_SHAPES = ("K1 1->1 @128^3 edge", "K1 1->1 @128^3 zero",
               "K5 1->1 @128^3 edge",
               "K1 4->4 @128^3 zero", "K1 8->4 @128^3 zero",
               "K5 8->4 @128^3 zero", "K1 8->8 @64^3 zero",
               "K1 32->32 @16^3 zero")


def diag(cases):
    """ms of the launch alone under each build of DIAG."""
    shipped = HEADER.read_text()
    picked = []
    for name in DIAG_SHAPES:
        picked.append(next(c for c in cases if c["name"] == name))
    out = {}
    try:
        for label, subs in [("shipped", [])] + list(DIAG.items()):
            text = shipped
            for old, new in subs:
                if old not in text:
                    raise RuntimeError(f"conv3p_tile.cuh no longer holds "
                                       f"{old!r}")
                text = text.replace(old, new)
            HEADER.write_text(text)
            _build.reset()
            out[label] = {}
            for c in picked:
                ms = float(np.median([chip_smoke.cuda_ms(c["launch"], 10)
                                      for _ in range(7)]))
                out[label][c["name"]] = ms
                print(f"[diag] {label:40s} {c['name']:24s} {ms:.4f} ms",
                      flush=True)
    finally:
        HEADER.write_text(shipped)
        _build.reset()
    return out


def make_cases(dev):
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    cases = []
    for cin, cout, n, pad, act, res, count, dx, _ in chip_smoke.K1_SHAPES:
        x = randn(B, cin, n, n, n)
        k = randn(3, 3, 3, cin, cout, scale=(27 * cin) ** -0.5)
        bias = randn(cout, scale=0.1)
        r = randn(B, cout, n, n, n) if res else None
        dz = randn(B, cout, n, n, n)
        xp = F.pad(x, (1,) * 6,
                   mode="replicate" if pad == "edge" else "constant")
        w = k.permute(4, 3, 0, 1, 2).contiguous()
        kw = dict(act=act, pad_mode=pad)
        name = f"{cin}->{cout} @{n}^3 {pad}"
        o1, o5 = torch.empty_like(dz), torch.empty_like(x)

        def raw1(x=x, k=k, bias=bias, r=r, o1=o1, act=act, pad=pad,
                 dims=(B, cin, cout, n, n, n)):
            _build.launch(
                "hp_conv3p_fwd", x.data_ptr(), k.data_ptr(), bias.data_ptr(),
                _build.ptr(r), None, None, o1.data_ptr(), _build.int_args(
                    *dims, conv3p._PADS[pad], conv3p._ACTS[act], 0,
                    *conv3p.tile_plan(*dims)), device=dev)

        def raw5(dz=dz, k=k, o5=o5, pad=pad, dims=(B, cin, cout, n, n, n)):
            _build.launch(
                "hp_conv3p_adjoint", dz.data_ptr(), k.data_ptr(),
                o5.data_ptr(), _build.int_args(
                    *dims, conv3p._PADS[pad], *conv3p.tile_plan(
                        dims[0], dims[2], dims[1], *dims[3:])), device=dev)

        cases.append(dict(
            name="K1 " + name, count=count, launch=raw1,
            kernel=lambda x=x, k=k, bias=bias, r=r, kw=kw:
                K.conv3_planes(x, k, bias, r, **kw),
            plain=lambda x=x, k=k, bias=bias, r=r, kw=kw:
                K.conv3_planes_ref(x, k, bias, r, **kw),
            library=lambda xp=xp, w=w, bias=bias: F.conv3d(xp, w, bias),
            plan=conv3p.tile_plan, plan_args=(B, cin, cout, n, n, n)))
        if dx:
            cases.append(dict(
                name="K5 " + name, count=count, launch=raw5,
                kernel=lambda dz=dz, k=k, pad=pad:
                    K.conv3_planes_adjoint(dz, k, pad_mode=pad),
                plain=lambda dz=dz, k=k, pad=pad:
                    K.conv3_planes_adjoint_ref(dz, k, pad_mode=pad),
                library=lambda x=x, w=w, dz=dz:
                    conv3d_input(x.shape, w, dz, padding=1),
                plan=conv3p.tile_plan, plan_args=(B, cout, cin, n, n, n)))
    return cases


def check(case):
    got, again, want = case["kernel"](), case["kernel"](), case["plain"]()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if not err <= chip_smoke.CONV_TOL * scale:
        raise RuntimeError(f"{case['name']}: max err {err:.3e} of {scale:.3e}")
    if not torch.equal(got, again):
        raise RuntimeError(f"{case['name']}: two calls differ")
    return err


def medians(case, readings=20, iters=10):
    reads = {"kernel": [], "library": [], "launch": []}
    for _ in range(readings):
        for key in reads:
            reads[key].append(chip_smoke.cuda_ms(case[key], iters))
    return {key: float(np.median(v)) for key, v in reads.items()}


def host_us(fn, calls=1000):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def time_all(cases, label, readings=20):
    rows, total = [], {"K1": [0.0, 0.0], "K5": [0.0, 0.0]}
    for c in cases:
        m = medians(c, readings)
        plan = c["plan"](*c["plan_args"])
        rows.append(dict(name=c["name"], count=c["count"], ms=m["kernel"],
                         library_ms=m["library"], launch_ms=m["launch"],
                         plan=plan._asdict()))
        total[c["name"][:2]][0] += m["kernel"] * c["count"]
        total[c["name"][:2]][1] += m["library"] * c["count"]
        flag = "  SLOWER" if m["kernel"] > 1.1 * m["library"] else ""
        print(f"[{label}] {c['name']:28s} kernel {m['kernel']:.4f} ms (the "
              f"launch alone {m['launch']:.4f})  library {m['library']:.4f} "
              f"ms  {tuple(plan)}{flag}", flush=True)
    for key, (k_ms, l_ms) in total.items():
        print(f"[{label}] {key}: a step's calls {k_ms:.3f} ms, library "
              f"{l_ms:.3f} ms", flush=True)
    return dict(label=label, rows=rows,
                totals={k: dict(ms=v[0], library_ms=v[1])
                        for k, v in total.items()})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", nargs="*", metavar="CONSTANT",
                    help="all of the plan's constants, or those named")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--diag", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = chip_smoke.smi_line()
    print(f"device: {smi}", flush=True)
    _build.library()
    print(f"build {_build.build_seconds:.1f} s")
    show = False
    for line in _build.build_log.splitlines():
        if line.startswith("=="):
            show = "conv3p.cu" in line or "conv3p_adjoint.cu" in line
        if show and ("==" in line or "registers" in line or "spill" in line):
            print("[build] " + line.strip())
    cases = make_cases(dev)
    for c in cases:
        c["err"] = check(c)
    print(f"{len(cases)} shapes agree with their plain versions, two calls "
          "bit for bit", flush=True)
    out = dict(device=smi, runs=[time_all(cases, "shipped")])
    if args.host:
        host = []
        for c in cases:
            if "@16^3" in c["name"] or "@8^3" in c["name"]:
                row = dict(name=c["name"], wrapper_us=host_us(c["kernel"]),
                           library_us=host_us(c["library"]))
                host.append(row)
                print(f"[host] {c['name']:28s} wrapper {row['wrapper_us']:.1f}"
                      f" us a call, library {row['library_us']:.1f} us",
                      flush=True)
        # the pieces of a wrapper's call, at 16->16 @16^3
        x = torch.randn((B, 16, 16, 16, 16), device=dev)
        k = torch.randn((3, 3, 3, 16, 16), device=dev)
        o = torch.empty_like(x)
        plan = conv3p.tile_plan(B, 16, 16, 16, 16, 16)
        raw = (x.data_ptr(), k.data_ptr(), None, None, None, None,
               o.data_ptr(),
               _build.int_args(B, 16, 16, 16, 16, 16, 0, 0, 0, *plan))
        pieces = {
            "entry point alone (stream lookup, ctypes call, launch)":
                lambda: _build.launch("hp_conv3p_fwd", *raw, device=dev),
            "the same, the stream by torch.cuda.current_stream()":
                lambda: _build.launch("hp_conv3p_fwd", *raw),
            "new_empty of the output": lambda: x.new_empty(
                (B, 16, 16, 16, 16)),
            "the wrapper's checks (a CPU call's share is the rest)":
                lambda: (_build.no_grad_inputs("x", x, k, None, None, None,
                                               None, use="y"),
                         _build.check(x, "x", device=dev),
                         _build.check(k, "k", device=dev)),
            "tile_plan (cached)": lambda: conv3p.tile_plan(B, 16, 16, 16, 16,
                                                           16),
        }
        out["host_pieces"] = {}
        for name, fn in pieces.items():
            out["host_pieces"][name] = host_us(fn)
            print(f"[host] {name}: {out['host_pieces'][name]:.1f} us",
                  flush=True)
        out["host"] = host
    if args.sweep is not None:
        for name, values in SWEEP.items():
            if args.sweep and name not in args.sweep:
                continue
            shipped = getattr(conv3p, name)
            for v in values:
                setattr(conv3p, name, v)
                conv3p.tile_plan.cache_clear()
                for c in cases:
                    check(c)
                out["runs"].append(time_all(cases, f"{name}={v}", 7))
            setattr(conv3p, name, shipped)
            conv3p.tile_plan.cache_clear()
        out["runs"].append(time_all(cases, "shipped again"))
    if args.diag:
        out["diag"] = diag(cases)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "torch_conv3p_tune.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
