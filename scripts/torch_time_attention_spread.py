"""Kernels against plain for the tiny time-attention models of
``tests/test_torch_kernels_cuda.py::test_time_attention_models_on_the_gpu``,
over many videos, on one GPU.

    python3 scripts/torch_time_attention_spread.py [--videos N] [--repeats R]

For each model (``sformer-time``, ``sformer-time-pos_emb``, ``timesformer``,
``timesformer-shift-pos_emb``) and dtype (float32, bfloat16), the test's
model and peaked weights, then ``N`` videos (``torch.rand`` from a CUDA
generator seeded 0..N-1; the test takes seed 0): each forward ``R`` times
with the kernels and ``R`` times with the plain versions.  Prints, per
case, the largest distance over the videos of kernels vs plain (as the
test reads it: max |got - want| over the plain output's max), and whether
the kernel side or the plain side moved between repeats of one video
(max |run i - run 0|), and the share of videos over the test's limit.
For float32 the plain side is the plain attention (``attend_ref``, the
test's limit 1e-4); for bfloat16 it is the plain attention in K9's order
on K9's chunks (``attend_kernel_order``, as the test holds it; its limit
1.5e-2), and beside it the distance from the plain model through
``attend_ref`` (``vs_attend_ref``, which the test held to 3e-2 before).  For the bfloat16 cases it opens the
farthest video: the output element, its two values, their distance in
bfloat16 ulps at that element, and the largest distance between K9's
output and its plain version's on the same inputs over that forward's
calls, in bfloat16 ulps at each element and in ulps of the call's
largest output (elements near 0 count huge ulps at their own
magnitude).  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# the test's limits: float32 against the plain models, bfloat16 against
# the plain models in K9's order
LIMIT = {"float32": 1e-4, "bfloat16": 1.5e-2}


@contextlib.contextmanager
def kernel_order():
    """The plain models' attention in K9's order on K9's chunks."""
    import hiddenpose_tpu_torch.models.sformer as sformer
    from hiddenpose_tpu_torch.ops.kernels.attn import attend_kernel_order

    real = sformer.attend_ref
    sformer.attend_ref = attend_kernel_order
    try:
        yield
    finally:
        sformer.attend_ref = real


def models():
    from hiddenpose_tpu_torch.models.sformer import NlosPoseSformer
    from hiddenpose_tpu_torch.models.timesformer import TimeSformer

    sformer = dict(dim=32, num_frames=3, num_joints=4, image_size=16,
                   patch_size=4, depth=2, heads=2, dim_head=8, out_dim=32)
    timesformer = dict(dim=32, num_frames=3, num_classes=72, image_size=16,
                       patch_size=4, channels=1, depth=2, heads=2, dim_head=8)
    return [
        ("sformer-time", NlosPoseSformer, dict(sformer, use_time_attn=True)),
        ("sformer-time-pos_emb", NlosPoseSformer,
         dict(sformer, use_time_attn=True, rotary_emb=False)),
        ("timesformer", TimeSformer, timesformer),
        ("timesformer-shift-pos_emb", TimeSformer,
         dict(timesformer, shift_tokens=True, rotary_emb=False)),
    ]


def _ulps(a, b):
    """Distance in bfloat16 ulps of each element of ``a`` from ``b`` (both
    rounded to bfloat16; 0 and -0 meet)."""
    def ordered(t):
        i = t.to(torch.bfloat16).view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)

    return (ordered(a) - ordered(b)).abs()


def _ulps_of_scale(a, b):
    """max |a - b| in bfloat16 ulps of max |b|."""
    scale = b.float().abs().max().item()
    return (a.float() - b.float()).abs().max().item() / 2.0 ** (
        math.floor(math.log2(scale)) - 7)


def _open_case(model, video):
    """The kernels-vs-plain distance of one bfloat16 forward, opened."""
    import hiddenpose_tpu_torch.models.sformer as sformer
    from hiddenpose_tpu_torch.ops.kernels.attn import attend_ref

    real, k9 = sformer.attend, []

    def spy(q, k, v):
        out = real(q, k, v)
        want = attend_ref(q, k, v)
        big = want.float().abs() >= want.float().abs().max() / 8
        k9.append((int(_ulps(out, want)[big].max()),
                   _ulps_of_scale(out, want)))
        return out

    with torch.no_grad():
        sformer.attend = spy
        try:
            got = model(video).float()
        finally:
            sformer.attend = real
        model.set_use_kernels(False)
        with kernel_order():
            want = model(video).float()
        model.set_use_kernels(True)
    err = (got - want).abs()
    i = int(err.argmax())
    return dict(element=[int(j) for j in torch.unravel_index(
                    torch.tensor(i), got.shape)],
                got=got.flatten()[i].item(), want=want.flatten()[i].item(),
                scale=want.abs().max().item(),
                ulps_at_element=int(_ulps(got, want).flatten()[i]),
                ulps_of_scale=_ulps_of_scale(got, want), k9_calls=len(k9),
                k9_max_ulps_above_an_eighth_of_its_max=max(u for u, _ in k9),
                k9_max_ulps_of_scale=max(x for _, x in k9))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--videos", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a GPU: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from hiddenpose_tpu_torch.utils.peaked import (
        peaked_transformer_state_dict,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rows = []
    for name, cls, kw in models():
        for dtype in ("float32", "bfloat16"):
            model = cls(**kw, dtype=dtype).eval()
            model.load_state_dict(peaked_transformer_state_dict(model, 1))
            model.to(dev)
            bf16 = dtype == "bfloat16"
            limit = LIMIT[dtype]
            dist, d_ref, k_moved, p_moved, over = [], [], 0.0, 0.0, 0
            for seed in range(args.videos):
                video = torch.rand(
                    (2, 3, 1, 16, 16), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed))
                runs = {}
                with torch.no_grad():
                    for flag in (True, False):
                        model.set_use_kernels(flag)
                        with (kernel_order() if bf16 and not flag
                              else contextlib.nullcontext()):
                            runs[flag] = [model(video).float()
                                          for _ in range(args.repeats)]
                    if bf16:
                        ref = model(video).float()
                model.set_use_kernels(True)
                got, want = runs[True][0], runs[False][0]
                d = ((got - want).abs().max() / want.abs().max()).item()
                dist.append(d)
                if bf16:
                    d_ref.append(((got - ref).abs().max()
                                  / ref.abs().max()).item())
                over += d > limit
                k_moved = max(k_moved, max(
                    (r - got).abs().max().item() for r in runs[True]))
                p_moved = max(p_moved, max(
                    (r - want).abs().max().item() for r in runs[False]))
            row = dict(model=name, dtype=dtype, videos=args.videos,
                       seed0=dist[0], max=max(dist),
                       median=sorted(dist)[len(dist) // 2],
                       over_limit=over, limit=limit,
                       kernel_moved=k_moved, plain_moved=p_moved)
            if bf16:
                row["quantiles"] = [sorted(dist)[int(q * (len(dist) - 1))]
                                    for q in (0.5, 0.9, 0.99, 1.0)]
                row["vs_attend_ref"] = dict(
                    seed0=d_ref[0], max=max(d_ref),
                    median=sorted(d_ref)[len(d_ref) // 2],
                    over_3e_2=sum(x > 3e-2 for x in d_ref))
                worst = max(range(args.videos), key=dist.__getitem__)
                row["farthest"] = dict(seed=worst, **_open_case(
                    model, torch.rand(
                        (2, 3, 1, 16, 16), device=dev,
                        generator=torch.Generator(device=dev)
                        .manual_seed(worst))))
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
