"""NlosPoseSformer: the TimeSformer-style joint-token pose transformer.

Port of ``hiddenpose_tpu/models/sformer.py``:

* video (b, f, c, h, w) -> p x p patches per frame, linear projection;
* 24 learnable joint tokens prepended;
* per layer: (optional, off by default) divided time attention, spatial
  attention, GEGLU feed-forward, each pre-LayerNormed with a residual;
* joint tokens attend over ALL tokens; patch tokens attend within their
  frame (space) or across frames at one position (time) over
  [joint tokens | group patches], with rotary embeddings on the patch q/k;
* head: LayerNorm + Linear(dim -> out_dim) on the joint tokens, reshaped to
  (b, joints, 4, out_dim // 4): SimDR logits, decoded by
  ``ops/softargmax.py::simdr_decode``.

The grouped patch attention and the joint-token read (24 queries over all
f*n keys) both run in the hand-written kernel (``ops/kernels/attn.py``,
K9), which splits the keys of the second across blocks.

Numerics follow flax where it differs from PyTorch's defaults: LayerNorm
eps 1e-6, the tanh approximation of GELU.  ``dtype`` is the activation type
of the Linear layers only, as flax's ``Dense(dtype=...)``: parameters are
float32 and cast at use, LayerNorm returns float32, and the residual stream
is float32 (the float32 joint tokens promote it).  In the bfloat16 mode the
float32 rotary tables promote the patch q and k, so K9 sees float32 q/k
with a bfloat16 v there.

State_dict names are the flax tree's, joined by dots (``spatial_attn_0.
to_qkv.weight``), with ``ff_i.proj_in`` / ``proj_out`` for flax's ``in`` /
``out``; ``utils/jax_bridge.py`` carries weights both ways.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hiddenpose_tpu_torch import as_dtype, resolve_device
from hiddenpose_tpu_torch.models.rotary import (
    apply_rotary,
    rotary_1d,
    rotary_axial,
)
from hiddenpose_tpu_torch.ops.kernels.attn import (
    attend,
    attend_diff,
    attend_ref,
    attend_routed,
)
from hiddenpose_tpu_torch.ops.softargmax import simdr_decode

LN_EPS = 1e-6  # flax's LayerNorm default; torch's is 1e-5


class Dense(nn.Linear):
    """flax's ``Dense(dtype=...)``: float32 parameters, with the input, the
    weight and the bias cast to ``dtype`` at use; the output is ``dtype``."""

    def __init__(self, in_features, out_features, bias=True,
                 dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        return F.linear(x.to(d), self.weight.to(d), bias)


def _cat(tensors, dim):
    """``jnp.concatenate``: the result has the promoted dtype."""
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.cat([t.to(dtype) for t in tensors], dim=dim)


class JointTokenAttention(nn.Module):
    """Divided space/time attention with global summary tokens.

    ``num_summary`` tokens (24 joint tokens, or the TimeSformer's 1 cls
    token) attend over everything; patch tokens attend within their frame
    (``over='space'``) or across frames at a fixed position
    (``over='time'``), always also seeing the summary tokens as keys and
    values."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 32,
                 num_summary: int = 24, dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.num_summary = num_summary
        inner = heads * dim_head
        self.to_qkv = Dense(dim, inner * 3, bias=False, dtype=dtype)
        self.to_out = Dense(inner, dim, dtype=dtype)
        self.use_kernels = True

    def _attend(self, q, k, v):
        """Softmax attention over (groups, n, dh).  Shapes the router takes
        (``attend_routed``: the grouped patch attention and the joint-token
        read alike) go to K9: the raw wrapper in a serving forward, its
        ``autograd.Function`` where a gradient is wanted.  A shape the
        kernel does not take (a head dim that is no multiple of 4) and
        ``use_kernels=False`` run the plain version."""
        if self.use_kernels and attend_routed(q.shape, k.shape):
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            if torch.is_grad_enabled() and (
                    q.requires_grad or k.requires_grad or v.requires_grad):
                return attend_diff(q, k, v)
            return attend(q, k, v)
        return attend_ref(q, k, v)

    def forward(self, x, f: int, n: int, over: str = "space", rot=None):
        """x: (b, num_summary + f*n, dim); tokens ordered (frame, position)."""
        h, dh, j = self.heads, self.dim_head, self.num_summary
        b = x.shape[0]
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)

        def split_heads(t):  # (b, n, h*dh) -> (b*h, n, dh)
            nn_ = t.shape[1]
            return t.reshape(b, nn_, h, dh).permute(0, 2, 1, 3).reshape(
                b * h, nn_, dh)

        q, k, v = map(split_heads, (q, k, v))
        q = q * (dh ** -0.5)

        jq, pq = q[:, :j], q[:, j:]
        jk, pk = k[:, :j], k[:, j:]
        jv, pv = v[:, :j], v[:, j:]

        # Summary tokens read everything (global context).
        joints_out = self._attend(jq, k, v)

        # Patch tokens attend within their group.
        bh = pq.shape[0]
        if over == "space":
            g, ng = n, f  # groups = frames, each of n positions

            def regroup(t):
                return t.reshape(bh * ng, g, dh)

            def ungroup(t):
                return t.reshape(bh, f * n, dh)
        elif over == "time":  # a group = one position across the f frames
            g, ng = f, n

            def regroup(t):
                return t.reshape(bh, f, n, dh).transpose(1, 2).reshape(
                    bh * n, f, dh)

            def ungroup(t):
                return t.reshape(bh, n, f, dh).transpose(1, 2).reshape(
                    bh, f * n, dh)
        else:
            raise ValueError(f"over must be 'space' or 'time', got {over!r}")

        pq, pk, pv = map(regroup, (pq, pk, pv))
        if rot is not None:
            pq, pk = apply_rotary(pq, pk, rot)

        # Every group also sees the summary tokens as k/v: group index is
        # bh_index * ng + i, so each head's tokens repeat ng times in place.
        jk_r = jk.repeat_interleave(ng, dim=0)
        jv_r = jv.repeat_interleave(ng, dim=0)
        pk = _cat([jk_r, pk], dim=1)
        pv = _cat([jv_r, pv], dim=1)
        patches_out = ungroup(self._attend(pq, pk, pv))

        out = _cat([joints_out, patches_out], dim=1)
        out = out.reshape(b, h, -1, dh).permute(0, 2, 1, 3).reshape(
            b, -1, h * dh)
        return self.to_out(out)


class GEGLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32):
        super().__init__()
        self.proj_in = Dense(dim, dim * mult * 2, dtype=dtype)
        self.proj_out = Dense(dim * mult, dim, dtype=dtype)

    def forward(self, x):
        a, gates = self.proj_in(x).chunk(2, dim=-1)
        # jax.nn.gelu defaults to the tanh approximation
        return self.proj_out(a * F.gelu(gates, approximate="tanh"))


def patchify(video: torch.Tensor, p: int) -> torch.Tensor:
    """(b, f, c, h, w) -> (b, f*hp*wp, p*p*c), tokens ordered (frame, row,
    column), features (patch row, patch column, channel)."""
    b, f, c, h, w = video.shape
    if h % p or w % p:
        raise ValueError(f"image {h}x{w} is not a multiple of patch {p}")
    hp, wp = h // p, w // p
    x = video.reshape(b, f, c, hp, p, wp, p)
    return x.permute(0, 1, 3, 5, 4, 6, 2).reshape(b, f * hp * wp, p * p * c)


class _Transformer(nn.Module):
    """What NlosPoseSformer and TimeSformer share: the patch embedding,
    the per-layer modules under flax's names, and the kernel switch."""

    def _build_layers(self, dim, depth, heads, dim_head, num_summary,
                      time_attn, dtype):
        for i in range(depth):
            if time_attn:
                setattr(self, f"time_ln_{i}", nn.LayerNorm(dim, eps=LN_EPS))
                setattr(self, f"time_attn_{i}", JointTokenAttention(
                    dim, heads, dim_head, num_summary, dtype=dtype))
            setattr(self, f"spatial_ln_{i}", nn.LayerNorm(dim, eps=LN_EPS))
            setattr(self, f"spatial_attn_{i}", JointTokenAttention(
                dim, heads, dim_head, num_summary, dtype=dtype))
            setattr(self, f"ff_ln_{i}", nn.LayerNorm(dim, eps=LN_EPS))
            setattr(self, f"ff_{i}", GEGLUFeedForward(dim, dtype=dtype))

    def set_use_kernels(self, flag: bool) -> None:
        """Route the grouped attention to its CUDA kernel (True, the
        default) or to its plain PyTorch version (False: a reference for
        the kernel on the GPU; the serving path never sets it)."""
        for m in self.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = bool(flag)

    def _tables(self, f, hp, wp, device):
        if not self.rotary_emb:
            return None, None
        return (rotary_1d(f, self.dim_head, device=device),
                rotary_axial(hp, wp, self.dim_head, device=device))


class NlosPoseSformer(_Transformer):
    def __init__(self, dim: int = 256, num_frames: int = 16,
                 num_joints: int = 24, image_size: int = 128,
                 patch_size: int = 4, channels: int = 1, depth: int = 8,
                 heads: int = 8, dim_head: int = 32, rotary_emb: bool = True,
                 out_dim: int = (64 * 2 + 128) * 2,
                 use_time_attn: bool = False, dtype=torch.float32):
        super().__init__()
        dtype = as_dtype(dtype)
        self.dim, self.num_frames = dim, num_frames
        self.num_joints = num_joints
        self.image_size, self.patch_size, self.channels = (
            image_size, patch_size, channels)
        self.depth, self.heads, self.dim_head = depth, heads, dim_head
        self.rotary_emb, self.out_dim = rotary_emb, out_dim
        self.use_time_attn = use_time_attn
        self.compute_dtype = dtype

        self.patch_embed = Dense(patch_size * patch_size * channels, dim,
                                 dtype=dtype)
        self.joints_token = nn.Parameter(torch.zeros(1, num_joints, dim))
        if not rotary_emb:
            n = (image_size // patch_size) ** 2
            self.pos_emb = nn.Parameter(
                torch.zeros(1, num_joints + num_frames * n, dim))
        self._build_layers(dim, depth, heads, dim_head, num_joints,
                           use_time_attn, dtype)
        self.out_ln = nn.LayerNorm(dim, eps=LN_EPS)
        self.out_proj = Dense(dim, out_dim, dtype=dtype)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        """video: (b, f, c, h, w) -> (b, num_joints, 4, out_dim // 4)."""
        b, f, c, h, w = video.shape
        p = self.patch_size
        hp, wp = h // p, w // p
        n = hp * wp

        tokens = self.patch_embed(patchify(video, p))
        x = _cat([self.joints_token.expand(b, -1, -1), tokens], dim=1)

        frame_rot, image_rot = self._tables(f, hp, wp, video.device)
        if not self.rotary_emb:
            x = x + self.pos_emb

        for i in range(self.depth):
            if self.use_time_attn:
                x = x + getattr(self, f"time_attn_{i}")(
                    getattr(self, f"time_ln_{i}")(x),
                    f=f, n=n, over="time", rot=frame_rot)
            x = x + getattr(self, f"spatial_attn_{i}")(
                getattr(self, f"spatial_ln_{i}")(x),
                f=f, n=n, over="space", rot=image_rot)
            x = x + getattr(self, f"ff_{i}")(getattr(self, f"ff_ln_{i}")(x))

        out = self.out_proj(self.out_ln(x[:, :self.num_joints]))
        return out.reshape(b, self.num_joints, 4, self.out_dim // 4)


def sformer_from_config(cfg, dtype=None) -> NlosPoseSformer:
    """Build from a ``ModelConfig``'s transformer fields; ``dtype``
    overrides ``cfg.compute_dtype``."""
    return NlosPoseSformer(
        dim=cfg.patch_feature_dim,
        num_frames=cfg.num_frames,
        num_joints=cfg.num_joints,
        image_size=cfg.image_size[0],
        patch_size=cfg.patch_size,
        channels=cfg.in_channels,
        depth=cfg.depth,
        heads=cfg.heads,
        dim_head=cfg.dim_head,
        rotary_emb=cfg.rotary_emb,
        out_dim=cfg.out_dim,
        dtype=as_dtype(dtype if dtype is not None else cfg.compute_dtype),
    )


@torch.no_grad()
def init_transformer_weights(model: nn.Module,
                             generator: torch.Generator) -> None:
    """Random weights from an explicit generator, with flax's
    initialisers: lecun-normal Linear weights with zero bias, unit/zero
    LayerNorms, truncated-normal(0.02) joint tokens (TokenPose's keypoint
    tokens and learnable position table too), normal(0.02) position
    embedding, normal(1) cls token."""

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for m in model.modules():
        if isinstance(m, nn.Linear):
            normal_(m.weight, m.in_features ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for name, p in model.named_parameters(recurse=False):
        if name in ("joints_token", "keypoint_token", "pos_embedding"):
            normal_(p, 0.02)
            p.clamp_(-0.04, 0.04)
        elif name == "pos_emb":
            normal_(p, 0.02)
        elif name == "cls_token":
            normal_(p, 1.0)


def finish_build(model: nn.Module, device, seed: int) -> nn.Module:
    """Shared tail of ``build_sformer`` and ``build_timesformer``: resolve
    the device (the GPU unless asked otherwise; raises without one), turn
    TF32 off for a GPU (the float32 path is full float32; the flags are
    process-wide, set once here and never toggled around a forward), seeded
    weights, eval mode."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    init_transformer_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def build_sformer(cfg, device="cuda", seed: int = 0,
                  dtype: Optional[str] = None) -> NlosPoseSformer:
    """The eval-mode Sformer of ``cfg`` on ``device`` (the GPU by default;
    raises without one unless ``device="cpu"``) with random weights from
    ``seed``.  ``dtype`` ('float32' or 'bfloat16') overrides
    ``cfg.compute_dtype``."""
    return finish_build(sformer_from_config(cfg, dtype), device, seed)


@torch.inference_mode()
def serve_video(model: NlosPoseSformer, video: torch.Tensor):
    """One serving forward: video (b, f, c, h, w) on the model's device ->
    (joints (b, J, 3) float32 in image units, logits (b, J, 4, K))."""
    out = model(video)
    return simdr_decode(out[:, :, :3, :]), out
