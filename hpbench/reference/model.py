"""NlosPose in plain PyTorch: the benchmark's reference forward.

measurement -> FeatureExtraction -> LCT -> min/max normalise x10 ->
UNet3d -> feature + refine -> PoseNet3D-50 (or visible_net +
ResPoseNet2D) -> heatmaps -> soft-argmax joints, written from HiddenPose's
equations with nothing but ``torch`` and ``torch.nn.functional``: no
kernel, no cache, no batching trick, and nothing of the program under
test.  The LCT's constants are worked out here again from the
configuration (``lct.py``).

The modules carry the parameters under the names of HiddenPose's PyTorch
model, so one state_dict loads into this model and into the program.
Every forward is float32.  ``rounding`` rounds the operands and the result
of every convolution, transposed convolution and matrix product (the
control of a benchmark cell runs the reference so, in a precision below
the one the cell states); the norms, the LCT and the soft-argmax stay
float32.  The caller turns TF32 off (``lct.no_tf32``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hpbench.reference import lct as lct_ops


def identity(x):
    return x


# -- FeatureExtraction ----------------------------------------------------

class ResConv3D(nn.Module):
    """leaky(x + conv(leaky(conv(x)))), edge padding; the convs at
    ``tmp.1`` and ``tmp.4`` as in the reference."""

    def __init__(self, channels: int):
        super().__init__()
        self.tmp = nn.ModuleList([
            nn.ReplicationPad3d(1), nn.Conv3d(channels, channels, 3),
            nn.LeakyReLU(0.2), nn.ReplicationPad3d(1),
            nn.Conv3d(channels, channels, 3)])


class FeatureExtraction(nn.Module):
    """An edge-padded 3^3 conv and two ResConv3D, plus the fixed corner
    conv (zero padding), summed."""

    def __init__(self, basedim: int, in_channels: int):
        super().__init__()
        self.conv1 = nn.ModuleList([
            nn.ReplicationPad3d(1), nn.Conv3d(in_channels, basedim, 3),
            ResConv3D(basedim), ResConv3D(basedim)])
        self.weights = nn.Parameter(torch.zeros(1, in_channels, 3, 3, 3))


def _conv(x, m, q, stride=1, padding=0, bias=True):
    y = q(F.conv3d(q(x), q(m.weight), None, stride, padding))
    if bias and m.bias is not None:
        y = y + m.bias[:, None, None, None]
    return y


def _edge(x):
    return F.pad(x, (1,) * 6, mode="replicate")


def feature_extraction(m: FeatureExtraction, x, q):
    c = m.conv1
    h = _conv(_edge(x), c[1], q)
    for block in (c[2], c[3]):
        t = F.leaky_relu(_conv(_edge(h), block.tmp[1], q), 0.2)
        h = F.leaky_relu(_conv(_edge(t), block.tmp[4], q) + h, 0.2)
    corner = q(F.conv3d(q(x), q(m.weights), None, 1, 1))
    return corner + h


# -- UNet3d ---------------------------------------------------------------

class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        g = min(4, cout)
        self.double_conv = nn.Sequential(
            nn.Conv3d(cin, cout, 3, padding=1), nn.GroupNorm(g, cout),
            nn.ReLU(), nn.Conv3d(cout, cout, 3, padding=1),
            nn.GroupNorm(g, cout), nn.ReLU())


class Encoder(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.encoder = nn.Sequential(nn.MaxPool3d(2), DoubleConv(cin, cout))


class Decoder(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = DoubleConv(cin, cout)


class OutConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, 1)


class UNet3d(nn.Module):
    def __init__(self, in_channels: int, n: int):
        super().__init__()
        self.conv = DoubleConv(in_channels, n)
        self.enc1 = Encoder(n, 2 * n)
        self.enc2 = Encoder(2 * n, 4 * n)
        self.enc3 = Encoder(4 * n, 8 * n)
        self.enc4 = Encoder(8 * n, 8 * n)
        self.dec1 = Decoder(16 * n, 4 * n)
        self.dec2 = Decoder(8 * n, 2 * n)
        self.dec3 = Decoder(4 * n, n)
        self.dec4 = Decoder(2 * n, n)
        self.out = OutConv(n, in_channels)


def double_conv(m: DoubleConv, x, q):
    s = m.double_conv
    for conv, gn in ((s[0], s[1]), (s[3], s[4])):
        y = _conv(x, conv, q, padding=1)
        x = F.relu(F.group_norm(y, gn.num_groups, gn.weight, gn.bias,
                                gn.eps))
    return x


def unet(m: UNet3d, x, q):
    skips = [double_conv(m.conv, x, q)]
    for enc in (m.enc1, m.enc2, m.enc3, m.enc4):
        skips.append(double_conv(enc.encoder[1], F.max_pool3d(skips[-1], 2),
                                 q))
    out = skips.pop()
    for dec in (m.dec1, m.dec2, m.dec3, m.dec4):
        skip = skips.pop()
        lo = F.interpolate(out, scale_factor=2, mode="trilinear",
                           align_corners=True)
        pads = []
        for ax in (4, 3, 2):
            diff = skip.shape[ax] - lo.shape[ax]
            pads += [diff // 2, diff - diff // 2]
        out = double_conv(dec.conv, torch.cat([skip, F.pad(lo, pads)], 1), q)
    return _conv(out, m.out.conv, q)


# -- PoseNet3D-50 ---------------------------------------------------------

def _bn(x, m: nn.modules.batchnorm._BatchNorm, training: bool):
    """BatchNorm; in training on the batch's statistics, which also move
    the running ones as flax's BatchNorm moves them (0.9 old + 0.1 the
    batch's mean and biased variance)."""
    if training:
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, *range(2, x.dim())),
                                       unbiased=False)
            m.running_mean.mul_(0.9).add_(0.1 * mean)
            m.running_var.mul_(0.9).add_(0.1 * var)
        return F.batch_norm(x, None, None, m.weight, m.bias, True, 0.0, m.eps)
    return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias,
                        False, 0.0, m.eps)


class Bottleneck3D(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, project: bool):
        super().__init__()
        out = 4 * planes
        self.stride = stride
        self.conv1 = nn.Conv3d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm3d(planes)
        self.conv2 = nn.Conv3d(planes, planes, 3, bias=False)
        self.bn2 = nn.BatchNorm3d(planes)
        self.conv3 = nn.Conv3d(planes, out, 1, bias=False)
        self.bn3 = nn.BatchNorm3d(out)
        self.downsample = (nn.Sequential(nn.Conv3d(cin, out, 1, bias=False),
                                         nn.BatchNorm3d(out))
                           if project else None)


class DeconvHead3D(nn.Module):
    def __init__(self, cin: int, filters: int, layers: int, joints: int):
        super().__init__()
        mods = []
        for i in range(layers):
            mods += [nn.ConvTranspose3d(cin if i == 0 else filters, filters,
                                        4, bias=False),
                     nn.BatchNorm3d(filters), nn.ReLU()]
        mods.append(nn.Conv3d(filters, joints, 1))
        self.features = nn.Sequential(*mods)


class PoseNet3D(nn.Module):
    def __init__(self, arch: dict, joints: int, in_channels: int):
        super().__init__()
        widths, layers = arch["widths"], arch["layers"]
        k = arch["stem_kernel"]
        self.conv1 = nn.Conv3d(in_channels, widths[0], k, bias=False)
        self.bn1 = nn.BatchNorm3d(widths[0])
        cin = widths[0]
        for s, (planes, blocks) in enumerate(zip(widths, layers)):
            seq = []
            for b in range(blocks):
                stride = 2 if s > 0 and b == 0 else 1
                seq.append(Bottleneck3D(cin, planes, stride,
                                        b == 0 and (stride != 1
                                                    or cin != 4 * planes)))
                cin = 4 * planes
            setattr(self, f"layer{s + 1}", nn.Sequential(*seq))
        self.head = DeconvHead3D(cin, arch["head_filters"],
                                 arch["head_layers"], joints)


def posenet3d(m: PoseNet3D, x, q, training: bool):
    k = m.conv1.kernel_size[0]
    x = F.relu(_bn(_conv(x, m.conv1, q, padding=k // 2), m.bn1, training))
    x = F.max_pool3d(x, 3, 2, 1)
    for layer in (m.layer1, m.layer2, m.layer3, m.layer4):
        for blk in layer:
            out = F.relu(_bn(_conv(x, blk.conv1, q), blk.bn1, training))
            out = F.relu(_bn(_conv(out, blk.conv2, q, blk.stride, 1),
                             blk.bn2, training))
            out = _bn(_conv(out, blk.conv3, q), blk.bn3, training)
            res = x
            if blk.downsample is not None:
                res = _bn(_conv(x, blk.downsample[0], q, blk.stride),
                          blk.downsample[1], training)
            x = F.relu(out + res)
    f = m.head.features
    for i in range(0, len(f) - 1, 3):
        y = q(F.conv_transpose3d(q(x), q(f[i].weight), None, 2, 1))
        x = F.relu(_bn(y, f[i + 1], training))
    return _conv(x, f[-1], q)


# -- the posenet2d backbone -----------------------------------------------

def same_pads(n: int, k: int, s: int):
    """(low, high) of flax's SAME padding: ceil(n / s) outputs, the odd
    pixel after."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Bottleneck2D(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, project: bool):
        super().__init__()
        out = 4 * planes
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        if project:
            self.conv_proj = nn.Conv2d(cin, out, 1, bias=False)
            self.bn_proj = nn.BatchNorm2d(out)
        self.project = project


class Backbone2D(nn.Module):
    def __init__(self, cin: int, layers):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, 64, 7, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.names = []
        c = 64
        for s, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                 layers)):
            for b in range(blocks):
                stride = 2 if s > 0 and b == 0 else 1
                name = f"layer{s + 1}_{b}"
                setattr(self, name, Bottleneck2D(
                    c, planes, stride,
                    b == 0 and (stride != 1 or c != 4 * planes)))
                self.names.append(name)
                c = 4 * planes
        self.out_channels = c


class Head2D(nn.Module):
    def __init__(self, cin: int, filters: int, layers: int, out: int):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            setattr(self, f"deconv{i + 1}", nn.ConvTranspose2d(
                cin if i == 0 else filters, filters, 4, bias=False))
            setattr(self, f"bn{i + 1}", nn.BatchNorm2d(filters))
        self.final = nn.Conv2d(filters, out, 1)


class PoseNet2D(nn.Module):
    def __init__(self, arch: dict, joints: int, depth: int,
                 in_channels: int):
        super().__init__()
        self.backbone = Backbone2D(8 * in_channels, arch["layers"])
        self.head = Head2D(self.backbone.out_channels, arch["head_filters"],
                           arch["head_layers"], joints * depth)


def _conv2d_same(x, m, q, stride=1):
    k = m.kernel_size[0]
    ph, pw = same_pads(x.shape[2], k, stride), same_pads(x.shape[3], k,
                                                         stride)
    x = F.pad(x, (*pw, *ph))
    return q(F.conv2d(q(x), q(m.weight), None, stride))


def top_k_first(x, k: int):
    """The k largest values along the last axis, the lower index first
    among equal values, and their indices."""
    vals, idxs = [], []
    for _ in range(k):
        i = x.argmax(dim=-1, keepdim=True)
        vals.append(x.gather(-1, i))
        idxs.append(i)
        x = x.scatter(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idxs, -1)


def visible_net(x, k: int = 4):
    """ReLU, min/max per (sample, channel), x1e5, the top k along depth,
    then (values, flipped depth index / (D - 1)) as 2D channels."""
    b, c, depth, h, w = x.shape
    x = normalize(F.relu(x)) * 1.0e5
    vals, idx = top_k_first(x.movedim(2, -1), k)
    table = ((depth - 1 - torch.arange(depth, dtype=torch.float32))
             / (depth - 1)).to(x.device)
    dep = table[idx]
    vals = vals.movedim(-1, 2).reshape(b, c * k, h, w)
    dep = dep.movedim(-1, 2).reshape(b, c * k, h, w)
    return torch.cat([vals, dep], 1)


def posenet2d(m: PoseNet2D, x, q, training: bool):
    bb = m.backbone
    x = F.relu(_bn(_conv2d_same(x, bb.conv1, q, 2), bb.bn1, training))
    x = F.max_pool2d(x, 3, 2, 1)
    for name in bb.names:
        blk = getattr(bb, name)
        out = F.relu(_bn(_conv2d_same(x, blk.conv1, q), blk.bn1, training))
        out = F.relu(_bn(_conv2d_same(out, blk.conv2, q, blk.stride),
                         blk.bn2, training))
        out = _bn(_conv2d_same(out, blk.conv3, q), blk.bn3, training)
        res = (_bn(_conv2d_same(x, blk.conv_proj, q, blk.stride),
                   blk.bn_proj, training) if blk.project else x)
        x = F.relu(out + res)
    hd = m.head
    for i in range(1, hd.layers + 1):
        y = q(F.conv_transpose2d(q(x), q(getattr(hd, f"deconv{i}").weight),
                                 None, 2, 1))
        x = F.relu(_bn(y, getattr(hd, f"bn{i}"), training))
    y = q(F.conv2d(q(x), q(hd.final.weight)))
    return y + hd.final.bias[:, None, None]


# -- the whole model ------------------------------------------------------

def normalize(x):
    """Min/max to [0, 1] per (sample, channel)."""
    b, c = x.shape[:2]
    flat = x.reshape(b, c, -1)
    lo = flat.amin(2, keepdim=True)
    hi = flat.amax(2, keepdim=True)
    return ((flat - lo) / (hi - lo + 1e-15)).reshape(x.shape)


def soft_argmax(heatmaps):
    """(B, J, Z, Y, X) logits -> (B, J*3): the expected (x, y, z) voxel of
    each joint's softmax, from its three marginals."""
    b, j, zd, yd, xd = heatmaps.shape
    p = torch.softmax(heatmaps.reshape(b, j, -1), 2).reshape(
        b, j, zd, yd, xd)

    def expect(marg, n):
        return (marg * torch.arange(n, dtype=marg.dtype,
                                    device=marg.device)).sum(2)

    xyz = [expect(p.sum((2, 3)), xd), expect(p.sum((2, 4)), yd),
           expect(p.sum((3, 4)), zd)]
    return torch.stack(xyz, 2).reshape(b, j * 3)


class NlosPose(nn.Module):
    """The parameters of HiddenPose's model, under its names; the forward
    is :func:`forward`."""

    def __init__(self, cfg: dict):
        super().__init__()
        model, arch = cfg["model"], cfg["architecture"]
        cin = model["in_channels"]
        self.cfg = cfg
        self.feature_extraction = FeatureExtraction(model["basedim"], cin)
        self.autoencoder = UNet3d(cin, arch["unet_width"])
        if model["backbone"] == "posenet3d_50":
            self.pose_net = PoseNet3D(arch["posenet3d"], model["num_joints"],
                                      cin)
        elif model["backbone"] == "posenet2d":
            self.pose_net = PoseNet2D(arch["posenet2d"], model["num_joints"],
                                      model["heatmap_size"][0], cin)
        else:
            raise ValueError(f"backbone {model['backbone']!r}")


def forward(m: NlosPose, meas, lct: "lct_ops.LCT", q=identity,
            training: bool = False):
    """meas (B, C, T, H, W) -> (heatmaps (B, J, Z, Y, X), refine (B, C, T,
    H, W)); BatchNorm on running statistics, or on the batch's where
    ``training``."""
    model = m.cfg["model"]
    x = feature_extraction(m.feature_extraction, meas, q)
    b, ch = x.shape[:2]
    vol = lct(x.reshape(b * ch, *x.shape[2:])).reshape(x.shape)
    feature = normalize(vol) * 10.0
    refine = unet(m.autoencoder, feature, q)
    if model["backbone"] == "posenet2d":
        hm = posenet2d(m.pose_net, visible_net(feature + refine), q,
                       training)
        heatmaps = hm.reshape(b, model["num_joints"],
                              model["heatmap_size"][0], *hm.shape[2:])
    else:
        heatmaps = posenet3d(m.pose_net, feature + refine, q, training)
    return heatmaps, refine

