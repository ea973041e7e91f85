"""The alternative visual backbones of the RMI matching model: FCN-8s,
SegNet and DeepLab-v3+ (``sketchyscenecolorization_tpu/models/backbones.py``;
reference ``Instance_Matching/fcn8s_model.py``, ``segnet_model.py``,
``deeplab_v3plus_model.py``), selected by ``MatchingConfig.backbone``; the
default DeepLab-v2 is ``models/deeplab.py``.

Each is a module named after its JAX scope (``SCOPE``) whose submodules and
leaves carry the keys of the JAX package's nested parameter dict, so
``utils/bridge.py`` maps the trees 1:1.  Conv kernels are OIHW; two kinds
of leaf keep another layout, named by their owner's ``FROM_HWIO``: FCN-8s'
transposed-conv kernels ``[in, out, kh, kw]`` and DeepLab-v3+'s depthwise
kernels ``[C, 1, 3, 3]`` (JAX keeps those as ``(3, 3, C, 1)`` and applies
them as ``moveaxis(w, 2, 3).reshape(3, 3, 1, C)``).

``forward(images, intermediate=True)`` returns the feature map RMI
consumes, at output stride 8: FCN-8s' ``fuse_2`` [N, H/8, W/8, 256],
SegNet's ``dec_4`` after its second conv [N, H/8, W/8, 512], DeepLab-v3+'s
pre-ASPP backbone output [N, H/8, W/8, 2048].  ``intermediate=False`` runs
the segmentation head to [N, H, W, num_classes].

Under the bf16 compute-dtype scope (``ops/conv.py``) each conv that JAX
runs through ``conv2d``/``conv2d_transpose`` stores bf16, and the f32 bias
or batch norm after it brings the stream back to f32, as in JAX.
DeepLab-v3+'s stride-2 3x3 convs (slim's ``conv2d_same``) and its
depthwise convs do not read the scope and stay f32 (JAX
``backbones.py:271-296``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import conv2d, conv2d_transpose, max_pool_3x3_s2
from ..ops.image import resize_bilinear_align_corners
from .gan_layers import truncated_normal
from .rmi import Leaves


def he_conv(k: int, cin: int, cout: int, generator=None) -> torch.Tensor:
    """N(0, 2 / (k k cout)) [cout, cin, k, k] (JAX ``backbones.py:34-36``)."""
    return (torch.randn(cout, cin, k, k, generator=generator)
            * math.sqrt(2.0 / (k * k * cout)))


class TransposedLeaves(Leaves):
    """Leaves whose 4-D ``DW`` is a transposed-conv kernel [in, out, k, k]."""
    FROM_HWIO = (2, 3, 0, 1)


class DepthwiseLeaves(Leaves):
    """Leaves whose 4-D ``DW`` is a depthwise kernel [C, 1, 3, 3]."""
    FROM_HWIO = (2, 3, 0, 1)


def _pool_2x2(x: torch.Tensor, mode: str) -> torch.Tensor:
    """2x2/2 SAME pooling, NHWC: an odd size is padded at the bottom/right
    with the reduction's identity (0 for the average, which still divides
    by 4, as JAX's ``reduce_window`` sum / 4 does; -inf for the max)."""
    n, h, w, c = x.shape
    ph, pw = h % 2, w % 2
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph),
                  value=0.0 if mode == "avg" else float("-inf"))
    x = x.reshape(n, (h + ph) // 2, 2, (w + pw) // 2, 2, c)
    return x.sum(dim=(2, 4)) / 4.0 if mode == "avg" else x.amax(dim=(2, 4))


# ====================================================================== FCN-8s

VGG_LAYERS = (
    ("conv1_1", 3, 64), ("conv1_2", 64, 64), ("pool1",),
    ("conv2_1", 64, 128), ("conv2_2", 128, 128), ("pool2",),
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256),
    ("conv3_4", 256, 256), ("pool3",),
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512),
    ("conv4_4", 512, 512), ("pool4",),
    ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512),
    ("conv5_4", 512, 512),
)


class FCN8s(nn.Module):
    """FCN-8s (JAX ``backbones.py:63-125``): VGG-19 with average pools;
    pool5 max-pools conv5_3 (conv5_4 has parameters but feeds nothing, so
    it is not run); fc6 7x7x512x4096, fc7, fc8 to the classes; two 4x4/2
    transposed convs fused with pool4 and pool3 (``fuse_2``, the
    intermediate exit); the full head a 16x16/8 transposed conv."""
    SCOPE = "FCN_8s"

    def __init__(self, num_classes: int = 47,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        for spec in VGG_LAYERS:
            if spec[0].startswith("conv"):
                name, cin, cout = spec
                self.add_module(name, Leaves(DW=he_conv(3, cin, cout, g),
                                             bias=torch.zeros(cout)))
        for name, k, cin, cout in (("fc6", 7, 512, 4096),
                                   ("fc7", 1, 4096, 4096),
                                   ("fc8", 1, 4096, num_classes)):
            self.add_module(name, Leaves(DW=he_conv(k, cin, cout, g),
                                         bias=torch.zeros(cout)))
        for name, k, cin, cout in (("deconv1", 4, num_classes, 512),
                                   ("deconv2", 4, 512, 256),
                                   ("deconv3", 16, 256, num_classes)):
            # HWIO init of JAX, n = k k out, stored [in, out, k, k]
            self.add_module(name, TransposedLeaves(
                DW=he_conv(k, cin, cout, g).transpose(0, 1).contiguous(),
                bias=torch.zeros(cout)))

    @staticmethod
    def _conv(x, leaves, relu=True):
        y = conv2d(x, leaves.DW) + leaves.bias
        return torch.relu(y) if relu else y

    @staticmethod
    def _deconv(x, leaves, stride):
        return conv2d_transpose(x, leaves.DW, stride=stride) + leaves.bias

    def forward(self, images: torch.Tensor, intermediate: bool = True):
        net = {}
        x = images
        for spec in VGG_LAYERS[:-1]:
            name = spec[0]
            x = (self._conv(x, getattr(self, name)) if name.startswith("conv")
                 else _pool_2x2(x, "avg"))
            net[name] = x
        x = self._conv(_pool_2x2(net["conv5_3"], "max"), self.fc6)
        x = self._conv(x, self.fc7)
        x = self._conv(x, self.fc8, relu=False)
        fuse_1 = self._deconv(x, self.deconv1, 2) + net["pool4"]
        fuse_2 = self._deconv(fuse_1, self.deconv2, 2) + net["pool3"]
        if intermediate:
            return fuse_2                       # [N, H/8, W/8, 256]
        return self._deconv(fuse_2, self.deconv3, 8)


# ====================================================================== SegNet

SEGNET_ENC = (("enc_1", (64, 64)), ("enc_2", (128, 128)),
              ("enc_3", (256, 256, 256)), ("enc_4", (512, 512, 512)),
              ("enc_5", (512, 512, 512)))
# dec_4's third conv (512 -> 256) is commented out in the reference
# (``segnet_model.py:99``); JAX restores it so that the full head runs
SEGNET_DEC_FULL = (("dec_5", (512, 512, 512)), ("dec_4", (512, 512, 256)),
                   ("dec_3", (256, 256, 128)), ("dec_2", (128, 64)))


def max_pool_argmax_2x2(x: torch.Tensor):
    """2x2/2 max pooling with TF's flat argmax indices (JAX
    ``backbones.py:151-170``): each window's first maximum in (dy, dx)
    row-major order, as ``jnp.argmax`` takes it (``torch.argmax`` also
    returns the first maximal index), at the flat NHWC index
    ``(row W + col) C + c`` of its batch row.  ``F.max_pool2d(...,
    return_indices=True)`` indexes per plane and may break ties
    differently.  Even sizes only."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"max_pool_argmax_2x2 takes even sizes, got {h}x{w}")
    xr = x.reshape(n, h // 2, 2, w // 2, 2, c).transpose(2, 3) \
        .reshape(n, h // 2, w // 2, 4, c)
    vals, amax = xr.amax(dim=3), torch.argmax(xr, dim=3)
    dev = x.device
    rows = torch.arange(h // 2, device=dev)[None, :, None, None] * 2 + amax // 2
    cols = torch.arange(w // 2, device=dev)[None, None, :, None] * 2 + amax % 2
    chan = torch.arange(c, device=dev)[None, None, None, :]
    return vals, (rows * w + cols) * c + chan


def unpool_2x2(vals: torch.Tensor, indices: torch.Tensor, out_h: int,
               out_w: int) -> torch.Tensor:
    """Scatter the pooled values back to their argmax positions, zeros
    elsewhere (JAX ``backbones.py:173-180``)."""
    n, _, _, c = vals.shape
    flat = vals.new_zeros((n, out_h * out_w * c))
    flat.scatter_(1, indices.reshape(n, -1), vals.reshape(n, -1))
    return flat.reshape(n, out_h, out_w, c)


class SegNet(nn.Module):
    """SegNet (JAX ``backbones.py:183-238``): conv + contrib BN (batch
    statistics always, beta only, eps 1e-3, biased variance) + ReLU,
    argmax pooling in the encoder and scatter unpooling in the decoder.
    The statistics are those of the batch the backbone runs on: the
    matching engine runs it on one image."""
    SCOPE = "SegNet"

    def __init__(self, num_classes: int = 47,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cin = 3
        for name, chans in (*SEGNET_ENC, *SEGNET_DEC_FULL,
                            ("dec_1", (64, num_classes))):
            block = nn.Module()
            for i, cout in enumerate(chans):
                block.add_module(f"conv{i + 1}", Leaves(
                    DW=he_conv(3, cin, cout, generator),
                    biases=torch.zeros(cout), bn_beta=torch.zeros(cout)))
                cin = cout
            self.add_module(name, block)

    @staticmethod
    def _conv_bn_relu(x, leaves):
        y = conv2d(x, leaves.DW) + leaves.biases
        var, mean = torch.var_mean(y, dim=(0, 1, 2), correction=0)
        return torch.relu((y - mean) / torch.sqrt(var + 1e-3)
                          + leaves.bn_beta)

    def forward(self, images: torch.Tensor, intermediate: bool = True):
        x = images
        inds, sizes = [], []
        for name, chans in SEGNET_ENC:
            for i in range(len(chans)):
                x = self._conv_bn_relu(x, getattr(getattr(self, name),
                                                  f"conv{i + 1}"))
            sizes.append(x.shape[1:3])
            x, ind = max_pool_argmax_2x2(x)
            inds.append(ind)
        for d, (name, _) in enumerate((*SEGNET_DEC_FULL, ("dec_1", ()))):
            level = len(SEGNET_ENC) - 1 - d
            x = unpool_2x2(x, inds[level], *sizes[level])
            block = getattr(self, name)
            for i in range(len(list(block.children()))):
                if name == "dec_4" and i == 2 and intermediate:
                    return x                    # [N, H/8, W/8, 512]
                x = self._conv_bn_relu(x, getattr(block, f"conv{i + 1}"))
        return x                                # [N, H, W, num_classes]


# ================================================================ DeepLab-v3+

V3P_BLOCKS = ((3, 256), (4, 512), (23, 1024), (3, 2048))
V3P_MULTI_GRID = (1, 2, 4)
V3P_ASPP_RATES = (6, 12, 18)
V3P_DEPTH = 256


class FrozenBN(Leaves):
    """Inference BN with stored statistics, eps 1e-5 (JAX
    ``backbones.py:249-252``)."""

    def __init__(self, c: int):
        super().__init__(beta=torch.zeros(c), mean=torch.zeros(c),
                         variance=torch.ones(c), gamma=torch.ones(c))

    def forward(self, x):
        return ((x - self.mean) / torch.sqrt(self.variance + 1e-5)
                * self.gamma + self.beta)


class ConvBN(nn.Module):
    """``{"DW", "bn"}``: a bias-free conv and its frozen BN."""

    def __init__(self, k, cin, cout, generator=None):
        super().__init__()
        self.DW = nn.Parameter(he_conv(k, cin, cout, generator))
        self.bn = FrozenBN(cout)


class SepConv(nn.Module):
    """Depthwise 3x3 (truncated normal x 0.33) + BN + ReLU, then pointwise
    1x1 (x 0.06) + BN + ReLU (JAX ``backbones.py:259-268,299-303``)."""

    def __init__(self, cin, cout, generator=None):
        super().__init__()
        self.depthwise = DepthwiseLeaves(
            DW=truncated_normal((cin, 1, 3, 3), generator) * 0.33)
        self.depthwise.bn = FrozenBN(cin)
        self.pointwise = Leaves(
            DW=truncated_normal((cout, cin, 1, 1), generator) * 0.06)
        self.pointwise.bn = FrozenBN(cout)

    def forward(self, x, rate: int = 1):
        # the depthwise conv does not read the scope (JAX :286-296)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.depthwise.DW,
                     padding=rate, dilation=rate, groups=x.shape[-1])
        y = torch.relu(self.depthwise.bn(y.permute(0, 2, 3, 1)))
        y = conv2d(y, self.pointwise.DW)
        return torch.relu(self.pointwise.bn(y))


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int):
    """slim ``conv2d_same`` (JAX ``backbones.py:271-283``): a symmetric pad
    of (k - 1) / 2, then VALID, so the centres sit at 0, 2, 4, ... in line
    with the strided shortcut; TF's SAME would pad (0, 1).  It does not
    read the compute-dtype scope."""
    pad = (w.shape[2] - 1) // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


class V3PlusUnit(nn.Module):
    """slim's bottleneck unit v1 (JAX ``backbones.py:350-368``)."""

    def __init__(self, cin, cout, generator=None):
        super().__init__()
        mid = cout // 4
        self.conv1 = ConvBN(1, cin, mid, generator)
        self.conv2 = ConvBN(3, mid, mid, generator)
        self.conv3 = ConvBN(1, mid, cout, generator)
        if cin != cout:
            self.shortcut = ConvBN(1, cin, cout, generator)

    @staticmethod
    def _cbr(y, q, rate=1, stride=1, relu=True):
        if stride > 1 and q.DW.shape[2] > 1:
            y = conv2d_same(y, q.DW, stride)
        else:
            y = conv2d(y, q.DW, stride=stride, rate=rate)
        y = q.bn(y)
        return torch.relu(y) if relu else y

    def forward(self, x, stride: int, rate: int):
        """-> (unit output, conv3's pre-activation output)."""
        if hasattr(self, "shortcut"):
            shortcut = self._cbr(x, self.shortcut, stride=stride, relu=False)
        elif stride > 1:
            shortcut = x[:, ::stride, ::stride, :]
        else:
            shortcut = x
        y = self._cbr(x, self.conv1)
        y = self._cbr(y, self.conv2, rate=rate, stride=stride)
        y = self._cbr(y, self.conv3, relu=False)
        return torch.relu(y + shortcut), y


# slim stack_blocks_dense at output stride 8 (JAX :390-398): the root
# reaches OS 4, block1's last unit strides to OS 8, then blocks 2/3/4 turn
# their strides into rates 1/2/4, block4's multiplied by the multi-grid
V3P_SPECS = ((2, (1,) * 3), (1, (1,) * 4), (1, (2,) * 23),
             (1, tuple(4 * g for g in V3P_MULTI_GRID)))


class DeepLabV3Plus(nn.Module):
    """DeepLab-v3+ on resnet_v1_101_beta (JAX ``backbones.py:306-435``):
    a three-conv root, blocks [3, 4, 23, 3] at output stride 8 with
    multi-grid rates, frozen BN; the head is ASPP with image pooling and
    separable convs, and the decoder to stride 4 with the 48-channel
    low-level projection of block1/unit_2 and align-corners resizes."""
    SCOPE = "resnet_v1_101"

    def __init__(self, num_classes: int = 47,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.root = nn.Module()
        for name, cin, cout in (("conv1_1", 3, 64), ("conv1_2", 64, 64),
                                ("conv1_3", 64, 128)):
            self.root.add_module(name, ConvBN(3, cin, cout, g))
        cin = 128
        for b, (units, cout) in enumerate(V3P_BLOCKS, 1):
            block = nn.Module()
            for u in range(units):
                block.add_module(f"unit_{u + 1}", V3PlusUnit(cin, cout, g))
                cin = cout
            self.add_module(f"block{b}", block)
        self.aspp = nn.Module()
        self.aspp.image_pooling = ConvBN(1, 2048, V3P_DEPTH, g)
        self.aspp.aspp0 = ConvBN(1, 2048, V3P_DEPTH, g)
        for i in range(1, 4):
            self.aspp.add_module(f"aspp{i}", SepConv(2048, V3P_DEPTH, g))
        self.aspp.concat_projection = ConvBN(1, 5 * V3P_DEPTH, V3P_DEPTH, g)
        self.decoder = nn.Module()
        self.decoder.feature_projection = ConvBN(1, 256, 48, g)
        self.decoder.decoder_conv0 = SepConv(V3P_DEPTH + 48, V3P_DEPTH, g)
        self.decoder.decoder_conv1 = SepConv(V3P_DEPTH, V3P_DEPTH, g)
        self.logits = Leaves(DW=he_conv(1, V3P_DEPTH, num_classes, g),
                             biases=torch.zeros(num_classes))

    @staticmethod
    def _cbr(x, q):
        return torch.relu(q.bn(conv2d(x, q.DW)))

    def forward(self, images: torch.Tensor, intermediate: bool = True):
        r = self.root
        x = torch.relu(r.conv1_1.bn(conv2d_same(images, r.conv1_1.DW, 2)))
        x = self._cbr(x, r.conv1_2)
        x = self._cbr(x, r.conv1_3)
        x = max_pool_3x3_s2(x)                  # OS 4
        low_level = None
        for b, (stride, rates) in enumerate(V3P_SPECS, 1):
            block = getattr(self, f"block{b}")
            for u, rate in enumerate(rates):
                x, conv3_out = getattr(block, f"unit_{u + 1}")(
                    x, stride if u == len(rates) - 1 else 1, rate)
                if b == 1 and u == 1:
                    low_level = conv3_out       # block1/unit_2 conv3
        if intermediate:
            # the pre-ASPP output, "(1, 96, 96, 2048)" (RMI_model.py:105)
            return x

        a = self.aspp
        n, h, w, _ = x.shape
        pooled = self._cbr(x.mean(dim=(1, 2), keepdim=True), a.image_pooling)
        branches = [pooled.expand(n, h, w, V3P_DEPTH), self._cbr(x, a.aspp0)]
        for i, rate in enumerate(V3P_ASPP_RATES, 1):
            branches.append(getattr(a, f"aspp{i}")(x, rate))
        features = self._cbr(torch.cat(branches, dim=-1),
                             a.concat_projection)

        d = self.decoder
        low = self._cbr(low_level, d.feature_projection)
        up = resize_bilinear_align_corners(features, low.shape[1],
                                           low.shape[2])
        y = d.decoder_conv0(torch.cat([up, low], dim=-1))
        y = d.decoder_conv1(y)
        logits = conv2d(y, self.logits.DW) + self.logits.biases
        return resize_bilinear_align_corners(logits, images.shape[1],
                                             images.shape[2])


BACKBONES = {"fcn_8s": (FCN8s, 256), "segnet": (SegNet, 512),
             "deeplab_v3plus": (DeepLabV3Plus, 2048)}
