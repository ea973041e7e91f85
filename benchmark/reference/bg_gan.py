"""Plain reference of the BG generator: the residual encoder-decoder of
``Background_Colorization/bg_colorization_main.py`` at 768^2 (ngf 64,
residual units 3/4/6/3), the text-fusion conv-LSTM at its S/32 bottleneck
and the sky/ground region branch.  Batch statistics of the one image.
Leaf names follow the measured program's state dict.
"""
from __future__ import annotations

import torch
from torch import nn

from . import ops
from .fg_gan import TextFusion
from .init import Init

UNITS = (3, 4, 6, 3)


class _Filter(nn.Module):
    def __init__(self, init: Init, shape, kind, stride=1):
        super().__init__()
        self.kind, self.stride = kind, stride
        self.filter = init.normal(shape, 0.02)

    def forward(self, x):
        if self.kind == "pad1":
            return ops.pad1_conv4(x, self.filter, self.stride)
        if self.kind == "same":
            return ops.conv2d(x, self.filter, self.stride)
        return ops.conv2d_transpose(x, self.filter, 2)


def conv(init, cin, cout, stride):                  # pad 1, 4x4 VALID
    return _Filter(init, (cout, cin, 4, 4), "pad1", stride)


def conv_ex(init, cin, cout, k, stride=1):           # SAME
    return _Filter(init, (cout, cin, k, k), "same", stride)


def deconv(init, cin, cout):
    return _Filter(init, (cin, cout, 4, 4), "deconv")


class BN(nn.Module):
    def __init__(self, init: Init, c):
        super().__init__()
        self.offset = init.const((c,), 0.0)
        self.scale = init.normal((c,), 0.02, 1.0)

    def forward(self, x):
        return ops.batch_stats_norm(x, self.offset, self.scale)


class Block(nn.Module):
    """Bottleneck: 'en' (down by 2), 'de' (up by 2), 'pu' (same size)."""

    def __init__(self, init, kind, cin, cout, encoder=True):
        super().__init__()
        mid = int(round(cout / 4))
        self.kind, self.encoder = kind, encoder
        if kind == "en":
            self.block_1_conv = conv(init, cin, mid, 2)
        elif kind == "de":
            self.block_1_deconv = deconv(init, cin, mid)
        else:
            self.block_1_conv = conv_ex(init, cout, mid, 4)
        self.block_1_bn = BN(init, mid)
        self.block_2_conv = conv_ex(init, mid, mid, 3)
        self.block_2_bn = BN(init, mid)
        self.block_3_conv = conv_ex(init, mid, cout, 1)
        self.block_3_bn = BN(init, cout)
        if kind == "en":
            self.block_add_conv = conv(init, cin, cout, 2)
            self.block_add_bn = BN(init, cout)
        elif kind == "de":
            self.block_add_deconv = deconv(init, cin, cout)
            self.block_add_bn = BN(init, cout)

    def forward(self, x):
        act = (lambda y: ops.lrelu(y, 0.2)) if self.encoder else torch.relu
        first = self.block_1_deconv if self.kind == "de" else self.block_1_conv
        y = act(self.block_1_bn(first(x)))
        y = act(self.block_2_bn(self.block_2_conv(y)))
        y = self.block_3_bn(self.block_3_conv(y))
        if self.kind == "en":
            x = self.block_add_bn(self.block_add_conv(x))
        elif self.kind == "de":
            x = self.block_add_bn(self.block_add_deconv(x))
        return act(y + x)


class ResidualGenerator(nn.Module):
    """x [1, S, S, 3] in [-1, 1], tokens [1, T] -> (rgb [1, S, S, 3],
    region logits [1, S, S, seg_classes])."""

    def __init__(self, sizes: dict, init: Init):
        super().__init__()
        if not (sizes.get("residual_enc_g", True)
                and sizes.get("multi_residual", True)):
            raise ValueError("the reference covers the residual generator")
        ngf, seg = sizes["ngf"], sizes["seg_classes"]
        self.encoder_1_conv = conv_ex(init, 3, ngf, 7, 2)
        self.encoder_1_bn = BN(init, ngf)
        self.encoders = []
        cin = ngf
        for e, out in enumerate((ngf * 2, ngf * 4, ngf * 8, ngf * 16)):
            names = []
            for u in range(UNITS[e]):
                names.append(f"encoder_{e + 2}_{u}")
                self.add_module(names[-1], Block(
                    init, "en" if u == 0 else "pu", cin, out, True))
            self.encoders.append(names)
            cin = out
        self.mLSTM_G = TextFusion(init, sizes["vocab_size"], ngf * 16)
        self.region_br_projection_conv = conv_ex(init, ngf * 16, seg, 1)
        self.region_br_projection_bn = BN(init, seg)
        self.decoders = []
        for d, out in enumerate((ngf * 8, ngf * 4, ngf * 2, ngf)):
            skip = 4 - d
            names = []
            for u in range(UNITS[skip - 1]):
                names.append(f"decoder_{skip + 1}_{u}")
                self.add_module(names[-1], Block(
                    init, "de" if u == 0 else "pu",
                    (2 * cin if d else cin) if u == 0 else out, out, False))
            self.decoders.append(names)
            self.add_module(f"region_br_{skip + 1}_deconv",
                            deconv(init, seg, seg))
            self.add_module(f"region_br_{skip + 1}_bn", BN(init, seg))
            cin = out
        self.decoder_1_deconv = deconv(init, 2 * ngf, 3)
        self.decoder_1_bn = BN(init, 3)
        self.region_br_1_deconv = deconv(init, seg, seg)
        self.region_br_1_bn = BN(init, seg)

    def forward(self, x, tokens):
        y = ops.lrelu(self.encoder_1_bn(self.encoder_1_conv(x)), 0.2)
        layers = [y]
        for names in self.encoders:
            for name in names:
                y = getattr(self, name)(y)
            layers.append(y)
        feat = self.mLSTM_G(layers[-1], tokens)
        reg = torch.relu(self.region_br_projection_bn(
            self.region_br_projection_conv(layers[-1])))
        for d, names in enumerate(self.decoders):
            skip = 4 - d
            y = feat if d == 0 else torch.cat([layers[-1], layers[skip]], -1)
            for name in names:
                y = getattr(self, name)(y)
            layers.append(y)
            reg = getattr(self, f"region_br_{skip + 1}_deconv")(reg)
            reg = torch.relu(getattr(self, f"region_br_{skip + 1}_bn")(reg))
        out = self.decoder_1_deconv(torch.cat([layers[-1], layers[0]], -1))
        out = torch.tanh(self.decoder_1_bn(out))
        reg = torch.relu(self.region_br_1_bn(self.region_br_1_deconv(reg)))
        return out, reg
