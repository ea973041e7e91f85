"""Background colorization GAN (``sketchyscenecolorization_tpu/models/bg_gan.py``;
reference ``Background_Colorization/bg_colorization_main.py:41-583``): the
text-conditioned residual generator at 768^2 with its sky/ground region
branch, the pix2pix u-net that serves ``residual_enc_g=False``, and the
PatchGAN and residual discriminators of training.

NHWC throughout; every conv is bias-free (the batch-stats BN after it gives
the offset).  Channel counts, which flax infers at call time, are computed
at construction.  Submodules and leaves are named after the flax tree
(``encoder_2_0/block_1_bn/scale``, ``mLSTM_G/alstm_w``,
``region_br_1_deconv/filter``, ...), so ``utils/bridge.py`` maps it 1:1.
The bottleneck blocks take ``per_sample`` (batch-stats per row) for the FG
variants of ``models/fg_gan_variants.py``, which reuse them; the BG
generator serves one image at a time.  Under the bf16 compute-dtype scope
the convs store bf16 and the norms keep it, so the stream stays bf16 up to
the outputs; the text fusion computes in f32 (``models/gan_layers.py``).
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..ops.activations import lrelu
from ..ops.conv import conv2d, conv2d_transpose, pad1_conv4
from .gan_layers import BatchStatsNorm, TextFusionLSTM

NUM_RESIDUAL_UNITS = (3, 4, 6, 3)


def _normal(shape, generator):
    return nn.Parameter(torch.randn(shape, generator=generator) * 0.02)


class Conv(nn.Module):
    """``conv()``: pad 1, then a 4x4 VALID conv (bg main :41-50)."""

    def __init__(self, cin: int, features: int, stride: int, generator=None):
        super().__init__()
        self.stride = stride
        self.filter = _normal((features, cin, 4, 4), generator)

    def forward(self, x):
        return pad1_conv4(x, self.filter, self.stride)


class ConvEx(nn.Module):
    """``conv_ex()``: SAME conv (bg main :53-59)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 kernel: int = 4, generator=None):
        super().__init__()
        self.stride = stride
        self.filter = _normal((features, cin, kernel, kernel), generator)

    def forward(self, x):
        return conv2d(x, self.filter, stride=self.stride)


class Deconv(nn.Module):
    """``deconv()``: SAME 4x4/2 transposed conv (bg main :62-71).  Its
    filter is [in, out, kh, kw]; ``FROM_HWIO`` tells the weight bridge how
    the JAX kernel [kh, kw, in, out] maps onto it."""
    FROM_HWIO = (2, 3, 0, 1)

    def __init__(self, cin: int, features: int, generator=None):
        super().__init__()
        self.filter = _normal((cin, features, 4, 4), generator)

    def forward(self, x):
        return conv2d_transpose(x, self.filter, stride=2)


class BottleneckResidualEn(nn.Module):
    """Encoder bottleneck (bg main :217-243)."""

    def __init__(self, cin: int, out_filter: int, stride: int,
                 generator=None):
        super().__init__()
        g, mid = generator, int(round(out_filter / 4))
        self.block_1_conv = Conv(cin, mid, stride, g)
        self.block_1_bn = BatchStatsNorm(mid, g)
        self.block_2_conv = ConvEx(mid, mid, 1, 3, g)
        self.block_2_bn = BatchStatsNorm(mid, g)
        self.block_3_conv = ConvEx(mid, out_filter, 1, 1, g)
        self.block_3_bn = BatchStatsNorm(out_filter, g)
        if stride != 1:
            self.block_add_conv = Conv(cin, out_filter, stride, g)
            self.block_add_bn = BatchStatsNorm(out_filter, g)

    def forward(self, x, per_sample: bool = False):
        ps = per_sample
        y = lrelu(self.block_1_bn(self.block_1_conv(x), ps), 0.2)
        y = lrelu(self.block_2_bn(self.block_2_conv(y), ps), 0.2)
        y = self.block_3_bn(self.block_3_conv(y), ps)
        if hasattr(self, "block_add_conv"):
            x = self.block_add_bn(self.block_add_conv(x), ps)
        return lrelu(y + x, 0.2)


class BottleneckResidualDe(nn.Module):
    """Decoder bottleneck, up by 2 (bg main :246-274)."""

    def __init__(self, cin: int, out_filter: int, generator=None):
        super().__init__()
        g, mid = generator, int(round(out_filter / 4))
        self.block_1_deconv = Deconv(cin, mid, g)
        self.block_1_bn = BatchStatsNorm(mid, g)
        self.block_2_conv = ConvEx(mid, mid, 1, 3, g)
        self.block_2_bn = BatchStatsNorm(mid, g)
        self.block_3_conv = ConvEx(mid, out_filter, 1, 1, g)
        self.block_3_bn = BatchStatsNorm(out_filter, g)
        self.block_add_deconv = Deconv(cin, out_filter, g)
        self.block_add_bn = BatchStatsNorm(out_filter, g)

    def forward(self, x, per_sample: bool = False):
        ps = per_sample
        y = torch.relu(self.block_1_bn(self.block_1_deconv(x), ps))
        y = torch.relu(self.block_2_bn(self.block_2_conv(y), ps))
        y = self.block_3_bn(self.block_3_conv(y), ps)
        return torch.relu(y + self.block_add_bn(self.block_add_deconv(x), ps))


class BottleneckResidualPu(nn.Module):
    """Same-resolution bottleneck (bg main :277-299); block 1 is a 4x4 SAME
    conv.  LReLU(0.2) in the encoder, ReLU in the decoder."""

    def __init__(self, out_filter: int, is_encoder: bool, generator=None):
        super().__init__()
        g, mid = generator, int(round(out_filter / 4))
        self.is_encoder = is_encoder
        self.block_1_conv = ConvEx(out_filter, mid, 1, 4, g)
        self.block_1_bn = BatchStatsNorm(mid, g)
        self.block_2_conv = ConvEx(mid, mid, 1, 3, g)
        self.block_2_bn = BatchStatsNorm(mid, g)
        self.block_3_conv = ConvEx(mid, out_filter, 1, 1, g)
        self.block_3_bn = BatchStatsNorm(out_filter, g)

    def _act(self, x):
        return lrelu(x, 0.2) if self.is_encoder else torch.relu(x)

    def forward(self, x, per_sample: bool = False):
        ps = per_sample
        y = self._act(self.block_1_bn(self.block_1_conv(x), ps))
        y = self._act(self.block_2_bn(self.block_2_conv(y), ps))
        return self._act(self.block_3_bn(self.block_3_conv(y), ps) + x)


class ResidualGenerator(nn.Module):
    """``create_residual_generator`` (bg main :302-420): residual encoder to
    S/32 x 16ngf, the text-fusion conv-LSTM at the bottleneck (kernel B1 on
    the card, P = (S/32)^2, H = 16ngf), residual decoder with skips, and the
    region branch's deconv chain.

    x [B, S, S, 3] in [-1, 1], tokens [B, T] (front-padded) ->
    (rgb [B, S, S, out_channels] in [-1, 1], region logits
    [B, S, S, seg_classes])."""

    def __init__(self, ngf: int = 64, vocab_size: int = 18,
                 seg_classes: int = 3, out_channels: int = 3,
                 multi_residual: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.encoder_1_conv = ConvEx(3, ngf, 2, 7, g)
        self.encoder_1_bn = BatchStatsNorm(ngf, g)
        self.encoders = []          # names of each encoder stage's blocks
        cin = ngf
        for e, out_ch in enumerate((ngf * 2, ngf * 4, ngf * 8, ngf * 16)):
            names = [f"encoder_{e + 2}_0"]
            self.add_module(names[0], BottleneckResidualEn(cin, out_ch, 2, g))
            for u in range(1, NUM_RESIDUAL_UNITS[e] if multi_residual else 1):
                names.append(f"encoder_{e + 2}_{u}")
                self.add_module(names[-1],
                                BottleneckResidualPu(out_ch, True, g))
            self.encoders.append(names)
            cin = out_ch
        self.mLSTM_G = TextFusionLSTM(vocab_size, ngf * 16, g)
        self.region_br_projection_conv = ConvEx(ngf * 16, seg_classes, 1, 1, g)
        self.region_br_projection_bn = BatchStatsNorm(seg_classes, g)

        # decoder stage d reads stage 4 - d of the encoder as its skip
        self.decoders = []
        for d, out_ch in enumerate((ngf * 8, ngf * 4, ngf * 2, ngf)):
            skip = 4 - d
            names = [f"decoder_{skip + 1}_0"]
            self.add_module(names[0], BottleneckResidualDe(2 * cin if d else cin,
                                                           out_ch, g))
            for u in range(1, NUM_RESIDUAL_UNITS[skip - 1]
                           if multi_residual else 1):
                names.append(f"decoder_{skip + 1}_{u}")
                self.add_module(names[-1],
                                BottleneckResidualPu(out_ch, False, g))
            self.decoders.append(names)
            self.add_module(f"region_br_{skip + 1}_deconv",
                            Deconv(seg_classes, seg_classes, g))
            self.add_module(f"region_br_{skip + 1}_bn",
                            BatchStatsNorm(seg_classes, g))
            cin = out_ch
        self.decoder_1_deconv = Deconv(2 * ngf, out_channels, g)
        self.decoder_1_bn = BatchStatsNorm(out_channels, g)
        self.region_br_1_deconv = Deconv(seg_classes, seg_classes, g)
        self.region_br_1_bn = BatchStatsNorm(seg_classes, g)

    def _run(self, names, y):
        for name in names:
            y = getattr(self, name)(y)
        return y

    def forward(self, x, tokens):
        y = lrelu(self.encoder_1_bn(self.encoder_1_conv(x)), 0.2)
        layers: List[torch.Tensor] = [y]
        for names in self.encoders:
            layers.append(self._run(names, layers[-1]))

        feat = self.mLSTM_G(layers[-1], tokens)
        reg = torch.relu(self.region_br_projection_bn(
            self.region_br_projection_conv(layers[-1])))
        for d, names in enumerate(self.decoders):
            skip = 4 - d
            inp = feat if d == 0 else torch.cat([layers[-1], layers[skip]],
                                                dim=-1)
            layers.append(self._run(names, inp))
            reg = getattr(self, f"region_br_{skip + 1}_deconv")(reg)
            reg = torch.relu(getattr(self, f"region_br_{skip + 1}_bn")(reg))

        out = self.decoder_1_deconv(torch.cat([layers[-1], layers[0]], dim=-1))
        out = torch.tanh(self.decoder_1_bn(out))
        reg = torch.relu(self.region_br_1_bn(self.region_br_1_deconv(reg)))
        return out, reg


class Pix2PixGenerator(nn.Module):
    """``create_generator`` (bg main :423-507): the u-net with the text
    fusion at its S/32 x 8ngf bottleneck.  Returns rgb only (no region
    branch)."""

    def __init__(self, ngf: int = 64, vocab_size: int = 18,
                 out_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        enc = (ngf, ngf * 2, ngf * 4, ngf * 8, ngf * 8)
        self.encoder_1 = Conv(3, ngf, 2, g)
        for i in range(1, 5):
            self.add_module(f"encoder_{i + 1}", Conv(enc[i - 1], enc[i], 2, g))
            self.add_module(f"encoder_{i + 1}_bn", BatchStatsNorm(enc[i], g))
        self.mLSTM_G = TextFusionLSTM(vocab_size, ngf * 8, g)
        cin = ngf * 8
        for d, out_ch in enumerate((ngf * 8, ngf * 4, ngf * 2, ngf)):
            skip = 4 - d
            self.add_module(f"decoder_{skip + 1}",
                            Deconv(2 * cin if d else cin, out_ch, g))
            self.add_module(f"decoder_{skip + 1}_bn",
                            BatchStatsNorm(out_ch, g))
            cin = out_ch
        self.decoder_1 = Deconv(2 * ngf, out_channels, g)

    def forward(self, x, tokens):
        layers: List[torch.Tensor] = [self.encoder_1(x)]
        for i in range(2, 6):
            y = getattr(self, f"encoder_{i}")(lrelu(layers[-1], 0.2))
            layers.append(getattr(self, f"encoder_{i}_bn")(y))
        feat = self.mLSTM_G(layers[-1], tokens)
        for d in range(4):
            skip = 4 - d
            inp = feat if d == 0 else torch.cat([layers[-1], layers[skip]],
                                                dim=-1)
            y = getattr(self, f"decoder_{skip + 1}")(torch.relu(inp))
            layers.append(getattr(self, f"decoder_{skip + 1}_bn")(y))
        y = torch.relu(torch.cat([layers[-1], layers[0]], dim=-1))
        return torch.tanh(self.decoder_1(y))


class PatchDiscriminator(nn.Module):
    """``create_discriminator`` (bg main :514-549; JAX ``bg_gan.py:213``):
    a 70x70-style PatchGAN over the (input, target) pair; a sigmoid
    probability map, 94^2 at 768 input."""

    def __init__(self, ndf: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.layer_1 = Conv(6, ndf, 2, g)
        cin, n_layers = ndf, 3
        for i in range(n_layers):
            out_ch = ndf * min(2 ** (i + 1), 8)
            stride = 1 if i == n_layers - 1 else 2
            self.add_module(f"layer_{i + 2}", Conv(cin, out_ch, stride, g))
            self.add_module(f"layer_{i + 2}_bn", BatchStatsNorm(out_ch, g))
            cin = out_ch
        self.layer_5 = Conv(cin, 1, 1, g)

    def forward(self, inputs, targets):
        y = lrelu(self.layer_1(torch.cat([inputs, targets], dim=-1)), 0.2)
        for i in range(2, 5):
            y = getattr(self, f"layer_{i}")(y)
            y = lrelu(getattr(self, f"layer_{i}_bn")(y), 0.2)
        return torch.sigmoid(self.layer_5(y))


class ResidualDiscriminator(nn.Module):
    """``create_residual_discriminator`` (bg main :551-583; JAX
    ``bg_gan.py:232``): a residual encoder to S/32 x 1024 over the (input,
    target) pair; a sigmoid map.  The default discriminator."""

    def __init__(self, ndf: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.layer_1 = BottleneckResidualEn(6, ndf, 2, g)
        cin = ndf
        for i in range(3):
            out_ch = ndf * min(2 ** (i + 1), 8)
            self.add_module(f"layer_{i + 2}",
                            BottleneckResidualEn(cin, out_ch, 2, g))
            cin = out_ch
        self.layer_5 = BottleneckResidualEn(cin, 1024, 2, g)

    def forward(self, inputs, targets):
        y = torch.cat([inputs, targets], dim=-1)
        for i in range(1, 6):
            y = getattr(self, f"layer_{i}")(y)
        return torch.sigmoid(y)


def build_discriminator(cfg, generator: Optional[torch.Generator] = None
                        ) -> nn.Module:
    """The BG discriminator of a ``BGGanConfig``: residual or PatchGAN, as
    JAX ``train/bg_gan.py:build_models`` picks."""
    if cfg.residual_enc_d:
        return ResidualDiscriminator(ndf=cfg.ndf, generator=generator)
    return PatchDiscriminator(ndf=cfg.ndf, generator=generator)


def build_generator(cfg, generator: Optional[torch.Generator] = None
                    ) -> nn.Module:
    """The BG generator of a ``BGGanConfig``: residual (with the region
    branch) or pix2pix, as JAX ``train/bg_gan.py:build_models`` picks."""
    if cfg.residual_enc_g:
        return ResidualGenerator(ngf=cfg.ngf, vocab_size=cfg.vocab_size,
                                 seg_classes=cfg.seg_classes,
                                 multi_residual=cfg.multi_residual,
                                 generator=generator)
    return Pix2PixGenerator(ngf=cfg.ngf, vocab_size=cfg.vocab_size,
                            generator=generator)
