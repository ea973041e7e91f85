"""The Pix2Pix and Residual variants of the FG colorization GAN
(``sketchyscenecolorization_tpu/models/fg_gan_variants.py``; reference
``obj_lib/models_collection.py:409-672,789-893``), selected by
``FGGanConfig.block_type``.

They reuse the BG GAN's blocks (``Conv``, ``ConvEx``, ``Deconv`` and the
bottleneck residual units of ``models/bg_gan.py``), as the JAX package
does, with unconditional batch-stats BN throughout: the class labels are
ignored (conditional BN is MRU-only).  Both generators end their encoders
at S/32 x 8 base channels (6 x 6 x 512 at the default 192^2, base 64) and
run the text fusion there (kernel B1 on the card), then add the noise map.
``per_sample`` reduces every batch norm per row (batched serving).  Module
names follow the flax trees, so ``utils/bridge.py`` maps them 1:1.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..ops.activations import lrelu
from .bg_gan import (NUM_RESIDUAL_UNITS, BottleneckResidualDe,
                     BottleneckResidualEn, BottleneckResidualPu, Conv, ConvEx,
                     Deconv)
from .gan_layers import BatchStatsNorm, SNDense, TextFusionLSTM, init_sn


class _NoiseFC(nn.Module):
    """noise [B, noise_dim] -> [B, h, w, c] through a miu_relu dense layer
    ``noise_fc``, reshaped in the reference's NCHW order
    (``models_collection.py:494-501``; JAX ``fg_gan_variants.py:31-44``)."""

    def __init__(self, noise_dim: int, h: int, w: int, c: int,
                 generator=None):
        super().__init__()
        self.shape = (c, h, w)
        self.noise_fc = SNDense(noise_dim, c * h * w, activation="miu_relu",
                                generator=generator)

    def forward(self, noise_vec):
        out = self.noise_fc(noise_vec).reshape(noise_vec.shape[0],
                                               *self.shape)
        return out.permute(0, 2, 3, 1)


class _VariantGenerator(nn.Module):
    """What both generators share: the text fusion (``TextLSTM``, with
    ``lstm_hybrid``) and the noise map at the S/32 x 8s bottleneck."""

    def _init_bottleneck(self, vocab_size, size, image_size, noise_dim,
                         lstm_hybrid, generator):
        if lstm_hybrid:
            self.TextLSTM = TextFusionLSTM(vocab_size, 8 * size, generator)
        hw = image_size // 32
        self.noise = _NoiseFC(noise_dim, hw, hw, size, generator)

    def _bottleneck(self, feat, tokens, noise_vec):
        """concat(text-fused features, noise) [B, S/32, S/32, 9s].  The
        noise map stays f32 under the bf16 scope, as in JAX, so the concat
        is f32 there."""
        if hasattr(self, "TextLSTM"):
            feat = self.TextLSTM(feat, tokens)
        return torch.cat([feat, self.noise(noise_vec)], dim=-1)


class Pix2PixFGGenerator(_VariantGenerator):
    """``generate_pix2pix`` (JAX ``fg_gan_variants.py:47-88``): a u-net,
    5 down and 5 up, with the text fusion and the noise at the bottleneck.
    forward(sketch, tokens, labels, noise_vec) -> [B, S, S, 3] in
    [-1, 1]."""

    def __init__(self, vocab_size: int = 58, size: int = 64,
                 image_size: int = 192, noise_dim: int = 256,
                 output_channel: int = 3, lstm_hybrid: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, s = generator, size
        enc = (s, 2 * s, 4 * s, 8 * s, 8 * s)
        self.encoder_1 = Conv(3, s, 2, g)
        for i in range(1, 5):
            self.add_module(f"encoder_{i + 1}", Conv(enc[i - 1], enc[i], 2, g))
            self.add_module(f"encoder_{i + 1}_bn", BatchStatsNorm(enc[i], g))
        self._init_bottleneck(vocab_size, s, image_size, noise_dim,
                              lstm_hybrid, g)
        cin = 9 * s
        for d, out_ch in enumerate((8 * s, 4 * s, 2 * s, s)):
            skip = 4 - d
            self.add_module(f"decoder_{skip + 1}", Deconv(cin, out_ch, g))
            self.add_module(f"decoder_{skip + 1}_bn",
                            BatchStatsNorm(out_ch, g))
            cin = 2 * out_ch
        self.decoder_1 = Deconv(2 * s, output_channel, g)

    def forward(self, sketch, tokens, labels, noise_vec,
                per_sample: bool = False):
        ps = per_sample
        layers: List[torch.Tensor] = [self.encoder_1(sketch)]
        for i in range(2, 6):
            y = getattr(self, f"encoder_{i}")(lrelu(layers[-1], 0.2))
            layers.append(getattr(self, f"encoder_{i}_bn")(y, ps))
        for d in range(4):
            skip = 4 - d
            inp = (self._bottleneck(layers[-1], tokens, noise_vec) if d == 0
                   else torch.cat([layers[-1], layers[skip]], dim=-1))
            y = getattr(self, f"decoder_{skip + 1}")(torch.relu(inp))
            layers.append(getattr(self, f"decoder_{skip + 1}_bn")(y, ps))
        y = torch.relu(torch.cat([layers[-1], layers[0]], dim=-1))
        return torch.tanh(self.decoder_1(y))


class ResidualFGGenerator(_VariantGenerator):
    """``generate_residual`` (JAX ``fg_gan_variants.py:91-135``):
    bottleneck-residual encoder and decoder with [3, 4, 6, 3] units a
    stage, the text fusion and the noise at the bottleneck."""

    def __init__(self, vocab_size: int = 58, size: int = 64,
                 image_size: int = 192, noise_dim: int = 256,
                 output_channel: int = 3, lstm_hybrid: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, s = generator, size
        self.encoder_1_conv = ConvEx(3, s, 2, 7, g)
        self.encoder_1_bn = BatchStatsNorm(s, g)
        self.encoders, self.decoders = [], []
        cin = s
        for e, out_ch in enumerate((2 * s, 4 * s, 8 * s, 8 * s)):
            names = [f"encoder_{e + 2}_0"]
            self.add_module(names[0], BottleneckResidualEn(cin, out_ch, 2, g))
            for u in range(1, NUM_RESIDUAL_UNITS[e]):
                names.append(f"encoder_{e + 2}_{u}")
                self.add_module(names[-1],
                                BottleneckResidualPu(out_ch, True, g))
            self.encoders.append(names)
            cin = out_ch
        self._init_bottleneck(vocab_size, s, image_size, noise_dim,
                              lstm_hybrid, g)
        cin = 9 * s
        for d, out_ch in enumerate((8 * s, 4 * s, 2 * s, s)):
            skip = 4 - d
            names = [f"decoder_{skip + 1}_0"]
            self.add_module(names[0], BottleneckResidualDe(cin, out_ch, g))
            for u in range(1, NUM_RESIDUAL_UNITS[skip - 1]):
                names.append(f"decoder_{skip + 1}_{u}")
                self.add_module(names[-1],
                                BottleneckResidualPu(out_ch, False, g))
            self.decoders.append(names)
            cin = 2 * out_ch
        self.decoder_1_deconv = Deconv(2 * s, output_channel, g)
        self.decoder_1_bn = BatchStatsNorm(output_channel, g)

    def _run(self, names, y, per_sample):
        for name in names:
            y = getattr(self, name)(y, per_sample)
        return y

    def forward(self, sketch, tokens, labels, noise_vec,
                per_sample: bool = False):
        ps = per_sample
        y = self.encoder_1_bn(self.encoder_1_conv(sketch), ps)
        layers: List[torch.Tensor] = [lrelu(y, 0.2)]
        for names in self.encoders:
            layers.append(self._run(names, layers[-1], ps))
        for d, names in enumerate(self.decoders):
            skip = 4 - d
            inp = (self._bottleneck(layers[-1], tokens, noise_vec) if d == 0
                   else torch.cat([layers[-1], layers[skip]], dim=-1))
            layers.append(self._run(names, inp, ps))
        y = self.decoder_1_deconv(torch.cat([layers[-1], layers[0]], dim=-1))
        return torch.tanh(self.decoder_1_bn(y, ps))


class Pix2PixFGDiscriminator(nn.Module):
    """``discriminate_pix2pix`` (JAX ``fg_gan_variants.py:138-157``): a
    PatchGAN over concat(sketch, target), and the class head
    ``ac_logits`` (spectral-normed with ``sn``) on the mean-pooled last
    feature map; a fresh one holds ``u`` after one power iteration, as
    flax's ``init`` leaves it.  forward(inputs, targets, labels) -> (patch
    logits, class logits)."""

    def __init__(self, num_classes: int = 25, size: int = 64,
                 sn: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        g, s = generator, size
        self.layer_1 = Conv(6, s, 2, g)
        cin = s
        for i in range(3):
            out_ch = s * min(2 ** (i + 1), 8)
            self.add_module(f"layer_{i + 2}",
                            Conv(cin, out_ch, 1 if i == 2 else 2, g))
            self.add_module(f"layer_{i + 2}_bn", BatchStatsNorm(out_ch, g))
            cin = out_ch
        self.layer_5 = Conv(cin, 1, 1, g)
        self.ac_logits = SNDense(cin, num_classes, sn=sn, generator=g)
        init_sn(self)

    def forward(self, inputs, targets, labels=None):
        y = lrelu(self.layer_1(torch.cat([inputs, targets], dim=-1)), 0.2)
        for i in range(2, 5):
            y = lrelu(getattr(self, f"layer_{i}_bn")(
                getattr(self, f"layer_{i}")(y)), 0.2)
        return self.layer_5(y), self.ac_logits(torch.mean(y, dim=(1, 2)))


class ResidualFGDiscriminator(nn.Module):
    """``discriminate_residual`` (JAX ``fg_gan_variants.py:160-175``): five
    stride-2 residual encoder stages, the patch output through a 4x4 conv,
    the class head ``ac_logits`` on the fourth stage."""

    def __init__(self, num_classes: int = 25, size: int = 64,
                 sn: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        g, s = generator, size
        self.layer_1 = BottleneckResidualEn(6, s, 2, g)
        cin = s
        for i in range(3):
            out_ch = s * min(2 ** (i + 1), 8)
            self.add_module(f"layer_{i + 2}",
                            BottleneckResidualEn(cin, out_ch, 2, g))
            cin = out_ch
        self.layer_5 = BottleneckResidualEn(cin, 512, 2, g)
        self.layer_5_out = ConvEx(512, 1, 1, 4, g)
        self.ac_logits = SNDense(cin, num_classes, sn=sn, generator=g)
        init_sn(self)

    def forward(self, inputs, targets, labels=None):
        y = torch.cat([inputs, targets], dim=-1)
        for i in range(1, 5):
            y = getattr(self, f"layer_{i}")(y)
        disc = self.layer_5_out(self.layer_5(y))
        return disc, self.ac_logits(torch.mean(y, dim=(1, 2)))
