"""Foreground instance-colorization GAN: the MRU (SketchyGAN-style)
generator, text-conditioned through the fusion conv-LSTM, and its
discriminator (``sketchyscenecolorization_tpu/models/fg_gan.py``; reference
``obj_lib/models_collection.py:251-377,676-786`` and ``obj_lib/mru.py``).

NHWC throughout.  The generator's conditional batch-norm uses batch
statistics with per-class offset/scale; ``per_sample=True`` reduces them
per row (batched serving).  The discriminator has no normalizer, PReLU
activations and spectral norm on every layer.  Channel counts, which flax
infers at call time, are computed here at construction.  Module names
follow the flax tree.  Only ``num_blocks=1`` is ported, so every MRU cell
has stride 2.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.image import box_downsample, mean_pool_2x2, nn_upsample_2x
from .gan_layers import (CondBatchNorm, SNConv, SNDense, TextFusionLSTM,
                         _prelu_leak, apply_activation, minmax_normalize,
                         sn_weight)


ACT = "miu_relu"        # the generator's activation; the discriminator's
D_ACT = "prelu"         # is PReLU


class NormAct(nn.Module):
    """Normalizer then activation ("norm_activ", ``mru.py:367-376``):
    conditional batch-norm with ``num_classes`` (the generator), none
    without (the discriminator)."""

    def __init__(self, num_classes: Optional[int], c: int,
                 activation: str = ACT):
        super().__init__()
        self.activation = activation
        if num_classes is not None:
            self.CondBatchNorm_0 = CondBatchNorm(num_classes, c)
        if activation == "prelu":
            self.prelu_param = _prelu_leak()

    def forward(self, x, labels, per_sample):
        if hasattr(self, "CondBatchNorm_0"):
            x = self.CondBatchNorm_0(x, labels, per_sample)
        return apply_activation(x, self.activation, self)


class MRUConvBlockV3(nn.Module):
    """Encoder MRU cell, no output gate, stride 2 (``mru.py:353-461``).
    ``num_classes=None`` leaves out the normalizers (the discriminator)."""

    def __init__(self, cin: int, hidden: int, filter_depth: int,
                 num_classes: Optional[int], activation: str = ACT,
                 sn: bool = False, generator=None):
        super().__init__()
        g, act = generator, activation
        self.norm_activation_in = NormAct(num_classes, hidden, act)
        self.update_gate = SNConv(hidden + cin, hidden, 3, bias_init_value=0.5,
                                  activation="lrelu", sn=sn, generator=g)
        self.image_conv = SNConv(cin, hidden, 3, sn=sn, generator=g)
        self.norm_activation_merge_1 = NormAct(num_classes, hidden, act)
        self.h_conv1_bn = (CondBatchNorm(num_classes, filter_depth)
                           if num_classes is not None else None)
        self.h_conv1 = SNConv(hidden, filter_depth, 3, activation=act, sn=sn,
                              generator=g)
        self.h_conv2 = SNConv(filter_depth, filter_depth, 3, sn=sn,
                              generator=g)
        self.ht_proj = (SNConv(hidden, filter_depth, 1, sn=sn, generator=g)
                        if hidden != filter_depth else None)

    def forward(self, inp, ht, labels, per_sample):
        ht_na = self.norm_activation_in(ht, labels, per_sample)
        rg = minmax_normalize(self.update_gate(torch.cat([ht_na, inp], dim=-1)))
        img_new = self.image_conv(inp)
        ht_new_in = self.norm_activation_merge_1(ht + rg * img_new, labels,
                                                 per_sample)
        bn = self.h_conv1_bn
        h_new = self.h_conv1(
            ht_new_in, bn and (lambda y: bn(y, labels, per_sample)))
        h_new = self.h_conv2(h_new)
        ht_orig = ht if self.ht_proj is None else self.ht_proj(ht)
        return mean_pool_2x2(ht_orig + h_new)


class MRUDeconvBlockV2(nn.Module):
    """Decoder MRU cell with LReLU min-max gates, stride 2
    (``mru.py:527-591``)."""

    def __init__(self, cin: int, hidden: int, filter_depth: int,
                 num_classes: int, generator=None):
        super().__init__()
        g = generator
        full = hidden + cin
        self.update_gate = SNConv(full, hidden, 3, activation="lrelu",
                                  generator=g)
        self.output_gate = SNConv(full, filter_depth, 3, activation="lrelu",
                                  generator=g)
        self.h_conv1_bn = CondBatchNorm(num_classes, filter_depth)
        self.h_conv2_bn = CondBatchNorm(num_classes, filter_depth)
        self.h_conv1 = SNConv(full, filter_depth, 3, activation=ACT,
                              generator=g)
        self.h_conv2 = SNConv(filter_depth, filter_depth, 3, activation=ACT,
                              generator=g)
        if hidden != filter_depth:
            self.ht_proj_bn = CondBatchNorm(num_classes, filter_depth)
            self.ht_proj = SNConv(hidden, filter_depth, 1, activation=ACT,
                                  generator=g)
        else:
            self.ht_proj = None

    def forward(self, inp, ht, labels, per_sample):
        ht = nn_upsample_2x(ht)
        full_inp = torch.cat([ht, inp], dim=-1)
        rg = minmax_normalize(self.update_gate(full_inp))
        zg = minmax_normalize(self.output_gate(full_inp))
        h_new = self.h_conv1(torch.cat([rg * ht, inp], dim=-1),
                             lambda y: self.h_conv1_bn(y, labels, per_sample))
        h_new = self.h_conv2(h_new,
                             lambda y: self.h_conv2_bn(y, labels, per_sample))
        if self.ht_proj is not None:
            ht = self.ht_proj(ht,
                              lambda y: self.ht_proj_bn(y, labels, per_sample))
        return ht * (1.0 - zg) + h_new * zg


class MRUConvStage(nn.Module):
    """``mru_conv`` stage with one cell (``mru.py:594-655``)."""

    def __init__(self, cin, hidden, filter_depth, num_classes,
                 last_unit: bool, activation: str = ACT, sn: bool = False,
                 generator=None):
        super().__init__()
        self.layer_0 = MRUConvBlockV3(cin, hidden, filter_depth, num_classes,
                                      activation, sn, generator)
        self.last_norm = (NormAct(num_classes, filter_depth, activation)
                          if last_unit else None)

    def forward(self, x, ht, labels, per_sample):
        out = self.layer_0(x, ht, labels, per_sample)
        if self.last_norm is not None:
            out = self.last_norm(out, labels, per_sample)
        return out


class MRUDeconvStage(nn.Module):
    """``mru_deconv`` stage with one cell (``mru.py:658-713``)."""

    def __init__(self, cin, hidden, filter_depth, num_classes,
                 generator=None):
        super().__init__()
        self.layer_0 = MRUDeconvBlockV2(cin, hidden, filter_depth,
                                        num_classes, generator)

    def forward(self, x, ht, labels, per_sample):
        return self.layer_0(x, ht, labels, per_sample)


class MRUGenerator(nn.Module):
    """``generate_mru`` (``models_collection.py:251-377``).

    sketch [B, S, S, 3] in [-1, 1]; tokens [B, T] front-padded; labels [B];
    noise_vec [B, noise_dim], passed in as in JAX.  Returns [B, S, S, 3] in
    [-1, 1].
    """

    def __init__(self, num_classes: int = 25, vocab_size: int = 58,
                 size: int = 64, image_size: int = 192, noise_dim: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        s, nc = size, num_classes
        self.enc_h0 = SNConv(3, 8, 7, stride=2, generator=g)
        hidden = 8
        for i, feat in enumerate((s, 2 * s, 4 * s, 8 * s)):
            self.add_module(f"enc_stage_{i + 1}", MRUConvStage(
                3, hidden, feat, nc, last_unit=(i == 3), generator=g))
            hidden = feat
        self.TextLSTM = TextFusionLSTM(vocab_size, 8 * s, g)
        noise_hw = 2 * (image_size // 32)
        self.noise_fc = SNDense(noise_dim, s * noise_hw * noise_hw,
                                activation=ACT, generator=g)
        # decoder stage inputs: [sketch level, skip] channels
        dec = ((6 * s, 3 + s), (4 * s, 3 + 2 * s), (2 * s, 3 + s),
               (2 * s, 3 + 8), (s, 3))
        hidden = 8 * s
        for i, (feat, cin) in enumerate(dec):
            self.add_module(f"dec_stage_{i}", MRUDeconvStage(
                cin, hidden, feat, nc, generator=g))
            hidden = feat
        self.out_conv = SNConv(s, 3, 7, activation="tanh", generator=g)

    def forward(self, sketch, tokens, labels, noise_vec,
                per_sample: bool = False):
        b = sketch.shape[0]
        ps = per_sample
        # AREA pyramid, smallest first: [S/32 ... S]
        resized_z = [box_downsample(sketch, 2 ** i) for i in range(6)][::-1]
        # mean-pool pyramid for the encoder, smallest first: [S/16 ... S]
        x_list = [sketch]
        for _ in range(4):
            x_list.append(mean_pool_2x2(x_list[-1]))
        x_list = x_list[::-1]

        h0 = self.enc_h0(x_list[-1])
        z_encoded = [h0]
        ht = h0
        for i in range(4):
            ht = getattr(self, f"enc_stage_{i + 1}")(x_list[-2 - i], ht,
                                                     labels, ps)
            z_encoded.append(ht)

        feat_final = self.TextLSTM(z_encoded[-1], tokens)

        e_dims = z_encoded[-1].shape
        channel_depth = e_dims[-1] // 8
        noise_hw = e_dims[1] * 2
        noise = self.noise_fc(noise_vec)
        noise = noise.reshape(b, channel_depth, noise_hw, noise_hw)
        noise = noise.permute(0, 2, 3, 1)   # NCHW in the reference -> NHWC

        dec_inputs = [
            torch.cat([resized_z[1], noise], dim=-1),
            torch.cat([resized_z[2], z_encoded[-3]], dim=-1),
            torch.cat([resized_z[3], z_encoded[-4]], dim=-1),
            torch.cat([resized_z[4], z_encoded[-5]], dim=-1),
            resized_z[5],
        ]
        ht = feat_final
        for i, inp in enumerate(dec_inputs):
            ht = getattr(self, f"dec_stage_{i}")(inp, ht, labels, ps)
        return self.out_conv(ht)


class MRUDiscriminator(nn.Module):
    """``discriminate_mru`` (``models_collection.py:676-786``; JAX
    ``fg_gan.py:301-361``): an MRU encoder over the (real or generated)
    image only, spectral norm everywhere (with ``sn``), PReLU, no
    normalizer; a 1x1-conv patch output and the ACGAN head ``ac_logits``,
    or with ``proj_d`` a projection head (``class_embedding``,
    spectral-normed from its own ``embed_u``).

    forward(inputs, target, labels) -> (patch logits [B, S/16, S/16, 1],
    class logits [B, num_classes] or None); the sketch ``inputs`` are
    ignored, as in JAX; called with one image, it is the target."""

    def __init__(self, num_classes: int = 25, size: int = 64,
                 sn: bool = True, proj_d: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, s = generator, size
        self.sn, self.proj_d = sn, proj_d
        self.h0 = SNConv(3, 8, 7, activation=D_ACT, sn=sn, generator=g)
        hidden = 8
        for i, feat in enumerate((2 * s, 4 * s, 8 * s, 12 * s)):
            self.add_module(f"stage_{i + 1}", MRUConvStage(
                3, hidden, feat, None, last_unit=(i == 3), activation=D_ACT,
                sn=sn, generator=g))
            hidden = feat
        self.disc_out = SNConv(hidden, 1, 1, sn=sn, generator=g)
        if proj_d:
            self.class_embedding = nn.Parameter(
                torch.randn(num_classes, hidden, generator=g))
            if sn:
                self.register_buffer("embed_u", torch.ones(1, hidden))
        else:
            self.ac_logits = SNDense(hidden, num_classes, sn=sn, generator=g)

    def forward(self, inputs, target=None, labels=None):
        if target is None:
            target = inputs
        x_list = [target]                   # mean-pool pyramid, S first
        for _ in range(4):
            x_list.append(mean_pool_2x2(x_list[-1]))
        ht = self.h0(x_list[0])
        for i in range(4):
            ht = getattr(self, f"stage_{i + 1}")(x_list[i], ht, labels,
                                                 False)
        disc = self.disc_out(ht)
        if not self.proj_d:
            return disc, self.ac_logits(torch.mean(ht, dim=(1, 2)))
        emb = self.class_embedding
        if self.sn:
            emb = sn_weight(self, emb, "embed_u")
        class_emb = emb[labels.long()][:, None, None, :]
        return disc + torch.sum(ht * class_emb, dim=-1, keepdim=True), None


def _check_ported(cfg) -> None:
    if cfg.block_type != "MRU" or cfg.num_blocks != 1 or not cfg.lstm_hybrid:
        raise NotImplementedError(
            "only the MRU generator and discriminator with num_blocks=1 and "
            "lstm_hybrid are ported; the variants are ROADMAP item A10")
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            "the port computes in float32 only; compute_dtype='bfloat16' is "
            "ROADMAP item A10")


def build_discriminator(cfg, generator: Optional[torch.Generator] = None
                        ) -> MRUDiscriminator:
    """The FG discriminator of an ``FGGanConfig`` (JAX
    ``train/fg_gan.py:build_models``)."""
    _check_ported(cfg)
    return MRUDiscriminator(num_classes=cfg.num_classes,
                            size=cfg.base_channels, sn=cfg.spectral_norm,
                            proj_d=cfg.proj_d, generator=generator)


def build_generator(cfg, generator: Optional[torch.Generator] = None
                    ) -> MRUGenerator:
    """The FG generator of an ``FGGanConfig``; raises on the options that
    are not ported yet."""
    _check_ported(cfg)
    return MRUGenerator(num_classes=cfg.num_classes,
                        vocab_size=cfg.vocab_size, size=cfg.base_channels,
                        image_size=cfg.image_size, noise_dim=cfg.noise_dim,
                        generator=generator)
