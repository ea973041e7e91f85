"""Foreground instance-colorization GAN: the MRU (SketchyGAN-style)
generator, text-conditioned through the fusion conv-LSTM, and its
discriminator (``sketchyscenecolorization_tpu/models/fg_gan.py``; reference
``obj_lib/models_collection.py:251-377,676-786`` and ``obj_lib/mru.py``).

NHWC throughout.  The generator's conditional batch-norm uses batch
statistics with per-class offset/scale; ``per_sample=True`` reduces them
per row (batched serving).  The discriminator has no normalizer, PReLU
activations and spectral norm on every layer.  Channel counts, which flax
infers at call time, are computed here at construction.  Module names
follow the flax tree.  With ``num_blocks`` > 1 every stage chains that many
MRU cells: the first carries the stage's stride, the others run at stride
1 on the previous stage's state ``i`` (JAX ``fg_gan.py:134-184``), which the
first stage takes from a learnable ``initial_hidden_state_{i}`` (the
decoder's from ``initial_decoder_state_{i}``).  Under the bf16 compute-dtype
scope the sketch pyramids and the noise map are held at bf16 (JAX
``fg_gan.py:229-238``).  ``build_generator``/``build_discriminator`` also
build the Pix2Pix and Residual variants (``models/fg_gan_variants.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.conv import scope_dtype
from ..ops.image import box_downsample, mean_pool_2x2, nn_upsample_2x
from .gan_layers import (CondBatchNorm, SNConv, SNDense, TextFusionLSTM,
                         _prelu_leak, apply_activation, commit_sn, init_sn,
                         minmax_normalize, sn_weight)


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
    """Encoder MRU cell, no output gate (``mru.py:353-461``); stride 2
    mean-pools its output.  ``num_classes=None`` leaves out the
    normalizers (the discriminator)."""

    def __init__(self, cin: int, hidden: int, filter_depth: int,
                 num_classes: Optional[int], activation: str = ACT,
                 sn: bool = False, generator=None, stride: int = 2):
        super().__init__()
        g, act = generator, activation
        self.stride = stride
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
        ht_new = ht_orig + h_new
        return mean_pool_2x2(ht_new) if self.stride == 2 else ht_new


class MRUDeconvBlockV2(nn.Module):
    """Decoder MRU cell with LReLU min-max gates (``mru.py:527-591``);
    stride 2 upsamples its state first."""

    def __init__(self, cin: int, hidden: int, filter_depth: int,
                 num_classes: int, generator=None, stride: int = 2):
        super().__init__()
        g = generator
        self.stride = stride
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
        if self.stride == 2:
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
    """``mru_conv`` stage (``mru.py:594-655``): ``num_blocks`` chained
    cells, the first with stride 2; cell ``i`` > 0 takes the previous
    cell's output and the mean-pooled state ``i``.  Maps the list of
    states to the new list."""

    def __init__(self, cin, hidden, filter_depth, num_classes,
                 last_unit: bool, activation: str = ACT, sn: bool = False,
                 generator=None, num_blocks: int = 1):
        super().__init__()
        for i in range(num_blocks):
            self.add_module(f"layer_{i}", MRUConvBlockV3(
                cin if i == 0 else filter_depth, hidden, filter_depth,
                num_classes, activation, sn, generator,
                stride=2 if i == 0 else 1))
        self.num_blocks = num_blocks
        self.last_norm = (NormAct(num_classes, filter_depth, activation)
                          if last_unit else None)

    def forward(self, x, hts, labels, per_sample):
        out = [self.layer_0(x, hts[0], labels, per_sample)]
        for i in range(1, self.num_blocks):
            out.append(getattr(self, f"layer_{i}")(
                out[-1], mean_pool_2x2(hts[i]), labels, per_sample))
        if self.last_norm is not None:
            out[-1] = self.last_norm(out[-1], labels, per_sample)
        return out


class MRUDeconvStage(nn.Module):
    """``mru_deconv`` stage (``mru.py:658-713``): as ``MRUConvStage``, up
    instead of down."""

    def __init__(self, cin, hidden, filter_depth, num_classes,
                 generator=None, num_blocks: int = 1):
        super().__init__()
        for i in range(num_blocks):
            self.add_module(f"layer_{i}", MRUDeconvBlockV2(
                cin if i == 0 else filter_depth, hidden, filter_depth,
                num_classes, generator, stride=2 if i == 0 else 1))
        self.num_blocks = num_blocks

    def forward(self, x, hts, labels, per_sample):
        out = [self.layer_0(x, hts[0], labels, per_sample)]
        for i in range(1, self.num_blocks):
            out.append(getattr(self, f"layer_{i}")(
                out[-1], nn_upsample_2x(hts[i]), labels, per_sample))
        return out


def initial_states(module: nn.Module, prefix: str, num_blocks: int,
                   shape) -> None:
    """The learnable zero states ``{prefix}_{i}`` [1, *shape] of cells
    1 .. num_blocks - 1 (JAX ``fg_gan.py:243-253``)."""
    names = [f"{prefix}_{i}" for i in range(1, num_blocks)]
    for name in names:
        setattr(module, name, nn.Parameter(torch.zeros(1, *shape)))
    # NHWC activations, not kernels: the weight bridge keeps their layout
    module.NHWC_LEAVES = (*getattr(module, "NHWC_LEAVES", ()), *names)


def with_initial_states(module: nn.Module, prefix: str, num_blocks: int,
                        first: torch.Tensor):
    """[first, state 1 broadcast to first's batch, ...]."""
    return [first] + [getattr(module, f"{prefix}_{i}").expand(first.shape)
                      for i in range(1, num_blocks)]


class MRUGenerator(nn.Module):
    """``generate_mru`` (``models_collection.py:251-377``).

    sketch [B, S, S, 3] in [-1, 1]; tokens [B, T] front-padded; labels [B];
    noise_vec [B, noise_dim], passed in as in JAX.  Returns [B, S, S, 3] in
    [-1, 1].  Without ``lstm_hybrid`` the bottleneck goes to the decoder
    without the text fusion (JAX ``fg_gan.py:256-259``).
    """

    def __init__(self, num_classes: int = 25, vocab_size: int = 58,
                 size: int = 64, image_size: int = 192, noise_dim: int = 256,
                 num_blocks: int = 1, lstm_hybrid: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        s, nc = size, num_classes
        self.num_blocks = num_blocks
        self.enc_h0 = SNConv(3, 8, 7, stride=2, generator=g)
        initial_states(self, "initial_hidden_state", num_blocks,
                       (image_size // 2, image_size // 2, 8))
        hidden = 8
        for i, feat in enumerate((s, 2 * s, 4 * s, 8 * s)):
            self.add_module(f"enc_stage_{i + 1}", MRUConvStage(
                3, hidden, feat, nc, last_unit=(i == 3), generator=g,
                num_blocks=num_blocks))
            hidden = feat
        if lstm_hybrid:
            self.TextLSTM = TextFusionLSTM(vocab_size, 8 * s, g)
        noise_hw = 2 * (image_size // 32)
        self.noise_fc = SNDense(noise_dim, s * noise_hw * noise_hw,
                                activation=ACT, generator=g)
        initial_states(self, "initial_decoder_state", num_blocks,
                       (image_size // 32, image_size // 32, 8 * s))
        # decoder stage inputs: [sketch level, skip] channels
        dec = ((6 * s, 3 + s), (4 * s, 3 + 2 * s), (2 * s, 3 + s),
               (2 * s, 3 + 8), (s, 3))
        hidden = 8 * s
        for i, (feat, cin) in enumerate(dec):
            self.add_module(f"dec_stage_{i}", MRUDeconvStage(
                cin, hidden, feat, nc, generator=g, num_blocks=num_blocks))
            hidden = feat
        self.out_conv = SNConv(s, 3, 7, activation="tanh", generator=g)

    def forward(self, sketch, tokens, labels, noise_vec,
                per_sample: bool = False):
        b = sketch.shape[0]
        ps, nb = per_sample, self.num_blocks
        # AREA pyramid, smallest first: [S/32 ... S]
        resized_z = [box_downsample(sketch, 2 ** i) for i in range(6)][::-1]
        # mean-pool pyramid for the encoder, smallest first: [S/16 ... S]
        x_list = [sketch]
        for _ in range(4):
            x_list.append(mean_pool_2x2(x_list[-1]))
        x_list = x_list[::-1]
        # under the bf16 scope the pyramids are held at bf16, or an f32
        # level would promote each skip concat back to f32
        sd = scope_dtype()
        if sd is not None:
            resized_z = [r.to(sd) for r in resized_z]
            x_list = [x.to(sd) for x in x_list]

        h0 = self.enc_h0(x_list[-1])
        z_encoded = [h0]
        hts = with_initial_states(self, "initial_hidden_state", nb, h0)
        for i in range(4):
            hts = getattr(self, f"enc_stage_{i + 1}")(x_list[-2 - i], hts,
                                                      labels, ps)
            z_encoded.append(hts[-1])

        feat_final = (self.TextLSTM(z_encoded[-1], tokens)
                      if hasattr(self, "TextLSTM") else z_encoded[-1])

        e_dims = z_encoded[-1].shape
        channel_depth = e_dims[-1] // 8
        noise_hw = e_dims[1] * 2
        noise = self.noise_fc(noise_vec)
        noise = noise.reshape(b, channel_depth, noise_hw, noise_hw)
        noise = noise.permute(0, 2, 3, 1)   # NCHW in the reference -> NHWC
        if sd is not None:
            noise = noise.to(sd)

        dec_inputs = [
            torch.cat([resized_z[1], noise], dim=-1),
            torch.cat([resized_z[2], z_encoded[-3]], dim=-1),
            torch.cat([resized_z[3], z_encoded[-4]], dim=-1),
            torch.cat([resized_z[4], z_encoded[-5]], dim=-1),
            resized_z[5],
        ]
        hts = with_initial_states(self, "initial_decoder_state", nb,
                                  feat_final)
        for i, inp in enumerate(dec_inputs):
            hts = getattr(self, f"dec_stage_{i}")(inp, hts, labels, ps)
        return self.out_conv(hts[-1])


class MRUDiscriminator(nn.Module):
    """``discriminate_mru`` (``models_collection.py:676-786``; JAX
    ``fg_gan.py:301-361``): an MRU encoder over the (real or generated)
    image only, spectral norm everywhere (with ``sn``), PReLU, no
    normalizer; a 1x1-conv patch output and the ACGAN head ``ac_logits``,
    or with ``proj_d`` a projection head (``class_embedding``,
    spectral-normed from its own ``embed_u``).  A fresh one holds each
    spectral-norm vector after one power iteration, as flax's ``init``
    leaves it (``gan_layers.init_sn``).

    forward(inputs, target, labels) -> (patch logits [B, S/16, S/16, 1],
    class logits [B, num_classes] or None); the sketch ``inputs`` are
    ignored, as in JAX; called with one image, it is the target."""

    def __init__(self, num_classes: int = 25, size: int = 64,
                 sn: bool = True, proj_d: bool = False,
                 num_blocks: int = 1, image_size: int = 192,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, s = generator, size
        self.sn, self.proj_d, self.num_blocks = sn, proj_d, num_blocks
        self.h0 = SNConv(3, 8, 7, activation=D_ACT, sn=sn, generator=g)
        initial_states(self, "initial_hidden_state", num_blocks,
                       (image_size, image_size, 8))
        hidden = 8
        for i, feat in enumerate((2 * s, 4 * s, 8 * s, 12 * s)):
            self.add_module(f"stage_{i + 1}", MRUConvStage(
                3, hidden, feat, None, last_unit=(i == 3), activation=D_ACT,
                sn=sn, generator=g, num_blocks=num_blocks))
            hidden = feat
        self.disc_out = SNConv(hidden, 1, 1, sn=sn, generator=g)
        if proj_d:
            self.class_embedding = nn.Parameter(
                torch.randn(num_classes, hidden, generator=g))
            if sn:
                self.register_buffer("embed_u", torch.ones(1, hidden))
        else:
            self.ac_logits = SNDense(hidden, num_classes, sn=sn, generator=g)
        init_sn(self)
        if proj_d and sn:
            with torch.no_grad(), commit_sn(self):
                sn_weight(self, self.class_embedding, "embed_u")

    def forward(self, inputs, target=None, labels=None):
        if target is None:
            target = inputs
        x_list = [target]                   # mean-pool pyramid, S first
        for _ in range(4):
            x_list.append(mean_pool_2x2(x_list[-1]))
        hts = with_initial_states(self, "initial_hidden_state",
                                  self.num_blocks, self.h0(x_list[0]))
        for i in range(4):
            hts = getattr(self, f"stage_{i + 1}")(x_list[i], hts, labels,
                                                  False)
        ht = hts[-1]
        disc = self.disc_out(ht)
        if not self.proj_d:
            return disc, self.ac_logits(torch.mean(ht, dim=(1, 2)))
        emb = self.class_embedding
        if self.sn:
            emb = sn_weight(self, emb, "embed_u")
        class_emb = emb[labels.long()][:, None, None, :]
        return disc + torch.sum(ht * class_emb, dim=-1, keepdim=True), None


def build_discriminator(cfg, generator: Optional[torch.Generator] = None
                        ) -> nn.Module:
    """The FG discriminator of an ``FGGanConfig``, by ``block_type`` (JAX
    ``train/fg_gan.py:45-75``).  The variants take no ``proj_d``: they
    always return class logits."""
    if cfg.block_type == "MRU":
        return MRUDiscriminator(num_classes=cfg.num_classes,
                                size=cfg.base_channels, sn=cfg.spectral_norm,
                                proj_d=cfg.proj_d, num_blocks=cfg.num_blocks,
                                image_size=cfg.image_size,
                                generator=generator)
    from . import fg_gan_variants as v
    cls = {"Pix2Pix": v.Pix2PixFGDiscriminator,
           "Residual": v.ResidualFGDiscriminator}.get(cfg.block_type)
    if cls is None:
        raise ValueError(f"unknown block_type {cfg.block_type!r}")
    return cls(num_classes=cfg.num_classes, size=cfg.base_channels,
               sn=cfg.spectral_norm, generator=generator)


def build_generator(cfg, generator: Optional[torch.Generator] = None
                    ) -> nn.Module:
    """The FG generator of an ``FGGanConfig``, by ``block_type`` (JAX
    ``train/fg_gan.py:45-75``)."""
    if cfg.block_type == "MRU":
        return MRUGenerator(num_classes=cfg.num_classes,
                            vocab_size=cfg.vocab_size,
                            size=cfg.base_channels,
                            image_size=cfg.image_size,
                            noise_dim=cfg.noise_dim,
                            num_blocks=cfg.num_blocks,
                            lstm_hybrid=cfg.lstm_hybrid, generator=generator)
    from . import fg_gan_variants as v
    cls = {"Pix2Pix": v.Pix2PixFGGenerator,
           "Residual": v.ResidualFGGenerator}.get(cfg.block_type)
    if cls is None:
        raise ValueError(f"unknown block_type {cfg.block_type!r}")
    return cls(vocab_size=cfg.vocab_size, size=cfg.base_channels,
               image_size=cfg.image_size, noise_dim=cfg.noise_dim,
               lstm_hybrid=cfg.lstm_hybrid, generator=generator)
