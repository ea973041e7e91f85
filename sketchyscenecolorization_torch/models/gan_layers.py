"""Layers of the FG and BG generators (``sketchyscenecolorization_tpu/models/gan_layers.py``).

NHWC throughout.  Batch-norm uses the current batch's statistics even at
inference, as the reference does; ``per_sample`` reduces them per row.
Parameter names follow the flax modules (``weights``, ``biases``,
``offset``, ``scale``, the ``TextLSTM`` leaves), so ``utils/bridge.py`` maps
a flax ``params`` tree 1:1.  The generator never uses spectral norm
(``fg_gan.py:224``); the spectral-norm path of ``SNConv``/``SNDense`` is
ROADMAP item A9 and absent here.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..ops.activations import atanh_transform, lrelu, miu_relu
from ..ops.conv import conv2d
from ..ops.lstm import lstm_cell
from ..ops.mlstm import masked_pixel_lstm
from ..ops.norm import (batch_stats_norm, conditional_batch_stats_norm,
                        l2_normalize)
from .rmi import glorot, uniform


def apply_activation(x, activation: Optional[str]):
    """The activations the generator uses (JAX ``gan_layers.py:102-120``
    also has the discriminator's)."""
    if activation is None:
        return x
    if activation == "lrelu":
        return lrelu(x, 0.2)
    if activation == "miu_relu":
        return miu_relu(x)
    if activation == "tanh":
        return torch.tanh(x)
    raise ValueError(f"unknown activation {activation}")


class SNConv(nn.Module):
    """SAME conv + bias + optional normalizer + activation (``mru.py:95-140``).
    Kernel [O, I, k, k] ~ N(0, 0.02)."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1,
                 bias_init_value: float = 0.0,
                 activation: Optional[str] = None, generator=None):
        super().__init__()
        self.stride = stride
        self.activation = activation
        self.weights = nn.Parameter(torch.randn(
            features, cin, kernel, kernel, generator=generator) * 0.02)
        self.biases = nn.Parameter(torch.full((features,), bias_init_value))

    def forward(self, x, normalizer: Optional[Callable] = None):
        y = conv2d(x, self.weights, stride=self.stride) + self.biases
        if normalizer is not None:
            y = normalizer(y)
        return apply_activation(y, self.activation)


class SNDense(nn.Module):
    """Fully-connected layer (``mru.py:52-92``), xavier-uniform weights."""

    def __init__(self, cin: int, features: int,
                 activation: Optional[str] = None, generator=None):
        super().__init__()
        self.activation = activation
        self.weights = nn.Parameter(glorot((cin, features), generator))
        self.biases = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return apply_activation(x @ self.weights + self.biases,
                                self.activation)


class CondBatchNorm(nn.Module):
    """Conditional batch-stats BN (``models_collection.py:22-34``)."""

    def __init__(self, n_labels: int, c: int):
        super().__init__()
        self.offset = nn.Parameter(torch.zeros(n_labels, c))
        self.scale = nn.Parameter(torch.ones(n_labels, c))

    def forward(self, x, labels, per_sample: bool = False):
        return conditional_batch_stats_norm(x, labels, self.offset,
                                            self.scale, per_sample=per_sample)


class BatchStatsNorm(nn.Module):
    """Unconditional batch-stats BN of the BG generator
    (``bg_colorization_main.py:86-98``; JAX ``gan_layers.py:136-147``):
    statistics of the current batch always, no running statistics; offset
    zeros, scale ~ N(1, 0.02), eps 1e-5."""

    def __init__(self, c: int, generator=None):
        super().__init__()
        self.offset = nn.Parameter(torch.zeros(c))
        self.scale = nn.Parameter(
            1.0 + 0.02 * torch.randn(c, generator=generator))

    def forward(self, x):
        return batch_stats_norm(x, self.offset, self.scale)


def minmax_normalize(x, eps: float = 1e-12):
    """(x - min)/(max - min + eps) over the spatial dims, per (batch,
    channel) (``mru.py:312-321``)."""
    mn = torch.amin(x, dim=(1, 2), keepdim=True)
    mx = torch.amax(x, dim=(1, 2), keepdim=True)
    return (x - mn) / (mx - mn + eps)


class TextFusionLSTM(nn.Module):
    """The text-conditioning conv-LSTM of the generators
    (``models_collection.py:150-248``; JAX ``gan_layers.py:159-232``).

    A word LSTM reads the embeddings; at each step the L2-normed sentence
    state, the word embedding and the L2-normed visual feature drive a
    second LSTM over every bottleneck cell.  Pad tokens (0, front-padded)
    skip both cells.  The second LSTM's input projection is factored, and
    its recurrence is ``masked_pixel_lstm`` (the CUDA kernel on the card).

    visual [B, h, w, C], tokens [B, T] -> [B, h, w, C].
    """

    def __init__(self, vocab_size: int, c: int, generator=None):
        super().__init__()
        g = generator
        self.embedding = nn.Parameter(uniform((vocab_size, c), 0.08, g))
        self.wlstm_w = nn.Parameter(glorot((2 * c, 4 * c), g))
        self.wlstm_b = nn.Parameter(torch.zeros(4 * c))
        self.alstm_w = nn.Parameter(glorot((4 * c, 4 * c), g))
        self.alstm_b = nn.Parameter(torch.zeros(4 * c))

    def forward(self, visual, tokens):
        b, h, w, c = visual.shape
        emb = self.embedding[tokens]                 # [B, T, C]
        valid = tokens != 0                          # [B, T]

        # word LSTM with pad skipping
        cs = visual.new_zeros((b, c))
        hs = visual.new_zeros((b, c))
        h_w_seq = []
        for t in range(tokens.shape[1]):
            gates = torch.cat([emb[:, t], hs], dim=-1) @ self.wlstm_w \
                + self.wlstm_b
            nc, nh = lstm_cell(gates, cs)
            keep = valid[:, t, None]
            cs = torch.where(keep, nc, cs)
            hs = torch.where(keep, nh, hs)
            h_w_seq.append(hs)
        lang = l2_normalize(torch.stack(h_w_seq, dim=1), dim=-1)

        visual_norm = l2_normalize(visual, dim=-1).reshape(b, h * w, c)
        w_a = self.alstm_w
        w_v, w_w, w_l, w_h = w_a[:c], w_a[c:2 * c], w_a[2 * c:3 * c], w_a[3 * c:]
        pixel_term = visual_norm @ w_v                               # [B, P, 4C]
        step_term = emb @ w_w + lang @ w_l + self.alstm_b            # [B, T, 4C]
        h_a = masked_pixel_lstm(pixel_term, step_term, w_h, valid)
        return atanh_transform(h_a.reshape(b, h, w, c))
