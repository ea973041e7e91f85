"""Layers of the FG and BG GANs (``sketchyscenecolorization_tpu/models/gan_layers.py``).

NHWC throughout.  Batch-norm uses the current batch's statistics even at
inference, as the reference does; ``per_sample`` reduces them per row.
Parameter names follow the flax modules (``weights``, ``biases``,
``offset``, ``scale``, ``prelu_param``, the ``TextLSTM`` leaves), so
``utils/bridge.py`` maps a flax ``params`` tree 1:1.  The generators never
use spectral norm; the discriminator of the FG GAN does
(``SNConv``/``SNDense`` with ``sn=True``): each such layer keeps its
power-iteration vector as the buffer ``u`` [1, out] (the flax ``sn``
collection), and a forward stores the iteration's new ``u`` only inside
``commit_sn``, as a flax ``apply`` with ``mutable=["sn"]`` does.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
from torch import nn

from ..ops.activations import atanh_transform, lrelu, miu_relu
from ..ops.conv import conv2d
from ..ops.lstm import lstm_cell
from ..ops.mlstm import masked_pixel_lstm
from ..ops.norm import (batch_stats_norm, conditional_batch_stats_norm,
                        l2_normalize, spectral_normalize)
from .rmi import glorot, uniform

# names of the spectral-norm buffers (the flax ``sn`` collection's leaves)
SN_BUFFERS = ("u", "embed_u")


def truncated_normal(shape, generator=None) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], by the inverse CDF (the init of a
    flax ``sn`` vector, ``jax.random.truncated_normal(k, -2, 2, shape)``)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    p = lo + torch.rand(shape, generator=generator) * (1.0 - 2.0 * lo)
    return math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)


def sn_weight(module: nn.Module, w: torch.Tensor, name: str = "u",
              out_dim: int = -1) -> torch.Tensor:
    """w / sigma from the module's buffer ``name``; inside ``commit_sn``
    the buffer is then rebound to the iteration's new u (rebound, not
    written in place: the autograd graph keeps the old one)."""
    w_bar, new_u = spectral_normalize(w, getattr(module, name), out_dim)
    if getattr(module, "commit_sn", False):
        setattr(module, name, new_u.detach())
    return w_bar


@contextlib.contextmanager
def commit_sn(model: nn.Module):
    """Within the block, every spectral-normed layer of ``model`` stores
    the new u of each forward (flax ``mutable=["sn"]``)."""
    layers = [m for m in model.modules()
              if any(n in dict(m.named_buffers(recurse=False))
                     for n in SN_BUFFERS)]
    for m in layers:
        m.commit_sn = True
    try:
        yield
    finally:
        for m in layers:
            m.commit_sn = False


def apply_activation(x, activation: Optional[str],
                     module: Optional[nn.Module] = None):
    """The activations of JAX ``gan_layers.py:101-120``; ``prelu`` reads
    the learned leak ``module.prelu_param``."""
    if activation is None:
        return x
    if activation == "relu":
        return torch.relu(x)
    if activation == "lrelu":
        return lrelu(x, 0.2)
    if activation == "miu_relu":
        return miu_relu(x)
    if activation == "sigmoid":
        return torch.sigmoid(x)
    if activation == "tanh":
        return torch.tanh(x)
    if activation == "prelu":
        return torch.maximum(module.prelu_param * x, x)
    raise ValueError(f"unknown activation {activation}")


def _prelu_leak() -> nn.Parameter:
    return nn.Parameter(torch.tensor(0.2))


class PReLU(nn.Module):
    """Learned-scalar leaky ReLU, init 0.2 (``models_collection.py:56-60``)."""

    def __init__(self):
        super().__init__()
        self.param = _prelu_leak()

    def forward(self, x):
        return torch.maximum(self.param * x, x)


class SNConv(nn.Module):
    """SAME conv (spectral-normed with ``sn``) + bias + optional normalizer
    + activation (``mru.py:95-140``).  Kernel [O, I, k, k] ~ N(0, 0.02)."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1,
                 bias_init_value: float = 0.0,
                 activation: Optional[str] = None, sn: bool = False,
                 generator=None):
        super().__init__()
        self.stride = stride
        self.activation = activation
        self.sn = sn
        self.weights = nn.Parameter(torch.randn(
            features, cin, kernel, kernel, generator=generator) * 0.02)
        self.biases = nn.Parameter(torch.full((features,), bias_init_value))
        if sn:
            self.register_buffer("u", truncated_normal((1, features),
                                                       generator))
        if activation == "prelu":
            self.prelu_param = _prelu_leak()

    def forward(self, x, normalizer: Optional[Callable] = None):
        w = sn_weight(self, self.weights, out_dim=0) if self.sn \
            else self.weights
        y = conv2d(x, w, stride=self.stride) + self.biases
        if normalizer is not None:
            y = normalizer(y)
        return apply_activation(y, self.activation, self)


class SNDense(nn.Module):
    """Fully-connected layer, spectral-normed with ``sn`` (``mru.py:52-92``),
    xavier-uniform weights [in, out]."""

    def __init__(self, cin: int, features: int,
                 activation: Optional[str] = None, sn: bool = False,
                 generator=None):
        super().__init__()
        self.activation = activation
        self.sn = sn
        self.weights = nn.Parameter(glorot((cin, features), generator))
        self.biases = nn.Parameter(torch.zeros(features))
        if sn:
            self.register_buffer("u", truncated_normal((1, features),
                                                       generator))
        if activation == "prelu":
            self.prelu_param = _prelu_leak()

    def forward(self, x):
        w = sn_weight(self, self.weights) if self.sn else self.weights
        return apply_activation(x @ w + self.biases, self.activation, self)


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
