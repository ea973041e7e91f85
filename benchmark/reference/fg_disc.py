"""Plain reference of the FG instance discriminator: the MRU encoder of
SketchyGAN over the (real or generated) image alone, PReLU activations, no
normalizer, spectral norm on every convolution and dense layer, a 1x1
patch output and the ACGAN class head (``obj_lib/models_collection.py``
``discriminate_mru`` :676-786, ``obj_lib/mru.py``, ``obj_lib/sn.py``).

Widths are the paper's: base 64, stages of 128, 256, 512 and 768 channels,
25 classes.  Leaf names follow the measured program's state dict.

Spectral norm: each layer keeps its power-iteration vector ``u`` [1, out]
(drawn by ``Init`` as a leaf, so the run's seed sets it; ``settle_u`` then
stores one iteration of it, as a fresh discriminator holds).  A forward
computes one iteration from the stored vector, divides the kernel by the
sigma it gives (the gradient flows through v, the new u and sigma), and
stores the new vector only when called with ``commit=True``.  The stored
vector lives beside the leaf (``stored``), rebound on a commit, so that a
graph built on the old one keeps it.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from . import ops
from .init import Init

STREAM = 3
EPS = 1e-12


def _l2(v):
    """v / (norm + eps): ``sn.py``'s floor is on the norm."""
    return v / (torch.sqrt(torch.sum(v * v)) + EPS)


def power_iteration(w2, u):
    """(sigma, new u) of a kernel flattened to [fan_in, out]."""
    v = _l2(u @ w2.T)
    u_new = _l2(v @ w2)
    return (v @ w2 @ u_new.T)[0, 0], u_new


def prelu(x, leak):
    return torch.maximum(leak * x, x)


class _SN(nn.Module):
    """A spectral-normed layer: ``u`` (the drawn leaf) and ``stored``."""

    def normalized(self, w2, commit: bool):
        u = self.u if self.stored is None else self.stored
        sigma, u_new = power_iteration(w2, u)
        if commit:
            self.stored = u_new.detach()
        return sigma


class SNConv(_SN):
    """SAME conv with a spectral-normed kernel [O, I, k, k] ~ N(0, 0.02),
    bias, optional LReLU or PReLU."""

    def __init__(self, init: Init, cin, features, kernel, bias=0.0,
                 activation=None):
        super().__init__()
        self.activation = activation
        self.weights = init.normal((features, cin, kernel, kernel), 0.02)
        self.biases = init.const((features,), bias)
        if activation == "prelu":
            self.prelu_param = init.const((), 0.2)
        self.u = init.normal((1, features), 1.0)
        self.stored = None

    def forward(self, x, commit=False):
        w = self.weights
        sigma = self.normalized(w.reshape(w.shape[0], -1).T, commit)
        y = ops.conv2d(x, w / sigma) + self.biases
        if self.activation == "lrelu":
            return ops.lrelu(y)
        if self.activation == "prelu":
            return prelu(y, self.prelu_param)
        return y


class SNDense(_SN):
    """Dense [in, out] (Glorot), spectral-normed, + bias."""

    def __init__(self, init: Init, cin, features):
        super().__init__()
        self.weights = init.glorot((cin, features))
        self.biases = init.const((features,), 0.0)
        self.u = init.normal((1, features), 1.0)
        self.stored = None

    def forward(self, x, commit=False):
        sigma = self.normalized(self.weights, commit)
        return x @ (self.weights / sigma) + self.biases


class PReLU(nn.Module):
    """The normalizer-free ``norm_activ`` of the discriminator."""

    def __init__(self, init: Init):
        super().__init__()
        self.prelu_param = init.const((), 0.2)

    def forward(self, x):
        return prelu(x, self.prelu_param)


class Cell(nn.Module):
    """MRU conv cell without an output gate (``mru.py:353-461``), no
    normalizer, mean-pooled by 2."""

    def __init__(self, init: Init, cin, hidden, depth):
        super().__init__()
        self.norm_activation_in = PReLU(init)
        self.update_gate = SNConv(init, hidden + cin, hidden, 3, bias=0.5,
                                  activation="lrelu")
        self.image_conv = SNConv(init, cin, hidden, 3)
        self.norm_activation_merge_1 = PReLU(init)
        self.h_conv1 = SNConv(init, hidden, depth, 3, activation="prelu")
        self.h_conv2 = SNConv(init, depth, depth, 3)
        self.ht_proj = SNConv(init, hidden, depth, 1)

    def forward(self, inp, ht, commit):
        rg = ops.minmax_normalize(self.update_gate(
            torch.cat([self.norm_activation_in(ht), inp], dim=-1), commit))
        merged = self.norm_activation_merge_1(
            ht + rg * self.image_conv(inp, commit))
        h_new = self.h_conv2(self.h_conv1(merged, commit), commit)
        return ops.mean_pool_2x2(self.ht_proj(ht, commit) + h_new)


class Stage(nn.Module):
    def __init__(self, cell, last_norm=None):
        super().__init__()
        self.layer_0 = cell
        self.last_norm = last_norm


class MRUDiscriminator(nn.Module):
    """image [B, S, S, 3] -> (patch logits [B, S/16, S/16, 1], class
    logits [B, num_classes])."""

    def __init__(self, sizes: dict, init: Init):
        super().__init__()
        if sizes.get("block_type", "MRU") != "MRU" \
                or sizes.get("num_blocks", 1) != 1 \
                or not sizes.get("spectral_norm", True) \
                or sizes.get("proj_d", False):
            raise ValueError("the reference covers the spectral-norm ACGAN "
                             "MRU discriminator")
        s = sizes["base_channels"]
        self.h0 = SNConv(init, 3, 8, 7, activation="prelu")
        hidden = 8
        for i, feat in enumerate((2 * s, 4 * s, 8 * s, 12 * s)):
            self.add_module(f"stage_{i + 1}", Stage(
                Cell(init, 3, hidden, feat),
                PReLU(init) if i == 3 else None))
            hidden = feat
        self.disc_out = SNConv(init, hidden, 1, 1)
        self.ac_logits = SNDense(init, hidden, sizes["num_classes"])

    def forward(self, image, commit=False):
        x_list = [image]
        for _ in range(4):
            x_list.append(ops.mean_pool_2x2(x_list[-1]))
        ht = self.h0(x_list[0], commit)
        for i in range(4):
            stage = getattr(self, f"stage_{i + 1}")
            ht = stage.layer_0(x_list[i], ht, commit)
            if stage.last_norm is not None:
                ht = stage.last_norm(ht)
        return (self.disc_out(ht, commit),
                self.ac_logits(torch.mean(ht, dim=(1, 2)), commit))


MODEL = MRUDiscriminator


def sn_layers(model: nn.Module) -> Dict[str, _SN]:
    return {n: m for n, m in model.named_modules() if isinstance(m, _SN)}


@torch.no_grad()
def settle_u(model: nn.Module) -> None:
    """Store one power iteration of each drawn ``u`` in its leaf, as a
    fresh discriminator holds it (flax's ``init`` runs the forward with
    the vectors mutable)."""
    for m in sn_layers(model).values():
        w = m.weights
        w2 = w.reshape(w.shape[0], -1).T if w.ndim == 4 else w
        m.u.copy_(power_iteration(w2, m.u)[1])
        m.stored = None


def stored_u(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{'<layer>.u': the vector a forward reads now}."""
    return {f"{n}.u": (m.u if m.stored is None else m.stored).detach()
            for n, m in sn_layers(model).items()}
