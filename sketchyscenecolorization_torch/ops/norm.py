"""Normalization primitives (``sketchyscenecolorization_tpu/ops/norm.py``).

Batch-stats BN uses the current batch's statistics even at inference, as
the reference does.  The JAX package selects per-sample statistics with a
trace-time scope; here the caller passes ``per_sample`` explicitly.  With
it, the statistics reduce over (H, W) only, so a K-row batch equals K
single-row calls (JAX ``ops/norm.py:33-59``).  Spectral normalization is
the plain function of JAX ``ops/norm.py:102-124``: the caller keeps the
power-iteration vector ``u`` and decides when to store its update.

The batch-stats norms and ``l2_normalize`` compute their statistics in
f32 and return at the input dtype (JAX ``ops/norm.py:62-99``), so a bf16
activation stream under the compute-dtype scope stays bf16; for f32 input
the casts are no-ops.
"""
from __future__ import annotations

import torch


def frozen_batch_norm(x, mean, var, beta, gamma, factor, eps: float = 0.001):
    """y = gamma * (x - mean/factor) / sqrt(var/factor + eps) + beta."""
    inv_factor = 1.0 / factor
    m = mean * inv_factor
    v = var * inv_factor
    inv = gamma * (1.0 / torch.sqrt(v + eps))
    return x * inv + (beta - m * inv)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x at f32 or wider (bf16 -> f32; f32 and f64 unchanged)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _stats(x: torch.Tensor, per_sample: bool):
    dims = (1, 2) if per_sample else (0, 1, 2)
    var, mean = torch.var_mean(x, dim=dims, correction=0, keepdim=True)
    return mean, var


def batch_stats_norm(x, offset, scale, eps: float = 1e-5,
                     per_sample: bool = False):
    """Per-channel batch statistics over (N, H, W), or (H, W) per sample."""
    xs = _wide(x)
    mean, var = _stats(xs, per_sample)
    inv = scale * (1.0 / torch.sqrt(var + eps))
    return ((xs - mean) * inv + offset).to(x.dtype)


def conditional_batch_stats_norm(x, labels, offset_table, scale_table,
                                 eps: float = 1e-5, per_sample: bool = False):
    """Batch-stats BN with per-class offset/scale.

    x: [N, H, W, C]; labels: [N] int; offset/scale tables: [n_labels, C].
    """
    xs = _wide(x)
    mean, var = _stats(xs, per_sample)
    offset = offset_table[labels][:, None, None, :]
    scale = scale_table[labels][:, None, None, :]
    return ((xs - mean) / torch.sqrt(var + eps) * scale + offset).to(x.dtype)


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    """tf.nn.l2_normalize: x * rsqrt(max(sum(x^2), eps)).  The floor is on
    the SQUARED sum; ``F.normalize`` floors the norm instead."""
    xs = _wide(x)
    sum_sq = torch.sum(xs * xs, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp_min(sum_sq, eps)).to(x.dtype)


def _sn_l2norm(v, eps: float = 1e-12):
    """v / (sqrt(sum v^2) + eps) (reference ``sn.py:8-9``): the floor is on
    the norm, unlike ``l2_normalize``."""
    return v / (torch.sqrt(torch.sum(v * v)) + eps)


def spectral_normalize(w: torch.Tensor, u: torch.Tensor, out_dim: int = -1):
    """One power iteration of spectral normalization (reference
    ``obj_lib/sn.py:12-52``; JAX ``ops/norm.py:107-124``).

    w: a weight whose ``out_dim`` axis holds its outputs (the last axis of
    a JAX kernel; 0 for a torch OIHW conv kernel); u: the stored [1, out]
    vector.  Returns (w / sigma, the new u).  The gradient flows through
    v, the new u and sigma, as in JAX (no ``stop_gradient`` there).  Unlike
    ``torch.nn.utils.spectral_norm``, nothing is detached and nothing is
    stored: the caller keeps u and commits the new one when it chooses.
    """
    w2 = w.movedim(out_dim, -1).reshape(-1, w.shape[out_dim])
    v = _sn_l2norm(u @ w2.T)          # [1, in_flat]
    u = _sn_l2norm(v @ w2)            # [1, out]
    sigma = (v @ w2 @ u.T)[0, 0]
    return w / sigma, u
