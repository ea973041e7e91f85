"""Plain PyTorch operations of the reference models, NHWC throughout.

A frozen copy of what the measured program computes, written from the
published models (RMI, the MRU generator, the residual BG generator) and
kept here so that the benchmark's judgement never depends on the code it
judges.  Nothing here imports the program or JAX.

The masked pixel-LSTM is the plain loop: one ``h @ W_h`` product per step
over every pixel, with c and h frozen where a step is not valid.  Under
``counting()`` it computes nothing and adds the products a call needs (one
[P, H] x [H, 4H] product per valid step after the first, per batch row) to
the open tally, so that the FLOP count behind ``mfu.*`` is the same
whatever kernel the program runs.
"""
from __future__ import annotations

import contextlib
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_TALLY: Optional[list] = None


@contextlib.contextmanager
def counting():
    """Inside the block the recurrences add their needed FLOPs to the
    yielded one-element list instead of computing."""
    global _TALLY
    prev, _TALLY = _TALLY, [0]
    try:
        yield _TALLY
    finally:
        _TALLY = prev


@contextlib.contextmanager
def precision(kind: str):
    """``"float32"``: TF32 off in cuBLAS and cuDNN; ``"tf32"``: on (the
    control).  The previous flags are restored on exit."""
    if kind not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {kind!r}")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    on = kind == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def same_pads(size: int, kernel: int, stride: int, rate: int = 1
              ) -> Tuple[int, int]:
    """TF SAME padding (before, after) of one spatial dim."""
    window = (kernel - 1) * rate + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def conv2d(x, w, stride: int = 1, rate: int = 1):
    """SAME convolution, x [N, H, W, C], w [O, I, k, k]."""
    ph = same_pads(x.shape[1], w.shape[2], stride, rate)
    pw = same_pads(x.shape[2], w.shape[3], stride, rate)
    xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(xn, w, stride=stride, dilation=rate).permute(0, 2, 3, 1)


def pad1_conv4(x, w, stride: int):
    """Pad 1 on every side, then a 4x4 VALID convolution."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=1)
    return y.permute(0, 2, 3, 1)


def conv2d_transpose(x, w, stride: int = 2):
    """TF SAME transposed convolution, w [in, out, k, k]."""
    k = w.shape[2]
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=stride,
                           padding=(k - stride) // 2)
    return y.permute(0, 2, 3, 1)


def max_pool_3x3_s2(x):
    ph = same_pads(x.shape[1], 3, 2)
    pw = same_pads(x.shape[2], 3, 2)
    xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]),
               value=float("-inf"))
    return F.max_pool2d(xn, 3, 2).permute(0, 2, 3, 1)


def frozen_batch_norm(x, mean, var, beta, gamma, factor, eps=0.001):
    m = mean / factor
    v = var / factor
    inv = gamma / torch.sqrt(v + eps)
    return x * inv + (beta - m * inv)


def _moments(x, per_sample: bool):
    dims = (1, 2) if per_sample else (0, 1, 2)
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.square(x - mean).mean(dim=dims, keepdim=True)
    return mean, var


def batch_stats_norm(x, offset, scale, per_sample: bool = False, eps=1e-5):
    mean, var = _moments(x, per_sample)
    return (x - mean) / torch.sqrt(var + eps) * scale + offset


def conditional_batch_norm(x, labels, offset_table, scale_table,
                           per_sample: bool = False, eps=1e-5):
    mean, var = _moments(x, per_sample)
    offset = offset_table[labels][:, None, None, :]
    scale = scale_table[labels][:, None, None, :]
    return (x - mean) / torch.sqrt(var + eps) * scale + offset


def l2_normalize(x, dim=-1, eps=1e-12):
    """x / sqrt(max(sum x^2, eps)) (the floor on the squared sum)."""
    return x / torch.sqrt(torch.clamp_min(torch.sum(x * x, dim=dim,
                                                    keepdim=True), eps))


def lrelu(x, leak=0.2):
    return torch.maximum(leak * x, x)


def miu_relu(x, miu=0.7):
    return (x + torch.sqrt((1.0 - miu) ** 2 + x * x)) / 2.0


def atanh_transform(h, eps=1e-3):
    return torch.clamp_min(
        0.5 * (torch.log((1.0 + eps) + h) - torch.log((1.0 + eps) - h)), 0.0)


def minmax_normalize(x, eps=1e-12):
    mn = torch.amin(x, dim=(1, 2), keepdim=True)
    mx = torch.amax(x, dim=(1, 2), keepdim=True)
    return (x - mn) / (mx - mn + eps)


def mean_pool_2x2(x):
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def nn_upsample_2x(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def box_downsample(x, factor: int):
    n, h, w, c = x.shape
    return x.reshape(n, h // factor, factor, w // factor, factor,
                     c).mean(dim=(2, 4))


@lru_cache(maxsize=16)
def _tf1_bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """TF1 legacy bilinear resize (src = dst * in / out) as a matrix."""
    src = np.arange(out_size, dtype=np.float64) * (in_size / out_size)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = src - lo
    m = np.zeros((out_size, in_size), np.float32)
    m[np.arange(out_size), lo] += (1.0 - frac).astype(np.float32)
    m[np.arange(out_size), hi] += frac.astype(np.float32)
    return m


def tf1_resize_bilinear(x, out_h: int, out_w: int):
    mh = torch.from_numpy(_tf1_bilinear_matrix(x.shape[1], out_h))
    mw = torch.from_numpy(_tf1_bilinear_matrix(x.shape[2], out_w))
    y = torch.einsum("oh,nhwc->nowc", mh.to(x.device), x)
    return torch.einsum("ow,nhwc->nhoc", mw.to(x.device), y)


def lstm_cell(gates, c, forget_bias=1.0):
    """TF BasicLSTMCell, gate order (i, j, f, o)."""
    i, j, f, o = torch.chunk(gates, 4, dim=-1)
    new_c = c * torch.sigmoid(f + forget_bias) + torch.sigmoid(i) * torch.tanh(j)
    return new_c, torch.sigmoid(o) * torch.tanh(new_c)


def word_lstm(xs, valid, w, b, hidden: int):
    """A word LSTM whose state is frozen at invalid steps; returns the
    per-step outputs, zero at invalid steps ([B, T, H])."""
    bsz, t_max, _ = xs.shape
    c = xs.new_zeros((bsz, hidden))
    h = xs.new_zeros((bsz, hidden))
    outs = []
    for t in range(t_max):
        nc, nh = lstm_cell(torch.cat([xs[:, t], h], dim=-1) @ w + b, c)
        keep = valid[:, t, None]
        c = torch.where(keep, nc, c)
        h = torch.where(keep, nh, h)
        outs.append(torch.where(keep, h, torch.zeros_like(h)))
    return torch.stack(outs, dim=1), h


def pixel_lstm(pixel_term, step_term, w_h, valid):
    """The masked pixel-LSTM: gates = pixel + step[t] + h @ W_h at every
    valid step, c and h frozen elsewhere; returns the last h [N, P, H]."""
    n, p, four_h = pixel_term.shape
    hidden = four_h // 4
    if _TALLY is not None:
        kept = valid.to(torch.int64).sum(dim=1).tolist() \
            if valid.device.type != "meta" else [valid.shape[1]] * n
        _TALLY[0] += sum(2 * p * hidden * four_h * max(k - 1, 0)
                         for k in kept)
        return pixel_term.new_zeros((n, p, hidden))
    c = pixel_term.new_zeros((n, p, hidden))
    h = pixel_term.new_zeros((n, p, hidden))
    for t in range(step_term.shape[1]):
        gates = pixel_term + step_term[:, t, None, :] + h @ w_h
        nc, nh = lstm_cell(gates, c)
        keep = valid[:, t, None, None]
        c = torch.where(keep, nc, c)
        h = torch.where(keep, nh, h)
    return h


def spatial_grid(h: int, w: int) -> np.ndarray:
    """[h, w, 8]: xmin, ymin, xmax, ymax, xctr, yctr, 1/w, 1/h per cell."""
    ws = np.arange(w, dtype=np.float32)
    hs = np.arange(h, dtype=np.float32)
    xmin, xmax = ws / w * 2 - 1, (ws + 1) / w * 2 - 1
    ymin, ymax = hs / h * 2 - 1, (hs + 1) / h * 2 - 1
    out = np.zeros((h, w, 8), np.float32)
    out[:, :, 0], out[:, :, 2] = xmin[None], xmax[None]
    out[:, :, 1], out[:, :, 3] = ymin[:, None], ymax[:, None]
    out[:, :, 4] = ((xmin + xmax) / 2)[None]
    out[:, :, 5] = ((ymin + ymax) / 2)[:, None]
    out[:, :, 6], out[:, :, 7] = 1.0 / w, 1.0 / h
    return out
