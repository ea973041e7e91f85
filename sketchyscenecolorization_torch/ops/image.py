"""Image resampling ops, NHWC (``sketchyscenecolorization_tpu/ops/image.py``).

``tf1_resize_bilinear`` reproduces TF1's legacy grid (src = dst * in/out,
``align_corners=False``) as two dense interpolation matmuls;
``F.interpolate`` samples at half-pixel centres and does not match it.
``resize_bilinear_half_pixel`` is ``jax.image.resize(..., "bilinear")``,
which samples at half-pixel centres but, when it shrinks, antialiases: it
widens the triangle kernel by 1/scale and renormalises the weights, which
``F.interpolate(align_corners=False)`` does not do.  It too is two dense
matmuls, with the weights ``jax.image.scale_and_translate`` computes.
``resize_bilinear_align_corners`` (TF ``align_corners=True``, DeepLab-v3+'s
decoder) is built the same way.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def mean_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N, H/2, W/2, C], 2x2 average (``mru.py:15-19``)."""
    return (x[:, ::2, ::2] + x[:, 1::2, ::2] + x[:, ::2, 1::2]
            + x[:, 1::2, 1::2]) / 4.0


def nn_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N, 2H, 2W, C] by pixel replication."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def box_downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor box average (== TF AREA resize for integer factors)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // factor, factor, w // factor, factor, c)
    return x.mean(dim=(2, 4))


@lru_cache(maxsize=64)
def _tf1_bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out_size, in_size] matrix of TF1 resize_bilinear
    (JAX ``ops/image.py:43-67``)."""
    scale = in_size / out_size
    src = np.arange(out_size, dtype=np.float64) * scale
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = src - lo
    m = np.zeros((out_size, in_size), dtype=np.float32)
    m[np.arange(out_size), lo] += (1.0 - frac).astype(np.float32)
    m[np.arange(out_size), hi] += frac.astype(np.float32)
    return m


def tf1_resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Exact TF1 legacy bilinear resize, [N, H, W, C] -> [N, out_h, out_w, C]."""
    _, h, w, _ = x.shape
    mh = torch.from_numpy(_tf1_bilinear_matrix(h, out_h)).to(x.device)
    mw = torch.from_numpy(_tf1_bilinear_matrix(w, out_w)).to(x.device)
    y = torch.einsum("oh,nhwc->nowc", mh, x)
    return torch.einsum("ow,nhwc->nhoc", mw, y)


@lru_cache(maxsize=64)
def _half_pixel_bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out_size, in_size] matrix of ``jax.image.resize(...,
    "bilinear")`` (``compute_weight_mat`` of ``jax/_src/image/scale.py``
    with the triangle kernel and antialiasing), in float32 as JAX
    computes it: equal to JAX's when enlarging, within 2e-6 when
    shrinking (the order of the normalising sum)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))     # Python floats, as JAX
    kernel_scale = max(inv_scale, f32(1.0))      # widen only when shrinking
    # the sample positions in one rounding, as the fused multiply-add of
    # JAX's compiled resize gives them
    sample = ((np.arange(out_size, dtype=f32) + f32(0.5)).astype(np.float64)
              * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)                  # [in, out]
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0.0)).T,
                                dtype=f32)


def resize_bilinear_half_pixel(x: torch.Tensor, out_h: int,
                               out_w: int) -> torch.Tensor:
    """``jax.image.resize(x, (n, out_h, out_w, c), "bilinear")`` (JAX
    ``ops/image.py:69``), [N, H, W, C] -> [N, out_h, out_w, C]; a dim
    whose size does not change is left as it is, as in JAX."""
    _, h, w, _ = x.shape
    if h != out_h:
        mh = torch.from_numpy(_half_pixel_bilinear_matrix(h, out_h))
        x = torch.einsum("oh,nhwc->nowc", mh.to(x.device), x)
    if w != out_w:
        mw = torch.from_numpy(_half_pixel_bilinear_matrix(w, out_w))
        x = torch.einsum("ow,nhwc->nhoc", mw.to(x.device), x)
    return x


@lru_cache(maxsize=64)
def _align_corners_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out_size, in_size] matrix of TF resize_bilinear with
    ``align_corners=True``, src = dst * (in - 1) / (out - 1) (JAX
    ``ops/image.py:77-92``)."""
    if out_size == 1 or in_size == 1:
        m = np.zeros((out_size, in_size), dtype=np.float32)
        m[:, 0] = 1.0
        return m
    scale = (in_size - 1) / (out_size - 1)
    src = np.arange(out_size, dtype=np.float64) * scale
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = src - lo
    m = np.zeros((out_size, in_size), dtype=np.float32)
    m[np.arange(out_size), lo] += (1.0 - frac).astype(np.float32)
    m[np.arange(out_size), hi] += frac.astype(np.float32)
    return m


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """TF resize_bilinear with ``align_corners=True`` (reference
    ``deeplab_v3plus_model.py:533,820``; JAX ``ops/image.py:95-101``) as two
    interpolation matmuls, [N, H, W, C] -> [N, out_h, out_w, C]."""
    mh = torch.from_numpy(_align_corners_matrix(x.shape[1], out_h))
    mw = torch.from_numpy(_align_corners_matrix(x.shape[2], out_w))
    y = torch.einsum("oh,nhwc->nowc", mh.to(x.device), x)
    return torch.einsum("ow,nhwc->nhoc", mw.to(x.device), y)
