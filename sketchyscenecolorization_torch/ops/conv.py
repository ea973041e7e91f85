"""Convolution primitives with TF SAME padding (``sketchyscenecolorization_tpu/ops/conv.py``).

Activations are NHWC at every public function, as in the JAX package.  An
NHWC-contiguous tensor permuted to NCHW is exactly PyTorch's channels-last
layout, so ``F.conv2d`` runs on it without a copy and its (channels-last)
result permutes back to a contiguous NHWC tensor.

Weights are OIHW (``[out, in, kh, kw]``, PyTorch's layout), except the
transposed conv's, which are ``[in, out, kh, kw]`` as ``F.conv_transpose2d``
takes them; the weight bridge (``utils/bridge.py``) transposes the JAX
package's HWIO kernels to each.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def apply_compute_dtype(*cfgs) -> None:
    """Set the conv/matmul precision of the configs' ``compute_dtype``.
    For "float32", the only value the port takes (bfloat16 is ROADMAP
    A10), cuDNN convolutions and cuBLAS matmuls run in full f32: torch
    lets cuDNN use TF32 by default, whose 10-bit mantissa the f32
    reference does not have.  The flags are process-wide, as the JAX
    package's scope is for its trace."""
    for cfg in cfgs:
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={cfg.compute_dtype!r}: the port computes in "
                "float32 only; bfloat16 is ROADMAP item A10")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def same_pads(size: int, kernel: int, stride: int, rate: int = 1
              ) -> Tuple[int, int]:
    """(before, after) TF SAME padding of one spatial dim.  The dilated
    kernel sets the window (``tf.nn.atrous_conv2d``); an odd total puts the
    extra pixel after (bottom/right), which ``padding=`` in torch cannot
    express (JAX ``ops/conv.py:63-88``)."""
    window = (kernel - 1) * rate + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           rate: int = 1) -> torch.Tensor:
    """SAME conv, x [N, H, W, C] NHWC, w [O, I, kh, kw]; ``rate`` > 1 is
    atrous convolution."""
    ph = same_pads(x.shape[1], w.shape[2], stride, rate)
    pw = same_pads(x.shape[2], w.shape[3], stride, rate)
    xn = x.permute(0, 3, 1, 2)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        y = F.conv2d(xn, w, stride=stride, padding=(ph[0], pw[0]),
                     dilation=rate)
    else:
        y = F.conv2d(F.pad(xn, (pw[0], pw[1], ph[0], ph[1])), w,
                     stride=stride, dilation=rate)
    return y.permute(0, 2, 3, 1)


def pad1_conv4(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Pad 1 on every side, then a 4x4 VALID conv (the BG ``conv()``; JAX
    ``ops/conv.py:96-119``).  At stride 2 on an even size it equals SAME; at
    stride 1 the output is one pixel smaller than the input."""
    if w.shape[2:] != (4, 4):
        raise ValueError(f"pad1_conv4 takes a 4x4 kernel, got {tuple(w.shape)}")
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=1)
    return y.permute(0, 2, 3, 1)


def conv2d_transpose(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """TF's SAME 4x4/2 transposed conv (``tf.nn.conv2d_transpose``; JAX
    ``ops/conv.py:122-156``), x [N, H, W, C] -> [N, 2H, 2W, O]; w
    [in, out, 4, 4], the JAX HWIO kernel transposed by (2, 3, 0, 1).  JAX
    runs it as an input-dilated conv with the flipped kernel and pads
    (2, 2); ``conv_transpose2d`` with padding 1 is the same sum."""
    if w.shape[2:] != (4, 4):
        raise ValueError(f"conv2d_transpose takes a 4x4 kernel, got "
                         f"{tuple(w.shape)}")
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=2, padding=1)
    return y.permute(0, 2, 3, 1)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 SAME max-pool, NHWC (DeepLab stem; JAX ``ops/conv.py:159``)."""
    ph = same_pads(x.shape[1], 3, 2)
    pw = same_pads(x.shape[2], 3, 2)
    xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]),
               value=float("-inf"))
    return F.max_pool2d(xn, 3, 2).permute(0, 2, 3, 1)
