"""Convolution primitives with TF SAME padding (``sketchyscenecolorization_tpu/ops/conv.py``).

Activations are NHWC at every public function, as in the JAX package.  An
NHWC-contiguous tensor permuted to NCHW is exactly PyTorch's channels-last
layout, so ``F.conv2d`` runs on it without a copy and its (channels-last)
result permutes back to a contiguous NHWC tensor.

Weights are OIHW (``[out, in, kh, kw]``, PyTorch's layout), except the
transposed conv's, which are ``[in, out, kh, kw]`` as ``F.conv_transpose2d``
takes them; the weight bridge (``utils/bridge.py``) transposes the JAX
package's HWIO kernels to each.

The compute-dtype scope (JAX ``ops/conv.py:38-60``): inside
``compute_dtype_scope("bfloat16")`` the three convolutions below cast both
operands to bfloat16 and return bfloat16.  cuDNN accumulates a bf16
convolution in f32 and rounds once at the output, as JAX's
``preferred_element_type=bf16`` does.  Everything else keeps its dtype
rules, so a bf16 conv output plus an f32 bias vector is f32 again, as in
JAX.  The scope is opened per call (around an engine's forward, and in
``RMI.extract_visual``) and is local to the thread, so engines of both
dtypes can serve side by side.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_SCOPE = threading.local()


@contextlib.contextmanager
def compute_dtype_scope(dtype):
    """``with compute_dtype_scope("bfloat16"): ...``; ``dtype`` may be None,
    "float32", "bfloat16" or a torch dtype, and None / float32 store f32.
    The previous scope is restored on exit."""
    if dtype in (None, "float32", torch.float32):
        dtype = None
    elif dtype in ("bfloat16", torch.bfloat16):
        dtype = torch.bfloat16
    else:
        raise ValueError(f"unknown compute dtype {dtype!r}")
    prev = scope_dtype()
    _SCOPE.dtype = dtype
    try:
        yield
    finally:
        _SCOPE.dtype = prev


def scope_dtype() -> Optional[torch.dtype]:
    """The storage dtype of the open scope, None for float32."""
    return getattr(_SCOPE, "dtype", None)


def _cast(x: torch.Tensor, w: torch.Tensor):
    dtype = scope_dtype()
    if dtype is None:
        return x, w
    return x.to(dtype), w.to(dtype)


def apply_compute_dtype(*cfgs) -> None:
    """Check the configs' ``compute_dtype`` and make their f32 parts true
    f32: torch lets cuDNN use TF32 by default, whose 10-bit mantissa the
    f32 reference does not have, so cuDNN convolutions and cuBLAS matmuls
    are set to full f32.  The flags are process-wide.  A bfloat16 config
    needs them too: its text fusions, heads and the convolutions that do
    not read the scope stay f32 (JAX ``gan_layers.py:182-185``,
    ``backbones.py:271-296``); its bf16 convolutions open
    ``compute_dtype_scope`` where the engines and ``RMI.extract_visual``
    run them."""
    for cfg in cfgs:
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: expected "
                             "'float32' or 'bfloat16'")
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
    x, w = _cast(x, w)
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
    x, w = _cast(x, w)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=1)
    return y.permute(0, 2, 3, 1)


def conv2d_transpose(x: torch.Tensor, w: torch.Tensor,
                     stride: int = 2) -> torch.Tensor:
    """TF's SAME transposed conv (``tf.nn.conv2d_transpose``; JAX
    ``ops/conv.py:120-157``), x [N, H, W, C] -> [N, stride H, stride W, O];
    w [in, out, k, k], the JAX HWIO kernel transposed by (2, 3, 0, 1).  JAX
    runs it as an input-dilated conv with the flipped kernel, padded
    (k - 1 - lo, k - 1 - hi) with lo = (k - stride) // 2;
    ``conv_transpose2d`` with padding lo is the same sum when k - stride
    is even (4/2 in the GANs and FCN-8s, 16/8 in FCN-8s' full head)."""
    k = w.shape[2]
    if w.shape[3] != k or (k - stride) % 2 or k < stride:
        raise ValueError(f"conv2d_transpose takes a square kernel with an "
                         f"even k - stride, got {tuple(w.shape)} at stride "
                         f"{stride}")
    x, w = _cast(x, w)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=stride,
                           padding=(k - stride) // 2)
    return y.permute(0, 2, 3, 1)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 SAME max-pool, NHWC (DeepLab stem; JAX ``ops/conv.py:159``)."""
    ph = same_pads(x.shape[1], 3, 2)
    pw = same_pads(x.shape[2], 3, 2)
    xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]),
               value=float("-inf"))
    return F.max_pool2d(xn, 3, 2).permute(0, 2, 3, 1)
