"""RecurAttn recurrence: the LBIE-style recurrent-attention fusion of the
RMI model (``sketchyscenecolorization_tpu/ops/pallas_mlstm.py:430-775``;
reference ``RMI_model.py:224-273``).  Per pixel, h starts at the visual
feature h0 and each kept word step runs

    h_proj = h @ Wp + bp                                  [w]
    attn   = softmax over ALL T of h_proj . lang[t]       [T]  (not masked)
    x      = attn @ lang                                  [w]
    gates  = [x, h] @ Wm + bm                             [4H]
    c, h   = LSTM(gates, c)        (TF BasicLSTMCell, forget_bias 1)

with c and h frozen wherever ``valid`` (``words != 0``) is 0.  ``lang`` is
the raw word-LSTM output [N, T, w]; the rows of ``Wm`` [w + H, 4H] are
[attended x; h], in that order.

``recur_attn_pixel_lstm`` is the entry point, through the autograd function
``ops/mlstm.py:PixelLSTM`` (the JAX custom VJP ``pallas_mlstm.py:745-775``).
A CPU tensor goes through the plain PyTorch versions ``recur_attn_plain``
and ``recur_attn_bwd_plain`` (also the kernels' test oracles); a CUDA
tensor goes through ``recur_attn_cuda`` and ``recur_attn_bwd_cuda``, which
launch the hand-written kernels B5 (``csrc/recur_attn_fwd.cu``) and B6
(``csrc/recur_attn_bwd.cu``) of the library ``ops/mlstm.py`` builds, or
raise.  Both run their products on the tensor cores (B5 is B6's staging
forward, the kernels of ``csrc/recur_tc.cuh``, without the stores) and take
w == H (the RecurAttn config sets both to 256), any H (padded inside to Hp,
a multiple of 128) and any T whose lang[n] fits in shared memory
(``recur_geometry``, ``recur_bwd_geometry``); T is never padded, since the
softmax runs over all T.
"""
from __future__ import annotations

from typing import Optional

import torch

from .lstm import lstm_cell
from .mlstm import (BWD_BK, SMEM_BYTES, check_cuda_tensors, launch,
                    padded_hidden, pixel_lstm, rows_product_splits)

# csrc/recur_attn_bwd.cu: the bias sums add the staged rows in this many
# chunks at most, each chunk at least COL_ROWS rows
COL_CHUNKS, COL_ROWS = 512, 512
SOFTMAX_WARPS = 8   # warps of F2 (csrc/recur_tc.cuh), one pixel row each


def recur_attn_plain(h0: torch.Tensor,      # [N, P, H] f32
                     lang: torch.Tensor,    # [N, T, w] f32
                     wp: torch.Tensor,      # [H, w] f32
                     bp: torch.Tensor,      # [w] f32
                     wm: torch.Tensor,      # [w + H, 4H] f32
                     bm: torch.Tensor,      # [4H] f32
                     valid: torch.Tensor,   # [N, T] bool/int
                     stages: Optional[list] = None) -> torch.Tensor:
    """Plain PyTorch recurrence (``recur_attn_scan``, JAX
    ``pallas_mlstm.py:528-551``); returns the final h [N, P, H].  A list
    passed as ``stages`` receives (h, c, h_proj, attn, x) of each step."""
    keep = valid.bool()
    h = h0
    c = torch.zeros_like(h0)
    lang_t = lang.transpose(1, 2)                             # [N, w, T]
    for t in range(lang.shape[1]):
        h_proj = torch.matmul(h, wp) + bp                     # [N, P, w]
        attn = torch.softmax(torch.matmul(h_proj, lang_t), dim=-1)
        x = torch.matmul(attn, lang)                          # [N, P, w]
        if stages is not None:
            stages.append((h, c, h_proj, attn, x))
        gates = torch.matmul(torch.cat([x, h], dim=-1), wm) + bm
        new_c, new_h = lstm_cell(gates, c)
        k = keep[:, t, None, None]
        c = torch.where(k, new_c, c)
        h = torch.where(k, new_h, h)
    return h


def recur_attn_bwd_plain(h0, lang, wp, bp, wm, bm, valid,
                         g: torch.Tensor):   # [N, P, H] dL/dh_final
    """Plain PyTorch BPTT of ``recur_attn_plain``: the algebra of the TPU
    kernel ``_recur_attn_bwd_kernel`` (JAX ``pallas_mlstm.py:554-664``).
    Returns (d_h0 [N, P, H], d_lang [N, T, w], d_wp, d_bp, d_wm, d_bm)."""
    hidden, w = h0.shape[-1], lang.shape[-1]
    keep = valid.bool()
    stages = []
    recur_attn_plain(h0, lang, wp, bp, wm, bm, valid, stages)
    wm_a, wm_h = wm[:w], wm[w:]
    d_lang = torch.zeros_like(lang)
    d_wp, d_bp = torch.zeros_like(wp), torch.zeros_like(bp)
    d_wm, d_bm = torch.zeros_like(wm), torch.zeros_like(bm)
    dh = g
    dc = torch.zeros_like(g)
    for t in range(len(stages) - 1, -1, -1):
        k = keep[:, t, None, None]
        h_prev, c_prev, h_proj, attn, x = stages[t]
        gates = torch.matmul(torch.cat([x, h_prev], dim=-1), wm) + bm
        i, j, f, o = torch.chunk(gates, 4, dim=-1)
        si, tj = torch.sigmoid(i), torch.tanh(j)
        sf, so = torch.sigmoid(f + 1.0), torch.sigmoid(o)
        tc = torch.tanh(c_prev * sf + si * tj)
        d_o = dh * tc * so * (1.0 - so)
        dct = dc + dh * so * (1.0 - tc * tc)
        d_f = dct * c_prev * sf * (1.0 - sf)
        d_i = dct * tj * si * (1.0 - si)
        d_j = dct * si * (1.0 - tj * tj)
        dgates = torch.where(k, torch.cat([d_i, d_j, d_f, d_o], dim=-1), 0.0)
        dx = torch.matmul(dgates, wm_a.T)                     # [N, P, w]
        dattn = torch.matmul(dx, lang.transpose(1, 2))        # [N, P, T]
        dlogits = attn * (dattn - (dattn * attn).sum(-1, keepdim=True))
        dhp = torch.matmul(dlogits, lang)                     # [N, P, w]
        flat = dgates.reshape(-1, 4 * hidden)
        d_wm[:w] += torch.matmul(x.reshape(-1, w).T, flat)
        d_wm[w:] += torch.matmul(h_prev.reshape(-1, hidden).T, flat)
        d_bm += flat.sum(0)
        d_wp += torch.matmul(h_prev.reshape(-1, hidden).T, dhp.reshape(-1, w))
        d_bp += dhp.reshape(-1, w).sum(0)
        d_lang += torch.matmul(attn.transpose(1, 2), dx) \
            + torch.matmul(dlogits.transpose(1, 2), h_proj)
        dh = torch.where(k, torch.matmul(dhp, wp.T)
                         + torch.matmul(dgates, wm_h.T), dh)
        dc = torch.where(k, dct * sf, dc)
    return dh, d_lang, d_wp, d_bp, d_wm, d_bm


def recur_geometry(rows: int, hidden: int, t_max: int):
    """(Hp, shared-memory bytes of F2) of B5 (``csrc/recur_attn_fwd.cu``)
    for ``rows`` = N*P pixel rows: H padded to Hp, a multiple of 128; F2
    holds lang[n] [T, Hp] and, for each of its 8 warps, an h_proj row and
    its T logits.  Raises on a T whose shared memory does not fit (T <= 212
    at H = 256, T <= 103 at H = 512) and on more than 65535 tiles of 64
    rows."""
    if hidden <= 0 or t_max <= 0:
        raise ValueError(f"recur_attn_cuda: H={hidden} and T={t_max} must be "
                         "positive")
    if not 0 < rows <= 65535 * 64:
        raise ValueError(f"recur_attn_cuda: {rows} pixel rows (N*P) must be "
                         f"between 1 and {65535 * 64}")
    hp = padded_hidden(hidden)
    smem = 4 * (t_max * hp + SOFTMAX_WARPS * (hp + t_max))
    if smem > SMEM_BYTES:
        raise ValueError(
            f"recur_attn_cuda: T={t_max} must be 1.."
            f"{(SMEM_BYTES // 4 - SOFTMAX_WARPS * hp) // (hp + SOFTMAX_WARPS)}"
            f" at Hp={hp} (lang[n] in shared memory)")
    return hp, smem


def recur_bwd_geometry(rows: int, hidden: int, t_max: int):
    """(Hp, d_Wm splits, d_Wp splits, attention rows, bias-sum chunks,
    shared-memory bytes of the attention backward) of B6
    (``csrc/recur_attn_bwd.cu``) for ``rows`` = N*P pixel rows: H padded to
    Hp, a multiple of 128; the K splits of its two weight-gradient products
    (``rows_product_splits``); the pixel rows of one block of its attention
    kernels (32, or fewer where lang[n] [T, Hp], their dx and h_proj rows
    and their attn and dlogits do not fit in shared memory); the row chunks
    of its bias sums.  Raises on a T whose shared memory does not fit even
    at 8 rows (T <= 198 at H = 256), and on more than 65535 tiles of 64
    rows or 2^31 staged rows."""
    if hidden <= 0 or t_max <= 0:
        raise ValueError(f"recur_attn_bwd_cuda: H={hidden} and T={t_max} "
                         "must be positive")
    hp = padded_hidden(hidden)
    splits = (rows_product_splits(rows, 2 * hp, 4 * hp),
              rows_product_splits(rows, hp, hp, cap=32))
    if not 0 < rows <= 65535 * 64 or \
            rows * t_max + BWD_BK * sum(splits) >= 2 ** 31:
        raise ValueError(f"recur_attn_bwd_cuda: {rows} pixel rows (N*P) at "
                         f"T={t_max} do not fit")
    for attn_rows in (32, 16, 8):
        smem = 4 * (t_max * hp + 2 * attn_rows * (hp + t_max))
        if smem <= SMEM_BYTES:
            break
    else:
        raise ValueError(
            f"recur_attn_bwd_cuda: T={t_max} must be 1.."
            f"{(SMEM_BYTES // 4 - 16 * hp) // (hp + 16)} at Hp={hp} (lang[n] "
            "in shared memory)")
    chunks = max(1, min(COL_CHUNKS, rows * t_max // COL_ROWS))
    return (hp, *splits, attn_rows, chunks, smem)


def _check(name, h0, lang, wp, bp, wm, bm, valid, g=None):
    """Checks of the kernel wrappers; returns (N, P, H, T)."""
    check_cuda_tensors(name, (h0, lang, wp, bp, wm, bm)
                       + (() if g is None else (g,)), (valid,))
    if h0.dim() != 3 or lang.dim() != 3:
        raise ValueError(f"{name}: expected h0 [N,P,H], lang [N,T,w]")
    n, p, hidden = h0.shape
    t_max, w = lang.shape[1], lang.shape[2]
    if (lang.shape[0] != n or w != hidden or wp.shape != (hidden, w)
            or bp.shape != (w,) or wm.shape != (w + hidden, 4 * hidden)
            or bm.shape != (4 * hidden,) or valid.shape != (n, t_max)
            or (g is not None and g.shape != (n, p, hidden))):
        raise ValueError(
            f"{name}: shapes h0 {tuple(h0.shape)}, lang {tuple(lang.shape)}, "
            f"wp {tuple(wp.shape)}, bp {tuple(bp.shape)}, wm "
            f"{tuple(wm.shape)}, bm {tuple(bm.shape)}, valid "
            f"{tuple(valid.shape)} (the kernels take w == H)")
    if min(n, p) == 0 or n > 65535:
        raise ValueError(f"{name}: unsupported sizes N={n} P={p}")
    return n, p, hidden, t_max


def recur_attn_cuda(h0: torch.Tensor, lang: torch.Tensor, wp: torch.Tensor,
                    bp: torch.Tensor, wm: torch.Tensor, bm: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Launch B5 (``csrc/recur_attn_fwd.cu``) on the current stream: the
    final h [N, P, H].  Takes f32 tensors, int32 ``valid``, contiguous and
    16-byte aligned on one CUDA device, any H and a T up to
    ``recur_geometry``'s limit; raises on anything else.  Allocates the
    scratch of H padded to Hp: the permuted Wm, padded Wp and lang, the slot
    table, and the running [x, h] [2, N*P, 2Hp], c [2, N*P, Hp] and h_proj
    [N*P, Hp].  Never synchronises with the host.
    ``recur_attn_cuda.launches`` counts launches."""
    n, p, hidden, t_max = _check("recur_attn_cuda", h0, lang, wp, bp, wm,
                                 bm, valid)
    rows = n * p
    hp, _ = recur_geometry(rows, hidden, t_max)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=h0.device)

    out = torch.empty_like(h0)
    launch("recur_attn_fwd", h0.device, h0, lang, wp, bp, wm, bm, valid, out,
           empty(2 * hp, 4 * hp), empty(hp, hp), empty(n, t_max, hp),
           empty(n * t_max + 2, dtype=torch.int32), empty(2, rows, 2 * hp),
           empty(2, rows, hp), empty(rows, hp), n, p, hidden, t_max, hp)
    recur_attn_cuda.launches += 1
    return out


recur_attn_cuda.launches = 0


def recur_attn_bwd_cuda(h0, lang, wp, bp, wm, bm, valid, g: torch.Tensor):
    """Launch B6 (``csrc/recur_attn_bwd.cu``) on the current stream: (d_h0,
    d_lang, d_wp, d_bp, d_wm, d_bm).  Takes what ``recur_attn_cuda`` takes
    (but a T up to ``recur_bwd_geometry``'s limit) plus f32 ``g``
    [N, P, H]; raises on anything else.  Allocates the scratch of H padded
    to Hp: the permuted Wm, padded Wp and lang, the slot table, the staged
    forward ([x, h] [T, N*P, 2Hp]; c, h_proj and dh_proj [T, N*P, Hp]; the
    gates, overwritten by their gradients, [T, N*P, 4Hp]; attn
    [T, N*P, T]), dx and dc [N*P, Hp], the d_lang partials and the partials
    of the weight and bias sums.  Never synchronises with the host.
    ``recur_attn_bwd_cuda.launches`` counts launches."""
    n, p, hidden, t_max = _check("recur_attn_bwd_cuda", h0, lang, wp, bp, wm,
                                 bm, valid, g)
    rows = n * p
    hp, split_wm, split_wp, attn_rows, chunks, _ = recur_bwd_geometry(
        rows, hidden, t_max)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=h0.device)

    grads = (empty(n, p, hidden), empty(n, t_max, hidden),
             empty(hidden, hidden), empty(hidden), empty(2 * hidden,
                                                         4 * hidden),
             empty(4 * hidden))
    scratch = (empty(2 * hp, 4 * hp), empty(hp, hp),   # Wm permuted, Wp
               empty(n, t_max, hp),                    # lang padded
               empty(n * t_max + 2, dtype=torch.int32),          # slots
               empty(t_max, rows, 2 * hp), empty(t_max, rows, hp),
               empty(t_max, rows, 4 * hp), empty(t_max, rows, hp),
               empty(t_max, rows, t_max),     # staged [x, h], c, gates, hp,
               empty(t_max, rows, hp),        # attn, dhp
               empty(rows, hp), empty(rows, hp),                 # dx, dc
               empty(n, -(-p // attn_rows), t_max, hp),          # d_lang
               empty(max(split_wm * 8 * hp * hp, split_wp * hp * hp,
                         chunks * 4 * hidden)))
    launch("recur_attn_bwd", h0.device, h0, lang, wp, bp, wm, bm, valid, g,
           *grads, *scratch, n, p, hidden, t_max, hp, split_wm, split_wp,
           attn_rows, chunks)
    recur_attn_bwd_cuda.launches += 1
    return grads


recur_attn_bwd_cuda.launches = 0


def recur_attn_forward(h0, lang, wp, bp, wm, bm, valid):
    """B5 (``recur_attn_cuda``) on CUDA tensors, ``recur_attn_plain`` on
    CPU ones; f32 operands and int32 ``valid``, contiguous."""
    if h0.device.type == "cpu":
        return recur_attn_plain(h0, lang, wp, bp, wm, bm, valid)
    return recur_attn_cuda(h0, lang, wp, bp, wm, bm, valid)


def recur_attn_backward(h0, lang, wp, bp, wm, bm, valid, g):
    """(d_h0, d_lang, d_wp, d_bp, d_wm, d_bm) by B6
    (``recur_attn_bwd_cuda``) on CUDA tensors, ``recur_attn_bwd_plain``
    on CPU ones."""
    if h0.device.type == "cpu":
        return recur_attn_bwd_plain(h0, lang, wp, bp, wm, bm, valid, g)
    return recur_attn_bwd_cuda(h0, lang, wp, bp, wm, bm, valid,
                               g.contiguous())


RECUR_ATTN_KERNELS = (recur_attn_forward, recur_attn_backward,
                      (0, 1, 2, 3, 4, 5))


def recur_attn_pixel_lstm(h0: torch.Tensor, lang: torch.Tensor,
                          wp: torch.Tensor, bp: torch.Tensor,
                          wm: torch.Tensor, bm: torch.Tensor,
                          valid: torch.Tensor, mesh=None) -> torch.Tensor:
    """Final h [N, P, H] of the RecurAttn recurrence, differentiable in h0,
    lang, wp, bp, wm and bm (JAX ``recur_attn_pixel_lstm``,
    ``pallas_mlstm.py:746``, whose custom VJP is :745-775); pixels sharded
    over ``mesh``'s 'model' axis when a mesh is given
    (``ops/mlstm.py:PixelLSTM``)."""
    return pixel_lstm(RECUR_ATTN_KERNELS, mesh, h0, lang, wp, bp, wm, bm,
                      valid)
