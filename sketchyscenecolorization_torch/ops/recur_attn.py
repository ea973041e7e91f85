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

``recur_attn_pixel_lstm`` is the entry point, an autograd function
(``RecurAttnPixelLSTM``, the JAX custom VJP ``pallas_mlstm.py:745-775``).
A CPU tensor goes through the plain PyTorch versions ``recur_attn_plain``
and ``recur_attn_bwd_plain`` (also the kernels' test oracles); a CUDA
tensor goes through ``recur_attn_cuda`` and ``recur_attn_bwd_cuda``, which
launch the hand-written kernels B5 (``csrc/recur_attn_fwd.cu``) and B6
(``csrc/recur_attn_bwd.cu``) of the library ``ops/mlstm.py`` builds, or
raise.  The kernels take w == H (the RecurAttn config sets both to 256), H a
multiple of 64 up to 512 and T <= 16.
"""
from __future__ import annotations

from typing import Optional

import torch

from .lstm import lstm_cell
from .mlstm import check_cuda_tensors, launch, product_splits

MAX_STEPS = 16                    # kMaxT of csrc/recur_attn_*.cu


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


def recur_geometry(hidden: int, t_max: int):
    """(tile, kc, threads, forward shared-memory bytes, sweep shared-memory
    bytes) of ``csrc/recur_attn_fwd.cu`` and the reverse sweep of
    ``csrc/recur_attn_bwd.cu``: a thread owns 2 units of 8 pixels; the
    forward streams Wp in chunks of 4*kc rows and Wm in chunks of kc rows,
    the sweep Wm^T in chunks of kc rows and Wp^T in chunks of 2*kc."""
    if hidden % 64 or not 64 <= hidden <= 512:
        raise ValueError(f"recur_attn_cuda: hidden size {hidden} must be a "
                         "multiple of 64 up to 512")
    if not 0 < t_max <= MAX_STEPS:
        raise ValueError(f"recur_attn_cuda: T={t_max} must be 1..{MAX_STEPS}")
    tile, kc = (16, 8) if hidden <= 256 else (8, 4)
    threads = hidden // 2 * tile // 8
    fwd = 4 * (2 * tile * 2 * hidden + 2 * tile * hidden + t_max * hidden
               + 2 * kc * 4 * hidden)
    sweep = 4 * (tile * 4 * hidden + 2 * kc * 2 * hidden + 3 * tile * hidden
                 + 2 * tile * MAX_STEPS + 2 * t_max * hidden)
    return tile, kc, threads, fwd, sweep


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
    recur_geometry(hidden, t_max)
    return n, p, hidden, t_max


def recur_attn_cuda(h0: torch.Tensor, lang: torch.Tensor, wp: torch.Tensor,
                    bp: torch.Tensor, wm: torch.Tensor, bm: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Launch B5 (``csrc/recur_attn_fwd.cu``) on the current stream: the
    final h [N, P, H].  Takes f32 tensors, int32 ``valid``, contiguous and
    16-byte aligned on one CUDA device; raises on anything else.
    ``recur_attn_cuda.launches`` counts launches."""
    n, p, hidden, t_max = _check("recur_attn_cuda", h0, lang, wp, bp, wm,
                                 bm, valid)
    tile, kc, _, _, _ = recur_geometry(hidden, t_max)
    out = torch.empty_like(h0)
    launch("recur_attn_fwd", h0.device, h0, lang, wp, bp, wm, bm, valid, out,
           n, p, hidden, t_max, tile, kc)
    recur_attn_cuda.launches += 1
    return out


recur_attn_cuda.launches = 0


def recur_attn_bwd_cuda(h0, lang, wp, bp, wm, bm, valid, g: torch.Tensor):
    """Launch B6 (``csrc/recur_attn_bwd.cu``) on the current stream:
    (d_h0, d_lang, d_wp, d_bp, d_wm, d_bm).  Takes what ``recur_attn_cuda``
    takes plus f32 ``g`` [N, P, H]; raises on anything else.  Allocates the
    scratch: the transposed weights, the staged forward (per valid step
    [x, h_prev], c_prev, the gates (overwritten by their gradients),
    h_proj and attn), dh_proj, column sums and the partials of the
    reductions.  ``recur_attn_bwd_cuda.launches`` counts launches."""
    n, p, hidden, t_max = _check("recur_attn_bwd_cuda", h0, lang, wp, bp, wm,
                                 bm, valid, g)
    tile, kc, _, _, _ = recur_geometry(hidden, t_max)
    h2, h4 = 2 * hidden, 4 * hidden
    split_wm = product_splits(p, h2, h4)
    split_wp = product_splits(p, hidden, hidden)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=h0.device)

    grads = (empty(n, p, hidden), empty(n, t_max, hidden),
             empty(hidden, hidden), empty(hidden), empty(h2, h4), empty(h4))
    scratch = (empty(h4, h2), empty(hidden, hidden),        # Wm^T, Wp^T
               empty(n, t_max, p, h2), empty(n, t_max, p, hidden),
               empty(n, t_max, p, h4), empty(n, t_max, p, hidden),
               empty(n, t_max, p, t_max),    # staged [x, h], c, gates, hp, attn
               empty(n, t_max, p, hidden),   # dh_proj
               empty(n, t_max, h4),          # per-step column sums
               empty(n, -(-p // tile), t_max, hidden),     # d_lang partials
               empty(max(split_wm * h2 * h4, split_wp * hidden * hidden)))
    launch("recur_attn_bwd", h0.device, h0, lang, wp, bp, wm, bm, valid, g,
           *grads, *scratch, n, p, hidden, t_max, tile, kc, split_wm,
           split_wp)
    recur_attn_bwd_cuda.launches += 1
    return grads


recur_attn_bwd_cuda.launches = 0


class RecurAttnPixelLSTM(torch.autograd.Function):
    """The RecurAttn recurrence with its BPTT (JAX custom VJP
    ``pallas_mlstm.py:745-775``): forward by ``recur_attn_plain`` (CPU) or
    kernel B5 (CUDA), backward by ``recur_attn_bwd_plain`` (CPU) or kernel
    B6 (CUDA).  ``valid`` gets no gradient; with ``save`` false (serving)
    nothing is kept for the backward."""

    @staticmethod
    def forward(ctx, h0, lang, wp, bp, wm, bm, valid, save):
        args = tuple(x.contiguous() for x in (h0, lang, wp, bp, wm, bm)) \
            + (valid.to(torch.int32).contiguous(),)
        if save:
            ctx.save_for_backward(*args)
        if h0.device.type == "cpu":
            return recur_attn_plain(*args)
        return recur_attn_cuda(*args)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        if args[0].device.type == "cpu":
            grads = recur_attn_bwd_plain(*args, g)
        else:
            grads = recur_attn_bwd_cuda(*args, g.contiguous())
        return (*grads, None, None)


def recur_attn_pixel_lstm(h0: torch.Tensor, lang: torch.Tensor,
                          wp: torch.Tensor, bp: torch.Tensor,
                          wm: torch.Tensor, bm: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """Final h [N, P, H] of the RecurAttn recurrence, differentiable in h0,
    lang, wp, bp, wm and bm (JAX ``recur_attn_pixel_lstm``,
    ``pallas_mlstm.py:746``)."""
    save = torch.is_grad_enabled() and any(
        x.requires_grad for x in (h0, lang, wp, bp, wm, bm))
    return RecurAttnPixelLSTM.apply(h0, lang, wp, bp, wm, bm, valid, save)
