"""Masked pixel-LSTM: the recurrence of the RMI fusion and of the FG/BG
text-fusion LSTMs (``sketchyscenecolorization_tpu/ops/pallas_mlstm.py``).

After the input projection is factored (``models/rmi.py``), one step is

    gates[p] = pixel_term[p] + step_term[t] + h[p] @ W_h
    c, h     = LSTM(gates, c)        (TF BasicLSTMCell, forget_bias 1)

with c and h frozen wherever the per-(batch, step) flag ``valid`` is 0.

Two entry points, both through the autograd function ``PixelLSTM``,
which also shards the pixels over a mesh's 'model' axis:
- ``masked_pixel_lstm`` (the JAX custom VJP ``pallas_mlstm.py:936-970``)
  returns the final h;
- ``attn_weighted_pixel_lstm`` (JAX ``pallas_mlstm.py:244-276``), the
  word-attention variant, returns ``acc = sum_t attn[n, t] * h_t`` over
  the kept steps, and its backward also gives d_attn.

A CPU tensor goes through the plain PyTorch versions (``mlstm_plain``,
``mlstm_bwd_plain``, ``mlstm_attn_plain``, ``mlstm_attn_bwd_plain``: the
same functions as Python loops of ``torch.matmul``, also the kernels' test
oracles); a CUDA tensor goes through ``mlstm_cuda``, ``mlstm_bwd_cuda``,
``mlstm_attn_cuda`` and ``mlstm_attn_bwd_cuda``, which launch the
hand-written kernels B1 and B3 (``csrc/mlstm_fwd.cu``) and B2 and B4
(``csrc/mlstm_bwd.cu``) or raise.  All four run on the tensor cores through
``csrc/lstm_tc.cuh`` (B1 and B3 are two modes of B2's staging kernel) and
take any H, padded inside to Hp, a multiple of 128, which is exact: a
padded unit's gates are 0, so its c and h stay 0.

This module also builds and loads the one kernel library of the port:
``SOURCES`` (these two files and the RecurAttn kernels B5 and B6 of
``ops/recur_attn.py``) are compiled for sm_90a, one ``nvcc`` per source,
into ``build/kernels/`` at the repository root on first use and bound with
``ctypes``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import torch
import torch.distributed as dist

from .lstm import lstm_cell

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(os.path.join(_PKG_DIR, "csrc", name)
                for name in ("mlstm_fwd.cu", "mlstm_bwd.cu",
                             "recur_attn_fwd.cu", "recur_attn_bwd.cu"))
HEADERS = tuple(os.path.join(_PKG_DIR, "csrc", name)
                for name in ("common.cuh", "lstm_tc.cuh", "recur_tc.cuh"))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
LIBRARY = os.path.join(BUILD_DIR, "libmlstm.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]

SMEM_BYTES = 232448               # shared memory a block may use on sm_90
SMS = 132                         # streaming multiprocessors of an H100
# csrc/lstm_tc.cuh: hidden size padded to a multiple of BWD_PAD; its
# products stage K BWD_BK deep; B4's d_attn partials cover ATTN_ROWS pixel
# rows each
BWD_PAD, BWD_BK, ATTN_ROWS = 128, 32, 64

_lib = None
_lib_lock = threading.Lock()


def _fwd_plain(pixel_term, step_term, w_h, valid, attn=None, stages=None):
    """The recurrence; returns the final h, or with ``attn`` the sum of
    attn[n, t] * h_t over the kept steps.  A list passed as ``stages``
    receives (h, c) before each step."""
    n, p, four_h = pixel_term.shape
    hidden = four_h // 4
    keep = valid.bool()
    c = pixel_term.new_zeros((n, p, hidden))
    h = pixel_term.new_zeros((n, p, hidden))
    acc = None if attn is None else pixel_term.new_zeros((n, p, hidden))
    for t in range(step_term.shape[1]):
        if stages is not None:
            stages.append((h, c))
        gates = pixel_term + step_term[:, t, None, :] + torch.matmul(h, w_h)
        new_c, new_h = lstm_cell(gates, c)
        k = keep[:, t, None, None]
        c = torch.where(k, new_c, c)
        h = torch.where(k, new_h, h)
        if attn is not None:
            acc = acc + torch.where(k, attn[:, t, None, None] * h, 0.0)
    return h if attn is None else acc


def mlstm_plain(pixel_term: torch.Tensor,   # [N, P, 4H] f32
                step_term: torch.Tensor,    # [N, T, 4H] f32
                w_h: torch.Tensor,          # [H, 4H] f32
                valid: torch.Tensor,        # [N, T] bool/int
                stages: Optional[list] = None) -> torch.Tensor:
    """Plain PyTorch recurrence (``mlstm_scan``, JAX
    ``pallas_mlstm.py:118-140``); returns the final h [N, P, H].  A list
    passed as ``stages`` receives (h, c) before each step."""
    return _fwd_plain(pixel_term, step_term, w_h, valid, stages=stages)


def mlstm_attn_plain(pixel_term: torch.Tensor,   # [N, P, 4H] f32
                     step_term: torch.Tensor,    # [N, T, 4H] f32
                     w_h: torch.Tensor,          # [H, 4H] f32
                     valid: torch.Tensor,        # [N, T] bool/int
                     attn: torch.Tensor,         # [N, T] f32
                     ) -> torch.Tensor:
    """Plain PyTorch word-attention recurrence (``mlstm_attn_scan``, JAX
    ``pallas_mlstm.py:216-241``): acc [N, P, H] = the sum over kept steps
    of attn[n, t] times the step's new h."""
    return _fwd_plain(pixel_term, step_term, w_h, valid, attn=attn)


def _bwd_plain(pixel_term, step_term, w_h, valid, g, attn=None):
    """BPTT of ``_fwd_plain``: the algebra of the TPU kernels
    ``_mlstm_bwd_kernel`` (``g`` is dL/dh_final) and, with ``attn``,
    ``_mlstm_attn_bwd_kernel`` (``g`` is dL/dacc: dh starts at 0 and gains
    attn[n, t] * g at every kept step, and d_attn[n, t] = <g, h_t>)."""
    n, _, four_h = pixel_term.shape
    hidden = four_h // 4
    keep = valid.bool()
    stages = []
    _fwd_plain(pixel_term, step_term, w_h, valid, stages=stages)
    d_pixel = torch.zeros_like(pixel_term)
    d_step = torch.zeros_like(step_term)
    d_w_h = torch.zeros_like(w_h)
    d_attn = None if attn is None else torch.zeros_like(attn)
    dh = g if attn is None else torch.zeros_like(g)
    dc = torch.zeros_like(g)
    for t in range(len(stages) - 1, -1, -1):
        k = keep[:, t, None, None]
        h_prev, c_prev = stages[t]
        gates = pixel_term + step_term[:, t, None, :] \
            + torch.matmul(h_prev, w_h)
        i, j, f, o = torch.chunk(gates, 4, dim=-1)
        si, tj = torch.sigmoid(i), torch.tanh(j)
        sf, so = torch.sigmoid(f + 1.0), torch.sigmoid(o)
        tc = torch.tanh(c_prev * sf + si * tj)
        if attn is not None:
            h_t = so * tc                     # the step's new h, if kept
            d_attn[:, t] = torch.where(keep[:, t],
                                       (g * h_t).reshape(n, -1).sum(1), 0.0)
            dh = dh + torch.where(k, attn[:, t, None, None] * g, 0.0)
        d_o = dh * tc * so * (1.0 - so)
        dct = dc + dh * so * (1.0 - tc * tc)
        d_f = dct * c_prev * sf * (1.0 - sf)
        d_i = dct * tj * si * (1.0 - si)
        d_j = dct * si * (1.0 - tj * tj)
        dgates = torch.where(k, torch.cat([d_i, d_j, d_f, d_o], dim=-1), 0.0)
        d_pixel += dgates
        d_step[:, t] = dgates.sum(dim=1)
        d_w_h += torch.matmul(h_prev.reshape(-1, hidden).T,
                              dgates.reshape(-1, four_h))
        dh = torch.where(k, torch.matmul(dgates, w_h.T), dh)
        dc = torch.where(k, dct * sf, dc)
    if attn is None:
        return d_pixel, d_step, d_w_h
    return d_pixel, d_step, d_w_h, d_attn


def mlstm_bwd_plain(pixel_term: torch.Tensor,   # [N, P, 4H] f32
                    step_term: torch.Tensor,    # [N, T, 4H] f32
                    w_h: torch.Tensor,          # [H, 4H] f32
                    valid: torch.Tensor,        # [N, T] bool/int
                    g: torch.Tensor,            # [N, P, H] dL/dh_final
                    ):
    """Plain PyTorch BPTT of ``mlstm_plain``: the algebra of the TPU kernel
    ``_mlstm_bwd_kernel`` (JAX ``pallas_mlstm.py:778-862``).  Returns
    (d_pixel [N, P, 4H], d_step [N, T, 4H], d_w_h [H, 4H])."""
    return _bwd_plain(pixel_term, step_term, w_h, valid, g)


def mlstm_attn_bwd_plain(pixel_term: torch.Tensor,   # [N, P, 4H] f32
                         step_term: torch.Tensor,    # [N, T, 4H] f32
                         w_h: torch.Tensor,          # [H, 4H] f32
                         valid: torch.Tensor,        # [N, T] bool/int
                         attn: torch.Tensor,         # [N, T] f32
                         g: torch.Tensor,            # [N, P, H] dL/dacc
                         ):
    """Plain PyTorch BPTT of ``mlstm_attn_plain``: the algebra of the TPU
    kernel ``_mlstm_attn_bwd_kernel`` (JAX ``pallas_mlstm.py:279-360``).
    Returns (d_pixel, d_step, d_w_h, d_attn [N, T])."""
    return _bwd_plain(pixel_term, step_term, w_h, valid, g, attn=attn)


def padded_hidden(hidden: int) -> int:
    """Hp: H rounded up to a multiple of BWD_PAD, the width the kernels pad
    the hidden units to."""
    return -(-hidden // BWD_PAD) * BWD_PAD


def product_smem(bm: int, bn: int, a_outer: bool, b_outer: bool,
                 stages: int) -> int:
    """Dynamic shared memory of one 3xTF32 product block of
    ``csrc/mlstm_bwd.cu`` (``Tile``): ``stages`` cp.async stages of the A
    and B slices (stored [k][m] when ``*_outer``, else [m][k], rows padded
    against bank conflicts), or the [bm, bn + 8] accumulator tile if
    larger, plus two ints per row."""
    def operand(width, outer):
        return BWD_BK * (width + 8) if outer else width * (BWD_BK + 4)
    stage = operand(bm, a_outer) + operand(bn, b_outer)
    return 4 * (max(stages * stage, bm * (bn + 8)) + 2 * bm)


# (rows, columns, A stored [k][m], B stored [k][n], stages) of the three
# products of csrc/mlstm_bwd.cu: staging forward, sweep, d_W_h, and how many
# blocks of each share an SM
BWD_TILES = ((128, 128, False, True, 3), (64, 64, False, False, 3),
             (128, 128, True, True, 3))
BWD_BLOCKS_PER_SM = (2, 3, 2)


def fwd_geometry(rows: int, hidden: int):
    """(Hp, shared-memory bytes) of B1 and B3 (``csrc/mlstm_fwd.cu``, the
    tensor-core launch sequence of ``csrc/lstm_tc.cuh``) for ``rows`` = N*P
    pixel rows: H padded to Hp, a multiple of 128, and the staging tile's
    shared memory.  Raises on more than 65535 tiles of 128 rows."""
    if hidden <= 0:
        raise ValueError(f"mlstm_cuda: hidden size {hidden} must be positive")
    if not 0 < rows <= 65535 * 128:
        raise ValueError(f"mlstm_cuda: {rows} pixel rows (N*P) must be "
                         f"between 1 and {65535 * 128}")
    return padded_hidden(hidden), product_smem(*BWD_TILES[0])


def rows_product_splits(rows: int, width_a: int, width_b: int,
                        cap: int = 16) -> int:
    """K ranges of the split-K sum-of-outer-products ``lstm_rows_product_
    kernel`` (``csrc/lstm_tc.cuh``) for a [width_a, width_b] output over
    ``rows`` = N*P pixel rows per slot: as many as fill the card in one wave
    of its 128x128 tiles, at most ``cap`` and one per 64 rows."""
    tiles = (width_a // 128) * (width_b // 128)
    return max(1, min(BWD_BLOCKS_PER_SM[2] * SMS // tiles, cap, rows // 64))


def bwd_geometry(rows: int, hidden: int):
    """(Hp, splits, shared-memory bytes) of the backward kernel
    (``csrc/mlstm_bwd.cu``) for ``rows`` = N*P pixel rows: H padded to Hp, a
    multiple of 128; the d_W_h product's K split into ``splits`` ranges
    (as many blocks as fit on the card in one wave with its 128x128 tiles;
    at most 16 and one per 64 rows); the largest dynamic shared memory of
    its three products (BWD_TILES).  Raises on more than 65535 tiles of 64
    rows."""
    if hidden <= 0:
        raise ValueError(f"mlstm_bwd_cuda: hidden size {hidden} must be "
                         "positive")
    if not 0 < rows <= 65535 * 64:
        raise ValueError(f"mlstm_bwd_cuda: {rows} pixel rows (N*P) must be "
                         f"between 1 and {65535 * 64}")
    hp = padded_hidden(hidden)
    return hp, rows_product_splits(rows, hp, 4 * hp), \
        max(product_smem(*tile) for tile in BWD_TILES)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, keeping 10 mantissa bits (the low 13 bits zero); inf
    and NaN pass through.  The kernels' arithmetic, for tests."""
    bits = x.contiguous().view(torch.int32)
    special = (bits & 0x7F800000) == 0x7F800000
    rounded = (bits + 0x1000) & ~0x1FFF     # the sign bit is never reached
    return torch.where(special, bits, rounded).view(torch.float32)


def matmul_3xtf32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the backward kernel's tensor-core products compute it: each
    f32 operand split into big = tf32(x) and small = tf32(x - big), and
    small@big + big@small + big@big summed in f32 (the products of two TF32
    values are exact in f32).  For tests."""
    a_big, b_big = tf32_round(a), tf32_round(b)
    a_small, b_small = tf32_round(a - a_big), tf32_round(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def build() -> str:
    """Compile ``SOURCES`` for sm_90a, one ``nvcc`` per source, all started
    together, and link them into one library (unless it is newer than every
    source and header); return nvcc's report (registers, spills)."""
    if os.path.isfile(LIBRARY) and os.path.getmtime(LIBRARY) >= max(
            os.path.getmtime(src) for src in SOURCES + HEADERS):
        return ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [os.path.join(tmp, os.path.basename(src) + ".o")
                   for src in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objects)]
        report = ""
        for src, proc in zip(SOURCES, procs):
            out = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
            report += out
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib,
                               *objects], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed linking {objects}:\n"
                               f"{proc.stderr}")
        os.replace(lib, LIBRARY)   # atomic: a concurrent build never sees
    return report                  # a half-written library


# C entry points of the library: (number of pointer arguments, number of
# int arguments); each then takes the stream and returns a cudaError_t.
_ENTRIES = {"mlstm_fwd": (8, 5), "mlstm_attn_fwd": (9, 5),
            "mlstm_bwd": (15, 6), "mlstm_attn_bwd": (18, 6),
            "recur_attn_fwd": (15, 5), "recur_attn_bwd": (28, 9)}


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIBRARY)
            for name, (n_ptr, n_int) in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p] * n_ptr + \
                    [ctypes.c_int] * n_int + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(name: str, device, *args) -> None:
    """Call the library's ``name`` with ``args`` (tensors as their data
    pointers, None as a null pointer) on the current stream of ``device``;
    raises if the launch was refused."""
    fn = getattr(library(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def check_cuda_tensors(name: str, floats, ints=()) -> None:
    """Device, dtype, contiguity and alignment checks of the kernel
    wrappers: ``floats`` f32 and 16-byte aligned, ``ints`` int32, all
    contiguous on one CUDA device."""
    tensors = (*floats, *ints)
    if any(x.dtype != torch.float32 for x in floats) \
            or any(x.dtype != torch.int32 for x in ints):
        raise TypeError(f"{name}: expected float32 tensors and int32 "
                        f"flags, got {[x.dtype for x in tensors]}")
    dev = tensors[0].device
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                         f"got {[str(x.device) for x in tensors]}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name}: inputs must be contiguous, got strides "
                         f"{[x.stride() for x in tensors]}")
    if any(x.data_ptr() % 16 for x in floats):
        raise ValueError(f"{name}: float inputs must be 16-byte aligned")


def _check_cuda_inputs(name: str, pixel_term, step_term, w_h, valid,
                       g=None, attn=None):
    """Checks of the kernel wrappers; returns (N, P, H, T)."""
    extra = tuple(x for x in (g, attn) if x is not None)
    check_cuda_tensors(name, (pixel_term, step_term, w_h) + extra, (valid,))
    if pixel_term.dim() != 3 or step_term.dim() != 3 or w_h.dim() != 2:
        raise ValueError(f"{name}: expected pixel [N,P,4H], step [N,T,4H], "
                         "w_h [H,4H], valid [N,T], g [N,P,H], attn [N,T]")
    n, p, four_h = pixel_term.shape
    hidden = four_h // 4
    t_max = step_term.shape[1]
    if (four_h != 4 * hidden or step_term.shape != (n, t_max, four_h)
            or w_h.shape != (hidden, four_h) or valid.shape != (n, t_max)
            or (g is not None and g.shape != (n, p, hidden))
            or (attn is not None and attn.shape != (n, t_max))):
        raise ValueError(
            f"{name}: shape mismatch: pixel {tuple(pixel_term.shape)}, step "
            f"{tuple(step_term.shape)}, w_h {tuple(w_h.shape)}, valid "
            f"{tuple(valid.shape)}"
            + ("" if g is None else f", g {tuple(g.shape)}")
            + ("" if attn is None else f", attn {tuple(attn.shape)}"))
    if min(n, p, t_max) == 0 or max(n, t_max) > 65535:
        raise ValueError(f"{name}: unsupported sizes N={n} P={p} T={t_max}")
    return n, p, hidden, t_max


def _fwd_cuda(name, pixel_term, step_term, w_h, valid, attn=None):
    n, p, hidden, t_max = _check_cuda_inputs(name, pixel_term, step_term,
                                             w_h, valid, attn=attn)
    hp, _ = fwd_geometry(n * p, hidden)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=pixel_term.device)

    out = empty(n, p, hidden)
    scratch = (empty(hp, 4 * hp),                          # permuted W_h
               empty(n * t_max + 2, dtype=torch.int32),    # slot table
               empty(2, 2, n * p, hp))                     # h, c ping-pong
    sizes = (n, p, hidden, t_max, hp)
    if attn is None:
        launch("mlstm_fwd", pixel_term.device, pixel_term, step_term, w_h,
               valid, out, *scratch, *sizes)
    else:
        launch("mlstm_attn_fwd", pixel_term.device, pixel_term, step_term,
               w_h, valid, attn, out, *scratch, *sizes)
    return out


def mlstm_cuda(pixel_term: torch.Tensor, step_term: torch.Tensor,
               w_h: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Launch B1 (``csrc/mlstm_fwd.cu``) on the current stream: the slot
    table, the permuted W_h and T tensor-core launches of the shared stage
    kernel.  Takes f32 pixel/step/W_h and int32 ``valid``, contiguous and
    16-byte aligned on one CUDA device, any H; raises on anything else.
    Allocates the permuted W_h [Hp, 4Hp], the slot table and the running h
    and c [2, 2, N*P, Hp].  Never synchronises with the host.
    ``mlstm_cuda.launches`` counts launches."""
    out = _fwd_cuda("mlstm_cuda", pixel_term, step_term, w_h, valid)
    mlstm_cuda.launches += 1
    return out


mlstm_cuda.launches = 0


def mlstm_attn_cuda(pixel_term: torch.Tensor, step_term: torch.Tensor,
                    w_h: torch.Tensor, valid: torch.Tensor,
                    attn: torch.Tensor) -> torch.Tensor:
    """Launch B3 (``csrc/mlstm_fwd.cu``), the attention mode of B1's launch
    sequence: acc [N, P, H].  Takes what ``mlstm_cuda`` takes (any H) plus
    f32 ``attn`` [N, T]; raises on anything else.  Allocates B1's scratch;
    never synchronises with the host.  ``mlstm_attn_cuda.launches`` counts
    launches."""
    out = _fwd_cuda("mlstm_attn_cuda", pixel_term, step_term, w_h, valid,
                    attn)
    mlstm_attn_cuda.launches += 1
    return out


mlstm_attn_cuda.launches = 0


def _bwd_cuda(pixel_term, step_term, w_h, valid, g, attn=None):
    name = "mlstm_bwd_cuda" if attn is None else "mlstm_attn_bwd_cuda"
    n, p, hidden, t_max = _check_cuda_inputs(name, pixel_term, step_term,
                                             w_h, valid, g, attn)
    hp, splits, _ = bwd_geometry(n * p, hidden)
    four_h = 4 * hidden

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32,
                           device=pixel_term.device)

    d_pixel, d_step, d_w_h = empty(n, p, four_h), empty(n, t_max, four_h), \
        empty(hidden, four_h)
    slots = torch.empty(n * t_max + 2, dtype=torch.int32,
                        device=pixel_term.device)
    scratch = (empty(hp, 4 * hp), slots,          # permuted W_h, slot table
               empty(t_max, n * p, hp), empty(t_max, n * p, hp),
               empty(t_max, n * p, 4 * hp),       # staged h, c, gates
               empty(n * p, hp),                  # dc
               empty(splits, hp, 4 * hp))         # d_W_h partials
    sizes = (n, p, hidden, t_max, hp, splits)
    if attn is None:
        launch("mlstm_bwd", pixel_term.device, pixel_term, step_term, w_h,
               valid, g, d_pixel, d_step, d_w_h, *scratch, *sizes)
        return d_pixel, d_step, d_w_h
    d_attn = empty(n, t_max)
    attn_partials = empty(n, t_max, -(-p // ATTN_ROWS))
    launch("mlstm_attn_bwd", pixel_term.device, pixel_term, step_term, w_h,
           valid, attn, g, d_pixel, d_step, d_w_h, d_attn, *scratch,
           attn_partials, *sizes)
    return d_pixel, d_step, d_w_h, d_attn


def mlstm_bwd_cuda(pixel_term: torch.Tensor, step_term: torch.Tensor,
                   w_h: torch.Tensor, valid: torch.Tensor, g: torch.Tensor):
    """Launch ``csrc/mlstm_bwd.cu`` (B2) on the current stream: (d_pixel,
    d_step, d_w_h) of the final h.  Takes what ``mlstm_cuda`` takes plus
    f32 ``g`` [N, P, H]; raises on anything else.  Allocates the scratch of
    ``bwd_geometry``'s padded width Hp: the permuted W_h [Hp, 4Hp], the slot
    table, ``stage_h``/``stage_c`` [T, N*P, Hp], ``stage_g`` [T, N*P, 4Hp],
    dc [N*P, Hp] and the d_W_h partials.  Never synchronises with the host.
    ``mlstm_bwd_cuda.launches`` counts launches."""
    grads = _bwd_cuda(pixel_term, step_term, w_h, valid, g)
    mlstm_bwd_cuda.launches += 1
    return grads


mlstm_bwd_cuda.launches = 0


def mlstm_attn_bwd_cuda(pixel_term: torch.Tensor, step_term: torch.Tensor,
                        w_h: torch.Tensor, valid: torch.Tensor,
                        attn: torch.Tensor, g: torch.Tensor):
    """Launch B4, the word-attention instance of ``csrc/mlstm_bwd.cu``:
    (d_pixel, d_step, d_w_h, d_attn [N, T]) of acc.  Takes what
    ``mlstm_bwd_cuda`` takes (any H: it pads inside, as B2 does) plus f32
    ``attn`` [N, T]; raises on anything else.  Allocates
    ``mlstm_bwd_cuda``'s scratch and the d_attn partials [N, T, ceil(P /
    ATTN_ROWS)].  ``mlstm_attn_bwd_cuda.launches`` counts launches."""
    grads = _bwd_cuda(pixel_term, step_term, w_h, valid, g, attn)
    mlstm_attn_bwd_cuda.launches += 1
    return grads


mlstm_attn_bwd_cuda.launches = 0


def mlstm_forward(pixel_term, step_term, w_h, valid):
    """B1 (``mlstm_cuda``) on CUDA tensors, ``mlstm_plain`` on CPU ones;
    f32 operands and int32 ``valid``, contiguous."""
    if pixel_term.device.type == "cpu":
        return mlstm_plain(pixel_term, step_term, w_h, valid)
    return mlstm_cuda(pixel_term, step_term, w_h, valid)


def mlstm_backward(pixel_term, step_term, w_h, valid, g):
    """(d_pixel, d_step, d_w_h) by B2 (``mlstm_bwd_cuda``) on CUDA tensors,
    ``mlstm_bwd_plain`` on CPU ones."""
    if pixel_term.device.type == "cpu":
        return mlstm_bwd_plain(pixel_term, step_term, w_h, valid, g)
    return mlstm_bwd_cuda(pixel_term, step_term, w_h, valid, g.contiguous())


def mlstm_attn_forward(pixel_term, step_term, w_h, valid, attn):
    """B3 (``mlstm_attn_cuda``) on CUDA tensors, ``mlstm_attn_plain`` on
    CPU ones."""
    if pixel_term.device.type == "cpu":
        return mlstm_attn_plain(pixel_term, step_term, w_h, valid, attn)
    return mlstm_attn_cuda(pixel_term, step_term, w_h, valid, attn)


def mlstm_attn_backward(pixel_term, step_term, w_h, valid, attn, g):
    """(d_pixel, d_step, d_w_h, d_attn) by B4 (``mlstm_attn_bwd_cuda``) on
    CUDA tensors, ``mlstm_attn_bwd_plain`` on CPU ones."""
    if pixel_term.device.type == "cpu":
        return mlstm_attn_bwd_plain(pixel_term, step_term, w_h, valid, attn,
                                    g)
    return mlstm_attn_bwd_cuda(pixel_term, step_term, w_h, valid, attn,
                               g.contiguous())


def _gather_pixels(local: torch.Tensor, group) -> torch.Tensor:
    """The 'model' ranks' pixel slices [N, P/M, ...], concatenated in rank
    order on every rank."""
    parts = [torch.empty_like(local)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts, dim=1)


class PixelLSTM(torch.autograd.Function):
    """A pixel recurrence with its BPTT (the JAX custom VJPs
    ``pallas_mlstm.py:244-276,745-775,936-970``).  ``kernels`` is
    (forward, backward, positions of the inputs that the backward's
    gradients belong to, in its order): ``mlstm_forward``/
    ``mlstm_backward`` (B1/B2), ``mlstm_attn_forward``/
    ``mlstm_attn_backward`` (B3/B4, whose d_attn autograd carries back
    through the softmax and ``attn_fc`` that made ``attn``) or
    ``ops/recur_attn.py``'s (B5/B6); the one input left out, ``valid``,
    gets no gradient.  With ``save`` false (serving, under
    ``torch.no_grad``) nothing is kept for the backward.

    With ``group``, a mesh's 'model' process group of M ranks, the pixels
    are sharded as JAX's ``shard_map`` with P over 'model' does
    (``sketchyscenecolorization_tpu/models/rmi.py:165-196,227-237``): each
    rank runs the kernels on its contiguous P/M slice of the first input,
    with the others whole; the outputs and the per-pixel gradient (d_pixel,
    d_h0) are all-gathered, and the cotangents of the inputs every rank
    holds whole (d_step, d_W_h, d_attn, d_lang, the RecurAttn weights),
    partial sums over the rank's pixels, are summed over 'model' in one
    all-reduce (JAX's psum).  So everything that leaves the function is the
    same on every 'model' rank and nothing outside it needs a 'model'
    reduction.  (A differentiable all-gather, whose backward
    reduce-scatters, would count the replicated downstream gradient M
    times.)  P must divide by M."""

    @staticmethod
    def forward(ctx, kernels, group, save, *inputs):
        fwd, _, differentiable = kernels
        first = inputs[0]
        if group is not None:
            size, p = dist.get_world_size(group), first.shape[1]
            if p % size:
                raise ValueError(f"{p} pixels do not divide over "
                                 f"model={size}")
            ctx.rows = slice(dist.get_rank(group) * (p // size),
                             (dist.get_rank(group) + 1) * (p // size))
            first = first[:, ctx.rows]
        args = tuple(x.contiguous() if i in differentiable
                     else x.to(torch.int32).contiguous()
                     for i, x in enumerate((first,) + inputs[1:]))
        ctx.kernels, ctx.group, ctx.n_inputs = kernels, group, len(inputs)
        if save:
            ctx.save_for_backward(*args)
        out = fwd(*args)
        return out if group is None else _gather_pixels(out, group)

    @staticmethod
    def backward(ctx, g):
        _, bwd, differentiable = ctx.kernels
        group = ctx.group
        grads = bwd(*ctx.saved_tensors,
                    g if group is None else g[:, ctx.rows])
        if group is not None:
            rest = [x.contiguous() for x in grads[1:]]
            flat = torch.cat([x.reshape(-1) for x in rest])
            dist.all_reduce(flat, group=group)
            grads = [_gather_pixels(grads[0].contiguous(), group)]
            for x in rest:
                grads.append(flat[:x.numel()].view_as(x))
                flat = flat[x.numel():]
        out = [None] * ctx.n_inputs
        for i, d in zip(differentiable, grads):
            out[i] = d
        return (None, None, None, *out)


def pixel_lstm(kernels, mesh, *inputs) -> torch.Tensor:
    """``PixelLSTM`` of ``kernels`` on ``inputs``, its pixels sharded over
    ``mesh``'s 'model' axis when a mesh is given."""
    save = torch.is_grad_enabled() and any(
        inputs[i].requires_grad for i in kernels[2])
    group = None if mesh is None else mesh.get_group("model")
    return PixelLSTM.apply(kernels, group, save, *inputs)


MLSTM_KERNELS = (mlstm_forward, mlstm_backward, (0, 1, 2))
MLSTM_ATTN_KERNELS = (mlstm_attn_forward, mlstm_attn_backward, (0, 1, 2, 4))


def masked_pixel_lstm(pixel_term: torch.Tensor, step_term: torch.Tensor,
                      w_h: torch.Tensor, valid: torch.Tensor,
                      mesh=None) -> torch.Tensor:
    """Final h [N, P, H] of the masked recurrence, differentiable in
    pixel_term, step_term and w_h (JAX ``masked_pixel_lstm``,
    ``pallas_mlstm.py:937``); pixels sharded over ``mesh``'s 'model' axis
    when a mesh is given (``PixelLSTM``)."""
    return pixel_lstm(MLSTM_KERNELS, mesh, pixel_term, step_term, w_h, valid)


def attn_weighted_pixel_lstm(pixel_term: torch.Tensor,
                             step_term: torch.Tensor, w_h: torch.Tensor,
                             valid: torch.Tensor, attn: torch.Tensor,
                             mesh=None) -> torch.Tensor:
    """acc [N, P, H] = sum over kept steps of attn[n, t] * h_t,
    differentiable in pixel_term, step_term, w_h and attn (JAX
    ``attn_weighted_pixel_lstm``, ``pallas_mlstm.py:245``); pixels sharded
    over ``mesh``'s 'model' axis when a mesh is given."""
    return pixel_lstm(MLSTM_ATTN_KERNELS, mesh, pixel_term, step_term, w_h,
                      valid, attn)
