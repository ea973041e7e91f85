#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for sm_90a: H100).

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):
  1. build all kernels, one nvcc per source, all started together, printing
     registers and spills: the masked pixel-LSTM ``csrc/mlstm_fwd.cu`` (B1
     and B3, its word-attention variant) and ``csrc/mlstm_bwd.cu`` (B2,
     B4), and the RecurAttn recurrence ``csrc/recur_attn_fwd.cu`` (B5) and
     ``csrc/recur_attn_bwd.cu`` (B6), which share the tensor-core kernels of
     ``csrc/lstm_tc.cuh`` and ``csrc/recur_tc.cuh``;
  2. turn TF32 off for cuDNN convolutions and cuBLAS matmuls;
  3. hold B1 against ``mlstm_plain`` on the card at the RMI, FG and BG
     shapes, at H = 250 (not a multiple of 4) and at the FG shape with a
     row without a kept step (max-abs error on h <= 1e-4) and time both;
     profile one B1 call at the RMI shape by launch kind;
  4. hold B2 against ``mlstm_bwd_plain`` at the same shapes but the last
     (max-abs error of each gradient <= 1e-4 of its largest magnitude),
     check that two launches agree bit for bit, and time both against its
     f32 and 3xTF32 tensor-core bounds; profile one B2 call at the RMI
     shape by launch kind (layout, staging forward, sweep, d_W_h, d_step);
     count the HMMA (tensor-core) instructions of every kernel's products
     (B1-B6) in the built library with ``cuobjdump -sass`` and check that
     they have no float atomics;
  5. run the same FG instruction sequence through a CUDA session and a CPU
     session (plain PyTorch path) on a small synthetic scene, with the same
     seeded parameters and noise: records byte-equal, matched instances
     equal, canvases within 1 uint8 LSB and byte-equal outside the
     instances' inner masks; then a mixed FG/BG sequence (BG, FG, BG,
     withdraw, BG) the same way with the sky gradient off: records
     byte-equal, canvases within 1 LSB and byte-equal on the drawings;
  6. three matching train steps at a small config on CUDA and on the CPU
     from the same seeded weights and batches: costs and text leaves agree,
     ResNet bit-unchanged;
  7. write a synthetic 768x768 scene and run the session at the default
     full-width configuration on the card: a FG ``color`` command, a FG
     pass forced onto every eligible instance, a ``withdraw`` and a second
     ``color`` command, with B1's launches counted; then the BG branch at
     the default full width (ResidualGenerator, ngf 64, 768^2): the sky
     gradient's LUT built and timed apart, a FG command, then a cold BG
     command and 12 warm ones (path ``color_bg``: B1 at P = 576, H = 1024,
     T = 8, one launch a command), with the generator's device time, the
     engine call, the gradient and the PNG writes timed apart, peak device
     memory, one generator forward profiled by kernel, the results
     checked;
  8. write a synthetic 768x768 matching corpus and run ``cli_matching
     --mode train`` at the default full-width configuration for 6 steps,
     then resume it for 2 more: B1 and B2 launch every step, losses are
     finite, the text leaves move and ResNet does not, the snapshot is
     written and resumed; step wall times, B2's share of a step
     (``torch.profiler``) and peak device memory; a session built on the
     run's snapshots holds the trained weights and gives the trained
     module's ``up`` logits bit for bit, and ``cli_matching --mode
     inference`` on the run writes its prediction (path
     ``infer_matching``);
  9. hold B3/B4 against ``mlstm_attn_plain``/``mlstm_attn_bwd_plain`` at
     the RMI shape, a ragged one with a row without a kept step and H = 250
     (acc within 1e-4; each gradient, d_attn included, within 1e-4 of its
     largest magnitude; B4 bitwise repeatable), and B5/B6 against
     ``recur_attn_plain``/``recur_attn_bwd_plain`` at the RecurAttn shape, a
     ragged mask with a 0 inside a sequence, T = 20 and H = 250, the same
     way; time each against its plain version; profile one B3 call at the
     RMI shape and one B5 and one B6 call at the RecurAttn shape by launch
     kind (this phase runs right after 4);
 10. for each of the word-attention (``use_attn``) and RecurAttn fusions:
     the small-scene session sequence and three small-config train steps on
     CUDA against the CPU, as in 5 and 6; then at full width a session
     (``color`` command and forced FG pass, B3 or B5 launches counted) and
     5 ``train_matching`` steps on the synthetic corpus, each launching
     B3+B4 or B5+B6, with step walls, peak device memory and the last step
     under ``torch.profiler``;
 11. print the kernels line (six kernels: launches per path, times, the
     f32 and 3xTF32 bounds, device ms by launch kind, HMMA counts),
     the card's name and power limit, and last ``{"ok": true, "device":
     {...}}``.

Without a CUDA device, or outside the repository, it exits non-zero before
printing any result.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-4          # max-abs error of B1's h against mlstm_plain
BWD_TOL = 1e-4      # B2's max-abs error over the gradient's max magnitude
IMAGE_ID = 1
F32_FLOPS = 67e12   # H100 SXM: f32 on the CUDA cores, TF32 on the tensor
TF32_FLOPS = 495e12  # cores (dense), and HBM3 bytes/s
HBM_BYTES = 3.35e12
TRAIN_STEPS, RESUME_STEPS = 6, 2
PROFILED_STEP = 5   # the full-width training step traced by torch.profiler
SHAPES = [
    # name, N, P, H, T, valid steps (per row, or one count for all rows),
    # front-padded
    ("rmi", 1, 9216, 500, 15, 7, False),
    ("fg", 4, 36, 512, 15, 4, True),
    ("bg", 1, 576, 1024, 8, 5, True),
    ("h250", 2, 1001, 250, 15, 7, False),            # cli_matching scale 0.5
    ("fg_empty_row", 4, 36, 512, 15, [4, 4, 0, 4], True),   # B1 only
]
NO_LIBRARY = ("no single PyTorch call computes the masked TF-cell "
              "recurrence (gate order i,j,f,o, forget bias 1, per-step "
              "freeze of c and h)")
VARIANT_STEPS = 5   # full-width train steps of each variant fusion; the
                    # last one runs under torch.profiler
# name, N, P, H, T, valid flags per batch row
ATTN_SHAPES = [
    ("rmi_attn", 1, 9216, 500, 15, [[1] * 7 + [0] * 8]),
    ("ragged_attn", 2, 1001, 500, 15, [[1] * 5 + [0] * 10, [0] * 15]),
    ("attn_h250", 2, 1001, 250, 15, [[1] * 7 + [0] * 8, [1] * 3 + [0] * 12]),
]
RECUR_SHAPES = [
    ("recur", 1, 9216, 256, 15, [[1] * 7 + [0] * 8]),
    ("ragged_recur", 2, 1001, 256, 15,
     [[1, 1, 0, 1, 1, 1, 1] + [0] * 8, [0, 0, 1, 1, 1] + [0] * 10]),
    ("recur_t20", 2, 1001, 256, 20, [[1] * 12 + [0] * 8,
                                     [0, 1, 1, 0, 1] + [0] * 15]),
    ("recur_h250", 2, 1001, 250, 15, [[1] * 7 + [0] * 8,
                                      [1] * 3 + [0] * 12]),
]
VARIANTS = {"attn": {"use_attn": True}, "recur": {"fusion_type": "RecurAttn"}}

# (46-category id, name, box as fractions (y1, x1, y2, x2) of the canvas)
INSTANCES = [
    (7, "bus", (0.15, 0.12, 0.45, 0.55)),
    (12, "car", (0.20, 0.62, 0.40, 0.90)),
    (3, "house", (0.50, 0.60, 0.68, 0.85)),     # no FG colorization class
    (27, "grass", (0.80, 0.05, 0.90, 0.50)),
]


def log(*args):
    print(*args, flush=True)


def write_scene(base: str, size: int, image_id: int = IMAGE_ID):
    """Synthetic scene fixture in the layout of ``tests/test_pipeline.py``
    (``write_fixtures``): sketch PNG, seg_data npz, inner-mask .mat and the
    46-class colour map.  Returns the instance indices that the FG
    generator may colorize."""
    import scipy.io
    from PIL import Image
    from sketchyscenecolorization_torch.pipeline.compositing import \
        SKE_ID_TO_CAT_ID

    for sub in ("sketches", "seg_data", "inner_masks"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    line = max(1, size // 256)
    sketch = np.full((size, size, 3), 255, np.uint8)
    inner = np.zeros((size, size), np.uint8)
    masks = np.empty(len(INSTANCES), dtype=object)
    boxes = np.zeros((len(INSTANCES), 4), np.int32)
    for i, (_, _, frac) in enumerate(INSTANCES):
        y1, x1, y2, x2 = (int(f * size) for f in frac)
        boxes[i] = (y1, x1, y2, x2)
        box = sketch[y1:y2 + 1, x1:x2 + 1]
        box[:line], box[-line:], box[:, :line], box[:, -line:] = 0, 0, 0, 0
        masks[i] = np.ones((y2 - y1 + 1, x2 - x1 + 1), np.uint8)
        inner[y1 + line:y2 + 1 - line, x1 + line:x2 + 1 - line] = i + 1
    sketch[int(0.75 * size):int(0.75 * size) + line, :] = 0   # ground line
    Image.fromarray(sketch).save(
        os.path.join(base, "sketches", f"{image_id}.png"))
    np.savez(os.path.join(base, "seg_data", f"{image_id}_datas.npz"),
             pred_masks=masks,
             pred_class_ids=np.array([c for c, _, _ in INSTANCES]),
             pred_boxes=boxes)
    scipy.io.savemat(os.path.join(base, "inner_masks", f"{image_id}.mat"),
                     {"inner_masks": inner})
    names = {c: n for c, n, _ in INSTANCES}
    cm = np.empty((46, 2), dtype=object)
    for i in range(46):
        cm[i, 0] = np.array([names.get(i, f"category{i}")])
        cm[i, 1] = np.array([[120, 120, 120]], np.uint8)
    scipy.io.savemat(os.path.join(base, "colorMapC46.mat"), {"colorMap": cm})
    return [i for i, (c, _, _) in enumerate(INSTANCES) if c in SKE_ID_TO_CAT_ID]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, tc_flops: float = 0.0):
    """(bound ms, what bounds it): the larger of the operations (``flops``
    over the f32 peak plus ``tc_flops``, TF32 tensor-core operations, over
    the TF32 peak) and the compulsory bytes over the HBM rate."""
    t_ops = (flops / F32_FLOPS + tc_flops / TF32_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _per_row(n, n_valid):
    return list(n_valid) if isinstance(n_valid, (list, tuple)) \
        else [n_valid] * n


def fwd_bound(n, p, hid, t, n_valid, tensor_cores=False):
    """B1: one [P,H]x[H,4H] product per valid step after the first and
    batch row (the first valid step multiplies h = 0); inputs read once, h
    written once.  In f32 on the CUDA cores, or with ``tensor_cores`` in
    3xTF32 (three TF32 products per f32 product), as B1 runs."""
    flops = sum(2 * p * hid * 4 * hid * max(k - 1, 0)
                for k in _per_row(n, n_valid))
    nbytes = 4 * (n * p * 4 * hid + n * t * 4 * hid + hid * 4 * hid + n * t
                  + n * p * hid)
    return bound(0.0, nbytes, 3 * flops) if tensor_cores \
        else bound(flops, nbytes)


def bwd_bound(n, p, hid, t, n_valid, tensor_cores=False):
    """B2: per batch row three products at every valid step after the
    first: the recomputed forward h @ W_h, dh = dgates @ W_h^T and
    h_prev^T dgates for d_W_h (at the first valid step h_prev = 0 and no
    dh flows further back); inputs (pixel, step, W_h, valid, g) read once,
    the three gradients written once.  In f32 on the CUDA cores, or with
    ``tensor_cores`` at the precision the kernel runs: 3xTF32, three TF32
    products per f32 product."""
    flops = sum(2 * p * hid * 4 * hid * 3 * max(k - 1, 0)
                for k in _per_row(n, n_valid))
    nbytes = 4 * (2 * n * p * 4 * hid + 2 * n * t * 4 * hid
                  + 2 * hid * 4 * hid + n * t + n * p * hid)
    if tensor_cores:
        return bound(0.0, nbytes, 3 * flops)
    return bound(flops, nbytes)


def kernel_counters():
    """{kernel name: its wrapper}; each wrapper counts its own launches."""
    from sketchyscenecolorization_torch.ops import mlstm, recur_attn
    return {"mlstm_fwd": mlstm.mlstm_cuda, "mlstm_bwd": mlstm.mlstm_bwd_cuda,
            "mlstm_attn_fwd": mlstm.mlstm_attn_cuda,
            "mlstm_attn_bwd": mlstm.mlstm_attn_bwd_cuda,
            "recur_attn_fwd": recur_attn.recur_attn_cuda,
            "recur_attn_bwd": recur_attn.recur_attn_bwd_cuda}


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_counters().items()}


# forward and backward kernel of each fusion ("" is the default)
FUSION_KERNELS = {"": ("mlstm_fwd", "mlstm_bwd"),
                  "attn": ("mlstm_attn_fwd", "mlstm_attn_bwd"),
                  "recur": ("recur_attn_fwd", "recur_attn_bwd")}
# device kernels (profiler names) of each variant's forward and backward
# (the layout and pad kernels of csrc/lstm_tc.cuh and csrc/recur_tc.cuh,
# shared by forward and backward and 0.01-0.02 ms a call, are in none);
# mlstm_stage_kernel's modes: 0 B2/B4's staging, 1 B1, 2 B3
B1_NAMES = ("mlstm_stage_kernel<1>",)
B2_NAMES = ("mlstm_stage_kernel<0>", "mlstm_bwd_", "lstm_rows_product")
RECUR_FWD = ("recur_proj_kernel<true>", "recur_softmax_kernel<true>",
             "recur_gates_kernel<true>")
PROFILE_NAMES = {
    "attn": (("mlstm_stage_kernel<2>",), B2_NAMES),
    "recur": (RECUR_FWD, ("recur_bwd_", "recur_proj_kernel<false>",
                          "recur_softmax_kernel<false>",
                          "recur_gates_kernel<false>", "lstm_rows_product"))}


def _kept(rows):
    return [sum(1 for v in row if v) for row in rows]


def attn_fwd_bound(n, p, hid, t, rows, tensor_cores=False):
    """B3: B1's products (per batch row one [P,H]x[H,4H] product per kept
    step after the first; with ``tensor_cores`` in 3xTF32); inputs (attn
    too) read once, acc written once."""
    flops = sum(2 * p * hid * 4 * hid * max(k - 1, 0) for k in _kept(rows))
    nbytes = 4 * (n * p * 4 * hid + n * t * 4 * hid + hid * 4 * hid + 2 * n * t
                  + n * p * hid)
    return bound(0.0, nbytes, 3 * flops) if tensor_cores \
        else bound(flops, nbytes)


def attn_bwd_bound(n, p, hid, t, rows, tensor_cores=False):
    """B4: B2's three products per kept step after the first (with
    ``tensor_cores`` in 3xTF32, as ``bwd_bound``), plus d_attn's P*H
    multiply-adds at every kept step in f32; inputs (pixel, step, W_h,
    valid, attn, g) read once, the four gradients written once."""
    products = sum(2 * p * hid * 4 * hid * 3 * max(k - 1, 0)
                   for k in _kept(rows))
    flops = sum(2 * p * hid * k for k in _kept(rows))
    nbytes = 4 * (2 * n * p * 4 * hid + 2 * n * t * 4 * hid
                  + 2 * hid * 4 * hid + 3 * n * t + n * p * hid)
    if tensor_cores:
        return bound(flops, nbytes, 3 * products)
    return bound(flops + products, nbytes)


def recur_fwd_bound(n, p, hid, t, rows, tensor_cores=False):
    """B5: per pixel and kept step (every one: h starts at h0, not 0)
    h@Wp (H*w) and [x,h]@Wm ((w+H)*4H) in f32, or with ``tensor_cores`` in
    3xTF32, and the logits and attn@lang (2*T*w) in f32, w = H; inputs read
    once, h written once."""
    kept = sum(_kept(rows))
    products = 2 * p * (hid * hid + 2 * hid * 4 * hid) * kept
    attn = 2 * p * 2 * t * hid * kept
    nbytes = 4 * (2 * n * p * hid + n * t * hid + 9 * hid * hid + 5 * hid
                  + n * t)
    return bound(attn, nbytes, 3 * products) if tensor_cores \
        else bound(attn + products, nbytes)


def recur_bwd_bound(n, p, hid, t, rows, tensor_cores=False):
    """B6: per pixel and kept step the recomputed forward (B5's products),
    [dx, dh] = dgates@Wm^T, dhp@Wp^T and the gradient products [x,h]^T
    dgates and h^T dhp (3x B5's products: in f32, or with ``tensor_cores``
    in 3xTF32, as B6 runs), and in f32 the attention: the
    forward's logits and attn@lang, dx.lang, dlogits@lang and attn^T dx +
    dlogits^T h_proj (3x B5's); inputs (g too) read once, the six gradients
    written once."""
    kept = sum(_kept(rows))
    products = 3 * 2 * p * (hid * hid + 2 * hid * 4 * hid) * kept
    attn = 3 * 2 * p * 2 * t * hid * kept
    nbytes = 4 * (3 * n * p * hid + 2 * n * t * hid
                  + 2 * (9 * hid * hid + 5 * hid) + n * t)
    return bound(attn, nbytes, 3 * products) if tensor_cores \
        else bound(attn + products, nbytes)


def shape_inputs(n, p, hid, t, n_valid, front):
    import torch
    g = torch.Generator(device="cuda").manual_seed(p)
    pixel = torch.randn(n, p, 4 * hid, device="cuda", generator=g) * 0.3
    step = torch.randn(n, t, 4 * hid, device="cuda", generator=g) * 0.3
    w_h = torch.randn(hid, 4 * hid, device="cuda", generator=g) * 0.05
    dh = torch.randn(n, p, hid, device="cuda", generator=g)
    steps = torch.arange(t, device="cuda")[None]
    kept = torch.tensor(_per_row(n, n_valid), device="cuda")[:, None]
    valid = (steps >= t - kept) if front else (steps < kept)
    return pixel, step, w_h, valid.to(torch.int32).contiguous(), dh


def check_kernel(mlstm):
    """B1 vs plain on the card at the shapes of SHAPES; returns {shape
    name: (max_abs_err, kernel ms, plain ms)}."""
    import torch
    results = {}
    for name, n, p, hid, t, n_valid, front in SHAPES:
        pixel, step, w_h, valid, _ = shape_inputs(n, p, hid, t, n_valid,
                                                  front)
        got = mlstm.mlstm_cuda(pixel, step, w_h, valid)
        torch.cuda.synchronize()
        want = mlstm.mlstm_plain(pixel, step, w_h, valid)
        err = float((got - want).abs().max())
        if not (torch.isfinite(got).all() and err <= TOL):
            raise AssertionError(f"kernel vs plain at {name}: max-abs "
                                 f"{err} > {TOL} (or non-finite)")
        iters = 5 if name == "rmi" else 20
        kernel = lambda: mlstm.mlstm_cuda(pixel, step, w_h, valid)   # noqa: E731
        plain = lambda: mlstm.mlstm_plain(pixel, step, w_h, valid)   # noqa: E731
        p1, k1, k2, p2 = (cuda_ms(f, iters)
                          for f in (plain, kernel, kernel, plain))
        results[name] = (err, (k1 + k2) / 2, (p1 + p2) / 2)
        b_ms, b_by = fwd_bound(n, p, hid, t, n_valid)
        tc_ms, _ = fwd_bound(n, p, hid, t, n_valid, tensor_cores=True)
        log(f"B1 vs plain [{name}: N={n} P={p} H={hid} T={t}, "
            f"{n_valid} valid, {'front' if front else 'end'}-padded]: "
            f"max_abs_err {err:.3e} (tol {TOL:.0e}), kernel "
            f"{results[name][1]:.3f} ms, plain {results[name][2]:.3f} ms, "
            f"bound f32 {b_ms:.3f} ms ({b_by}), 3xTF32 {tc_ms:.3f} ms: "
            f"{tc_ms / results[name][1]:.1%} of it")
    return results


def check_bwd_kernel(mlstm):
    """B2 vs plain on the card at the shapes of SHAPES but the last, two
    launches bitwise equal; returns {shape name: (max_abs_err, max_rel_err,
    kernel ms, plain ms)}."""
    import torch
    results = {}
    for name, n, p, hid, t, n_valid, front in SHAPES[:-1]:
        args = shape_inputs(n, p, hid, t, n_valid, front)
        got = mlstm.mlstm_bwd_cuda(*args)
        again = mlstm.mlstm_bwd_cuda(*args)
        torch.cuda.synchronize()
        want = mlstm.mlstm_bwd_plain(*args)
        abs_err, rel_err = 0.0, 0.0
        for out, a, b, c in zip(("d_pixel", "d_step", "d_w_h"), got, again,
                                want):
            if not torch.equal(a, b):
                raise AssertionError(f"B2 at {name}: two launches differ in "
                                     f"{out}")
            err = float((a - c).abs().max())
            rel = err / max(float(c.abs().max()), 1e-30)
            if not (torch.isfinite(a).all() and rel <= BWD_TOL):
                raise AssertionError(f"B2 vs plain at {name}, {out}: max-abs "
                                     f"{err} is {rel} of max|plain| > "
                                     f"{BWD_TOL} (or non-finite)")
            abs_err, rel_err = max(abs_err, err), max(rel_err, rel)
            log(f"  B2 {name} {out}: max_abs_err {err:.3e}, "
                f"{rel:.2e} of max|plain| {float(c.abs().max()):.3e}")
        iters = 3 if name == "rmi" else 10
        kernel = lambda: mlstm.mlstm_bwd_cuda(*args)   # noqa: E731
        plain = lambda: mlstm.mlstm_bwd_plain(*args)   # noqa: E731
        p1, k1, k2, p2 = (cuda_ms(f, iters)
                          for f in (plain, kernel, kernel, plain))
        results[name] = (abs_err, rel_err, (k1 + k2) / 2, (p1 + p2) / 2)
        b_ms, b_by = bwd_bound(n, p, hid, t, n_valid)
        tc_ms, _ = bwd_bound(n, p, hid, t, n_valid, tensor_cores=True)
        log(f"B2 vs plain [{name}: N={n} P={p} H={hid} T={t}, {n_valid} "
            f"valid]: bitwise repeatable, max error {rel_err:.2e} of "
            f"max|plain| (tol {BWD_TOL:.0e}), kernel {results[name][2]:.3f} "
            f"ms, plain {results[name][3]:.3f} ms, bound f32 {b_ms:.3f} ms "
            f"({b_by}), 3xTF32 {tc_ms:.3f} ms: {tc_ms / results[name][2]:.1%}"
            f" of it; order plain, kernel, kernel, plain: "
            f"{p1:.3f} {k1:.3f} {k2:.3f} {p2:.3f}")
        del args, got, again, want
        torch.cuda.empty_cache()
    return results


# launch kinds of B1 (csrc/mlstm_fwd.cu) and B2/B4 (csrc/mlstm_bwd.cu) by
# kernel-name substring (the layout kernels of csrc/lstm_tc.cuh serve both)
LAYOUT = ("lstm_slots", "lstm_layout")
FWD_KINDS = {"layout": LAYOUT, "stage": B1_NAMES}
ATTN_FWD_KINDS = {"layout": LAYOUT, "stage": ("mlstm_stage_kernel<2>",)}
BWD_KINDS = {"layout": LAYOUT,
             "staging forward": ("mlstm_stage_kernel<0>",),
             "sweep": ("mlstm_bwd_sweep",),
             "d_W_h": ("lstm_rows_product", "lstm_weight_sum"),
             "d_step": ("mlstm_bwd_step_sums",),
             "d_attn": ("mlstm_bwd_attn", "lstm_ordered_sum")}
# launch kinds of B5 (csrc/recur_attn_fwd.cu) and B6 (csrc/recur_attn_bwd.cu)
RECUR_FWD_KINDS = {"layout": LAYOUT + ("recur_pad", "Memcpy"),
                   "F1 h_proj": RECUR_FWD[:1], "F2 softmax": RECUR_FWD[1:2],
                   "F3 gates+cell": RECUR_FWD[2:]}
RECUR_BWD_KINDS = {"layout": LAYOUT + ("recur_pad", "Memset"),
                   "F1 h_proj": ("recur_proj_kernel<false>",),
                   "F2 softmax": ("recur_softmax_kernel<false>",),
                   "F3 gates+cell": ("recur_gates_kernel<false>",),
                   "S3 dh+cell grad": ("recur_bwd_sweep",),
                   "S1 dx": ("recur_bwd_dx",),
                   "S2 attn bwd": ("recur_bwd_attn",),
                   "d_Wm, d_Wp": ("lstm_rows_product", "lstm_weight_sum"),
                   "sums": ("lstm_ordered_sum", "recur_bwd_col_parts")}
# kernels that run products on the tensor cores
SASS_PRODUCTS = {
    "B1": B1_NAMES,
    "B2/B4": ("mlstm_stage_kernel<0>", "mlstm_bwd_sweep_kernel<false>",
              "mlstm_bwd_sweep_kernel<true>", "lstm_rows_product_kernel"),
    "B3": ("mlstm_stage_kernel<2>",),
    "B5": ("recur_proj_kernel<true>", "recur_gates_kernel<true>"),
    "B6": ("recur_proj_kernel<false>", "recur_gates_kernel<false>",
           "recur_bwd_sweep_kernel", "recur_bwd_dx_kernel",
           "lstm_rows_product_kernel")}


def profile_call(label, call, kinds, per_launch=()):
    """One ``call()`` under ``torch.profiler`` after a warm-up call: device
    ms and launches by launch kind (``kinds``: {kind: kernel-name
    substrings}), and the per-launch device times of the ``per_launch``
    kinds in launch order.  Raises unless every kind of ``per_launch`` ran.
    Returns {kind: (ms, launches)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    sums = {kind: [0.0, 0] for kind in kinds}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us <= 0 or getattr(ev, "device_type", None) == \
                torch.autograd.DeviceType.CPU:
            continue
        for kind, names in kinds.items():
            if any(pre in ev.key for pre in names):
                sums[kind][0] += us / 1e3
                sums[kind][1] += ev.count
                break
    if any(sums[kind][0] <= 0 for kind in per_launch):
        raise AssertionError(f"torch.profiler saw no {label} kernels: {sums}")
    total = sum(ms for ms, _ in sums.values())
    log(f"{label} by launch kind (torch.profiler, one call, device "
        f"{total:.3f} ms): "
        + ", ".join(f"{k} {ms:.3f} ms / {c} launches"
                    for k, (ms, c) in sums.items() if c))
    for kind in per_launch:
        runs = sorted((ev.time_range.start, ev.time_range.elapsed_us())
                      for ev in prof.events()
                      if ev.device_type != torch.autograd.DeviceType.CPU
                      and any(pre in ev.name for pre in kinds[kind]))
        log(f"  {kind} per launch (us): "
            + " ".join(f"{us:.1f}" for _, us in runs))
    return {k: tuple(v) for k, v in sums.items()}


def profile_fwd_call(mlstm):
    """One B1 call at the RMI shape by launch kind (FWD_KINDS), its stage
    launches (slot ranks 0..T-1, no product at 0) one by one; ranks past
    the kept steps exit at once."""
    import torch
    name, n, p, hid, t, n_valid, front = SHAPES[0]
    pixel, step, w_h, valid, _ = shape_inputs(n, p, hid, t, n_valid, front)
    kinds = profile_call(f"B1 at {name}",
                         lambda: mlstm.mlstm_cuda(pixel, step, w_h, valid),
                         FWD_KINDS, ("stage",))
    del pixel, step, w_h, valid
    torch.cuda.empty_cache()
    return kinds


def profile_bwd_call(mlstm):
    """One B2 call at the RMI shape by launch kind (BWD_KINDS), with the
    staging forward's launches (slot ranks 0..T-1, no product at 0) and the
    sweep's (T-1..0, no product at a row's last kept slot) one by one;
    ranks past the kept steps exit at once."""
    import torch
    name, n, p, hid, t, n_valid, front = SHAPES[0]
    args = shape_inputs(n, p, hid, t, n_valid, front)
    kinds = profile_call(f"B2 at {name}", lambda: mlstm.mlstm_bwd_cuda(*args),
                         BWD_KINDS, ("staging forward", "sweep"))
    del args
    torch.cuda.empty_cache()
    return kinds


def profile_variant_call(label, kinds, per_launch):
    """One call of B3 (``label`` "B3", at the RMI shape ATTN_SHAPES[0]), B5
    or B6 ("B5", "B6", at the RecurAttn shape RECUR_SHAPES[0]) by launch
    kind (``kinds``), the ``per_launch`` kinds launch by launch: B3's stage
    launches (rank 0 with the cell alone, the ranks with the product, the
    empty ranks past the kept steps), B5's and B6's gate products, B6's
    sweep products."""
    import torch
    from sketchyscenecolorization_torch.ops import mlstm, recur_attn
    kind = "attn" if label == "B3" else "recur"
    name, n, p, hid, t, rows = (ATTN_SHAPES if kind == "attn"
                                else RECUR_SHAPES)[0]
    args, dout = variant_inputs(kind, n, p, hid, t, rows)
    call = {"B3": lambda: mlstm.mlstm_attn_cuda(*args),
            "B5": lambda: recur_attn.recur_attn_cuda(*args),
            "B6": lambda: recur_attn.recur_attn_bwd_cuda(*args, dout)}[label]
    sums = profile_call(f"{label} at {name}", call, kinds, per_launch)
    del args, dout
    torch.cuda.empty_cache()
    return sums


def sass_counts(library: str):
    """{kernel: (HMMA, float atomics)} of the tensor-core kernels of B1-B6
    (SASS_PRODUCTS) in the built library, from ``cuobjdump
    -sass``: the fewest HMMA and the most float atomics over the copies of
    a kernel (a kernel of csrc/lstm_tc.cuh has one in each source that
    launches it); raises unless each runs HMMA and none has a float
    atomic."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    names = {name for group in SASS_PRODUCTS.values() for name in group}
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"\d((?:m?lstm|recur)_[a-z_]+_kernel)"
                          r"(?:IL([bi])(\d+)E)?", line)
            name = m and m.group(1) + (
                "" if not m.group(2) else f"<{m.group(3)}>"
                if m.group(2) == "i" else
                "<true>" if m.group(3) == "1" else "<false>")
            cur = [0, 0] if name in names else None
            if cur:
                counts.setdefault(name, []).append(cur)
        elif cur:
            cur[0] += "HMMA" in line
            cur[1] += any(op in line for op in ("ATOM", "RED.")) \
                and ".F32" in line
    counts = {k: (min(c[0] for c in v), max(c[1] for c in v))
              for k, v in counts.items()}
    missing = [k for k in names if counts.get(k, (0, 0))[0] == 0]
    if missing or any(a for _, a in counts.values()):
        raise AssertionError(f"no HMMA in {missing} or float atomics: "
                             f"{counts}")
    log("SASS of B1-B6 (cuobjdump -sass): HMMA per kernel "
        + ", ".join(f"{k} {h}" for k, (h, _) in sorted(counts.items()))
        + "; no float atomics")
    return counts


def variant_inputs(kind, n, p, hid, t, rows):
    """Seeded inputs of B3/B4 (``kind`` "attn") or B5/B6 ("recur") on the
    card, and dL/d(output)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(p + hid)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * scale

    valid = torch.tensor(rows, dtype=torch.int32, device="cuda")
    if kind == "attn":
        args = (rnd(n, p, 4 * hid, scale=0.3), rnd(n, t, 4 * hid, scale=0.3),
                rnd(hid, 4 * hid, scale=0.05), valid,
                torch.softmax(rnd(n, t), -1))
    else:
        args = (rnd(n, p, hid, scale=0.3), rnd(n, t, hid, scale=0.3),
                rnd(hid, hid, scale=0.05), rnd(hid, scale=0.1),
                rnd(2 * hid, 4 * hid, scale=0.05), rnd(4 * hid, scale=0.1),
                valid)
    return args, rnd(n, p, hid)


def check_variant_kernels(kind):
    """B3/B4 (``kind`` "attn", ATTN_SHAPES) or B5/B6 ("recur",
    RECUR_SHAPES) against their plain versions on the card: the forward
    within TOL, every gradient within BWD_TOL of its largest magnitude, two
    backward launches bitwise equal; each timed in the order plain, kernel,
    kernel, plain.  Returns {shape name: (fwd max-abs error, fwd ms, fwd
    plain ms, bwd max-abs error, bwd max relative error, bwd ms, bwd plain
    ms)}."""
    import torch
    from sketchyscenecolorization_torch.ops import mlstm, recur_attn
    if kind == "attn":
        fwd, fwd_plain = mlstm.mlstm_attn_cuda, mlstm.mlstm_attn_plain
        bwd, bwd_plain = mlstm.mlstm_attn_bwd_cuda, mlstm.mlstm_attn_bwd_plain
        names = ("d_pixel", "d_step", "d_w_h", "d_attn")
        shapes, labels = ATTN_SHAPES, ("B3", "B4")
        bounds = (attn_fwd_bound, attn_bwd_bound)
    else:
        fwd, fwd_plain = recur_attn.recur_attn_cuda, recur_attn.recur_attn_plain
        bwd, bwd_plain = (recur_attn.recur_attn_bwd_cuda,
                          recur_attn.recur_attn_bwd_plain)
        names = ("d_h0", "d_lang", "d_wp", "d_bp", "d_wm", "d_bm")
        shapes, labels = RECUR_SHAPES, ("B5", "B6")
        bounds = (recur_fwd_bound, recur_bwd_bound)
    results = {}
    for name, n, p, hid, t, rows in shapes:
        args, dout = variant_inputs(kind, n, p, hid, t, rows)
        got = fwd(*args)
        torch.cuda.synchronize()
        err = float((got - fwd_plain(*args)).abs().max())
        if not (torch.isfinite(got).all() and err <= TOL):
            raise AssertionError(f"{labels[0]} vs plain at {name}: max-abs "
                                 f"{err} > {TOL} (or non-finite)")
        grads, again = bwd(*args, dout), bwd(*args, dout)
        torch.cuda.synchronize()
        abs_err = rel_err = 0.0
        for out, a, b, c in zip(names, grads, again, bwd_plain(*args, dout)):
            if not torch.equal(a, b):
                raise AssertionError(f"{labels[1]} at {name}: two launches "
                                     f"differ in {out}")
            e = float((a - c).abs().max())
            r = e / max(float(c.abs().max()), 1e-30)
            if not (torch.isfinite(a).all() and r <= BWD_TOL):
                raise AssertionError(f"{labels[1]} vs plain at {name}, {out}: "
                                     f"max-abs {e} is {r} of max|plain| > "
                                     f"{BWD_TOL} (or non-finite)")
            abs_err, rel_err = max(abs_err, e), max(rel_err, r)
            log(f"  {labels[1]} {name} {out}: max_abs_err {e:.3e}, {r:.2e} "
                f"of max|plain| {float(c.abs().max()):.3e}")
        del got, grads, again
        iters = 3 if p > 5000 else 10
        f_k = lambda: fwd(*args)                  # noqa: E731
        f_p = lambda: fwd_plain(*args)            # noqa: E731
        b_k = lambda: bwd(*args, dout)            # noqa: E731
        b_p = lambda: bwd_plain(*args, dout)      # noqa: E731
        fp1, fk1, fk2, fp2, bp1, bk1, bk2, bp2 = (
            cuda_ms(f, iters) for f in (f_p, f_k, f_k, f_p, b_p, b_k, b_k, b_p))
        res = (err, (fk1 + fk2) / 2, (fp1 + fp2) / 2, abs_err, rel_err,
               (bk1 + bk2) / 2, (bp1 + bp2) / 2)
        results[name] = res
        (fb, fby), (bb, bby) = (f(n, p, hid, t, rows) for f in bounds)
        ftc, btc = (f(n, p, hid, t, rows, tensor_cores=True)[0]
                    for f in bounds)
        log(f"{labels[0]}/{labels[1]} vs plain [{name}: N={n} P={p} H={hid} "
            f"T={t}, kept steps {_kept(rows)}]: {labels[0]} max_abs_err "
            f"{err:.3e} (tol {TOL:.0e}), kernel {res[1]:.3f} ms, plain "
            f"{res[2]:.3f} ms, bound f32 {fb:.3f} ms ({fby}), 3xTF32 "
            f"{ftc:.3f} ms; {labels[1]} bitwise repeatable, max error "
            f"{rel_err:.2e} of max|plain| (tol {BWD_TOL:.0e}), kernel "
            f"{res[5]:.3f} ms, plain {res[6]:.3f} ms, bound f32 {bb:.3f} ms "
            f"({bby}), 3xTF32 {btc:.3f} ms: {btc / res[5]:.1%} of it; order "
            f"plain, kernel, kernel, plain: "
            f"{fp1:.3f} {fk1:.3f} {fk2:.3f} {fp2:.3f} / {bp1:.3f} {bk1:.3f} "
            f"{bk2:.3f} {bp2:.3f}")
        del args, dout
        torch.cuda.empty_cache()
    return results


def small_config(tmp: str, size: int = 64, variant: str = "",
                 color_gradient: bool = True):
    from sketchyscenecolorization_torch.config import (
        BGGanConfig, FGGanConfig, FrameworkConfig, MatchingConfig,
        PipelineConfig)
    return FrameworkConfig(
        matching=MatchingConfig(vf_h=size // 8, vf_w=size // 8, H=size,
                                W=size, vocab_size=16, w_emb_dim=16,
                                v_emb_dim=16, m_rnn_size=8, w_rnn_size=16,
                                max_len=6, **VARIANTS.get(variant, {})),
        fg_gan=FGGanConfig(image_size=size, vocab_size=16, max_len=6,
                           base_channels=4, noise_dim=8),
        bg_gan=BGGanConfig(image_size=size, vocab_size=16, max_len=8, ngf=4,
                           ndf=4, multi_residual=False),
        pipeline=PipelineConfig(
            data_base_dir=os.path.join(tmp, "examples"),
            results_base_dir=os.path.join(tmp, "outputs"),
            match_vocab_path="", fg_vocab_path="", bg_vocab_path="",
            match_ckpt_dir="", fg_ckpt_dir="", bg_ckpt_dir="",
            image_size=size, instance_size=size,
            color_gradient=color_gradient, device_compositing=False))


def run_sequence(session, eligible, texts):
    """colorize, a forced FG pass, withdraw, colorize.  Returns the matched
    instances of each text and the wall time of each command."""
    import torch
    times, matched = {}, {}
    t0 = time.perf_counter()
    session.colorize(IMAGE_ID, texts[0])
    torch.cuda.synchronize()
    times["color"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    session.colorize_foreground(IMAGE_ID, texts[0], eligible,
                                f"{IMAGE_ID}_forced.png", f"{IMAGE_ID}_1.png")
    torch.cuda.synchronize()
    times["forced_fg"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    session.withdraw(IMAGE_ID)
    times["withdraw"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    session.colorize(IMAGE_ID, texts[1])
    torch.cuda.synchronize()
    times["color_2"] = time.perf_counter() - t0
    for text in texts:
        matched[text] = session.match_instances(IMAGE_ID, text)
    return matched, times


def read_outputs(tmp):
    from PIL import Image
    rec = os.path.join(tmp, "outputs", "update_records",
                       f"{IMAGE_ID}_records.json")
    d = os.path.join(tmp, "outputs", "results", str(IMAGE_ID))
    images = {n: np.array(Image.open(os.path.join(d, n)).convert("RGB"))
              for n in sorted(os.listdir(d))}
    with open(rec, "rb") as f:
        return f.read(), images


def check_against_cpu(build_session, variant: str = ""):
    """The CUDA session against the CPU session on a small scene, with the
    default fusion or the ``variant`` of VARIANTS; the CUDA run must launch
    the fusion's forward kernel and the CPU run none."""
    texts = ["the bus is yellow", "the car is red"]
    runs = []
    fwd_name = FUSION_KERNELS[variant][0]
    for device in ("cuda", "cpu"):
        tmp = tempfile.mkdtemp(prefix=f"smoke_small_{device}_")
        eligible = write_scene(os.path.join(tmp, "examples"), 64)
        session = build_session(small_config(tmp, variant=variant), seed=0,
                                device=device)
        reset_counts()
        matched, _ = run_sequence(session, eligible, texts)
        launched = read_counts()[fwd_name]
        if (launched < 1) if device == "cuda" else launched:
            raise AssertionError(f"{fwd_name}: {launched} launches in the "
                                 f"{device} session")
        runs.append((matched, *read_outputs(tmp)))
    (m_gpu, rec_gpu, img_gpu), (m_cpu, rec_cpu, img_cpu) = runs
    if m_gpu != m_cpu or rec_gpu != rec_cpu or sorted(img_gpu) != sorted(img_cpu):
        raise AssertionError(f"CUDA vs CPU session: matched {m_gpu} vs "
                             f"{m_cpu}, records equal {rec_gpu == rec_cpu}, "
                             f"files {sorted(img_gpu)} vs {sorted(img_cpu)}")
    inner = session._state(IMAGE_ID).inner_mask
    worst = 0
    for name, want in img_cpu.items():
        diff = np.abs(img_gpu[name].astype(int) - want.astype(int))
        worst = max(worst, int(diff.max()))
        if diff.max() > 1 or diff[inner == 0].any():
            raise AssertionError(f"CUDA vs CPU canvas {name}: max diff "
                                 f"{diff.max()}, outside inner masks "
                                 f"{int(diff[inner == 0].max())}")
    log(f"small scene{' (' + variant + ' fusion)' if variant else ''}, CUDA "
        f"vs CPU session: matched {m_gpu}, records byte-equal, "
        f"{len(img_cpu)} canvases, max diff {worst} LSB")


# BG first (the records' merge starts from the default BG text), a FG
# command, a BG one that merges with the first, withdraw, BG again
MIXED_SEQUENCE = ["the sky is blue", "the bus is yellow", "the ground is green",
                  None, "the sky is red and the ground is brown"]


def run_mixed(session, sequence=MIXED_SEQUENCE):
    for text in sequence:
        if text is None:
            session.withdraw(IMAGE_ID)
        else:
            session.colorize(IMAGE_ID, text)


def check_bg_against_cpu(build_session):
    """The mixed FG/BG sequence through a CUDA and a CPU session on a small
    scene, with the same seeded weights and the sky gradient off (its
    sky-colour vote could move on a 1-LSB generator difference): records
    byte-equal (the merged BG texts included), canvases within 1 uint8 LSB
    and byte-equal on the drawings; the CUDA run launches B1 (the BG and
    FG generators' text fusion), the CPU run no kernel."""
    runs = []
    for device in ("cuda", "cpu"):
        tmp = tempfile.mkdtemp(prefix=f"smoke_bg_small_{device}_")
        write_scene(os.path.join(tmp, "examples"), 64)
        session = build_session(small_config(tmp, color_gradient=False),
                                seed=0, device=device)
        reset_counts()
        run_mixed(session)
        launched = read_counts()["mlstm_fwd"]
        if (launched < 1) if device == "cuda" else launched:
            raise AssertionError(f"mlstm_fwd: {launched} launches in the "
                                 f"{device} BG session")
        runs.append(read_outputs(tmp))
    (rec_gpu, img_gpu), (rec_cpu, img_cpu) = runs
    if rec_gpu != rec_cpu or sorted(img_gpu) != sorted(img_cpu):
        raise AssertionError(f"CUDA vs CPU BG session: records equal "
                             f"{rec_gpu == rec_cpu}, files {sorted(img_gpu)} "
                             f"vs {sorted(img_cpu)}")
    state = session._state(IMAGE_ID)
    inside = state.inner_mask != 0
    worst = {"outside": 0, "inside": 0}
    for name, want in img_cpu.items():
        diff = np.abs(img_gpu[name].astype(int) - want.astype(int))
        worst["outside"] = max(worst["outside"], int(diff[~inside].max()))
        worst["inside"] = max(worst["inside"], int(diff[inside].max()))
        if diff.max() > 1 or diff[state.drawings_region].any():
            raise AssertionError(f"CUDA vs CPU BG canvas {name}: max diff "
                                 f"{diff.max()}, on the drawings "
                                 f"{int(diff[state.drawings_region].max())}")
    records = json.loads(rec_gpu)
    log(f"small scene, mixed FG/BG sequence, CUDA vs CPU session: records "
        f"byte-equal ({[r['colorization_type'] for r in records]}, "
        f"proc_bg_text {[r['proc_bg_text'] for r in records]}), "
        f"{len(img_cpu)} canvases, max diff {worst['outside']} LSB outside "
        f"the inner masks and {worst['inside']} inside (tol 1), 0 on the "
        f"drawings")


class BGSpans:
    """Times the parts of a BG command on ``session``: the generator's
    forward in CUDA events, and on the host clock the BG engine's call
    (upload, forward, fetch), the sky gradient and the PNG writes.  The
    hooks stay in place until ``close``."""

    def __init__(self, session):
        import torch
        from sketchyscenecolorization_torch.pipeline import session as smod
        self.torch, self.smod, self.comp = torch, smod, smod.comp
        self.events, self.host = [], {}
        model = session.bg.model

        def pre(_module, _inputs):
            self.events.append([torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True)])
            self.events[-1][0].record()

        def post(_module, _inputs, _outputs):
            self.events[-1][1].record()
        self.hooks = [model.register_forward_pre_hook(pre),
                      model.register_forward_hook(post)]
        self.saved = {"engine": (session.bg, "colorize"),
                      "gradient": (self.comp, "add_color_gradient"),
                      "png": (smod, "write_png")}
        self.originals = {k: getattr(*v) for k, v in self.saved.items()}
        for label, (owner, attr) in self.saved.items():
            setattr(owner, attr, self._timed(label, self.originals[label]))

    def _timed(self, label, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.host[label] = self.host.get(label, 0.0) + \
                    time.perf_counter() - t0
        return timed

    def take(self):
        """{part: ms} of the commands since the last ``take``."""
        self.torch.cuda.synchronize()
        out = {k: v * 1e3 for k, v in self.host.items()}
        out["generator (device)"] = sum(a.elapsed_time(b)
                                        for a, b in self.events)
        self.events, self.host = [], {}
        return out

    def close(self):
        for hook in self.hooks:
            hook.remove()
        for label, (owner, attr) in self.saved.items():
            if label == "engine":
                delattr(owner, attr)        # back to the class's method
            else:
                setattr(owner, attr, self.originals[label])


# after a FG command with no BG text in the records the first BG text must
# name both the sky and the ground, as in the reference
def conv_flop_hooks(model):
    """Forward hooks on the BG generator's convolutions that add up the
    operations each call needs (2 per multiply-add) from its shapes:
    returns ({"conv": ops, "deconv": ops}, the hooks)."""
    from sketchyscenecolorization_torch.models import bg_gan
    flops = {"conv": 0.0, "deconv": 0.0}

    def count(module, inputs, out):
        w = module.filter
        if isinstance(module, bg_gan.Deconv):    # every input pixel meets
            x = inputs[0]                        # the whole 4x4 kernel
            flops["deconv"] += 2.0 * x.shape[0] * x.shape[1] * x.shape[2] \
                * w.numel()
        else:
            flops["conv"] += 2.0 * out.shape[0] * out.shape[1] \
                * out.shape[2] * w.numel()
    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (bg_gan.Conv, bg_gan.ConvEx, bg_gan.Deconv))]
    return flops, hooks


BG_TEXTS = ["the sky is blue and the ground is green", "the ground is brown",
            "the sky is cyan", "the sky is orange and the ground is yellow",
            "the ground is green", "the sky is blue"]
BG_WARM = 12        # warm BG commands timed for the median
# substrings of cuDNN's and cuBLAS's convolution kernel names
CONV_KERNEL_WORDS = ("conv", "gemm", "xmma", "wgrad", "dgrad", "fft",
                     "winograd")


def full_width_bg(build_session, card):
    """The BG branch of ``color`` at the default full-width configuration
    (ResidualGenerator, ngf 64, multi_residual, 768^2) on the synthetic
    scene with fresh seeded weights: the sky gradient's 24-bit LUT built
    and timed apart, a FG command, then the first BG command of the
    session (cold) and BG_WARM warm ones with their parts timed
    (``BGSpans``), then the results and the generator's outputs checked.  Returns the launch counts
    of the BG commands."""
    import torch
    from PIL import Image
    from sketchyscenecolorization_torch.config import (FrameworkConfig,
                                                       PipelineConfig)
    from sketchyscenecolorization_torch.pipeline import compositing as comp
    from sketchyscenecolorization_torch.text import colorization_encode
    tmp = tempfile.mkdtemp(prefix="smoke_bg_full_")
    cfg = FrameworkConfig(pipeline=PipelineConfig(
        data_base_dir=os.path.join(tmp, "examples"),
        results_base_dir=os.path.join(tmp, "outputs"),
        match_vocab_path=os.path.join(ROOT, "data", "match_vocab.txt"),
        fg_vocab_path=os.path.join(ROOT, "data", "fg_vocab.txt"),
        bg_vocab_path=os.path.join(ROOT, "data", "bg_vocab.txt"),
        match_ckpt_dir="", fg_ckpt_dir="", bg_ckpt_dir="",
        device_compositing=False))
    b = cfg.bg_gan
    write_scene(os.path.join(tmp, "examples"), cfg.pipeline.image_size)

    comp._rgb_roundtrip_lut()           # wait for a build an earlier
    comp._ROUNDTRIP_LUT = None          # session started, then time one
    t0 = time.perf_counter()
    comp._rgb_roundtrip_lut()
    lut_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    session = build_session(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in session.bg.model.parameters())
    log(f"full-width BG: ResidualGenerator ngf {b.ngf}, multi_residual "
        f"{b.multi_residual}, {b.image_size}^2, {n_params / 1e6:.1f}M "
        f"parameters; 24-bit sky-gradient LUT built in {lut_s:.3f} s (apart); "
        f"build_session {build_s:.3f} s")
    state = session._state(IMAGE_ID)   # fixture decode: set-up, not timed
    session.colorize(IMAGE_ID, "the bus is yellow")   # a FG result under it
    spans = BGSpans(session)
    torch.cuda.reset_peak_memory_stats()

    reset_counts()                                    # path starts
    t0 = time.perf_counter()
    session.colorize(IMAGE_ID, BG_TEXTS[0])
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    cold_parts = spans.take()
    walls, parts = [], []
    for i in range(BG_WARM):
        t0 = time.perf_counter()
        session.colorize(IMAGE_ID, BG_TEXTS[(i + 1) % len(BG_TEXTS)])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        parts.append(spans.take())
        parts[-1]["rest (host)"] = walls[-1] * 1e3 - sum(
            parts[-1].get(k, 0.0) for k in ("engine", "gradient", "png"))
    counts = read_counts()                            # path ends
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    spans.close()
    if counts["mlstm_fwd"] != BG_WARM + 1:
        raise AssertionError(f"{counts['mlstm_fwd']} B1 launches in "
                             f"{BG_WARM + 1} BG commands, expected one each")

    results = os.path.join(tmp, "outputs", "results", str(IMAGE_ID))
    with open(os.path.join(tmp, "outputs", "update_records",
                           f"{IMAGE_ID}_records.json")) as fh:
        records = json.load(fh)
    last = records[-1]
    if len(records) != BG_WARM + 2 or last["colorization_type"] != "BG":
        raise AssertionError(f"records after the BG run: {records[-3:]}")
    final = np.array(Image.open(os.path.join(results, last["result_name"])))
    previous = np.array(Image.open(os.path.join(results,
                                                records[-2]["result_name"])))
    inside = state.inner_mask != 0
    if final.shape != (b.image_size, b.image_size, 3) or \
            not (final[inside] == previous[inside]).all() or \
            not (final[state.drawings_region]
                 == state.moved[state.drawings_region]).all():
        raise AssertionError("BG result: FG pixels or the drawings changed")
    if (final[~inside & ~state.drawings_region] == 255).all():
        raise AssertionError("BG result: the background stayed white")
    with torch.no_grad():
        x = torch.rand(1, b.image_size, b.image_size, 3, device="cuda") * 2 - 1
        tokens = torch.tensor([colorization_encode(BG_TEXTS[0],
                                                   session.bg.vocab,
                                                   b.max_len)], device="cuda")
        flops, hooks = conv_flop_hooks(session.bg.model)
        (rgb, region), gen_wall, kernels = profile_kernels(
            lambda: session.bg.model(x, tokens))
        for hook in hooks:
            hook.remove()
    s = b.image_size
    if rgb.shape != (1, s, s, 3) or region.shape != (1, s, s, b.seg_classes) \
            or not (torch.isfinite(rgb).all() and torch.isfinite(region).all()):
        raise AssertionError(f"BG generator outputs {tuple(rgb.shape)}, "
                             f"{tuple(region.shape)} not finite")

    median = float(np.median(walls))
    share = {k: float(np.median([p.get(k, 0.0) for p in parts]))
             for k in parts[0]}
    log(f"  on {card}: cold first BG command {cold:.3f} s (parts ms: "
        + ", ".join(f"{k} {v:.1f}" for k, v in cold_parts.items()) + ")")
    log(f"  warm BG color on {card}: median {median * 1e3:.1f} ms over "
        f"{len(walls)} (min {min(walls) * 1e3:.1f}, max "
        f"{max(walls) * 1e3:.1f}); "
        f"medians of the parts: "
        + ", ".join(f"{k} {v:.1f} ms ({v / (median * 1e3):.1%})"
                    for k, v in share.items())
        + f"; peak device memory {peak:.2f} GiB; B1 launches "
          f"{counts['mlstm_fwd']} (one a command, P = 576, H = 1024, T = 8)")
    total = sum(kernels.values())
    if total <= 0:
        raise AssertionError("torch.profiler saw no device time for the BG "
                             f"generator: {sorted(kernels)[:20]}")
    convs = sum(v for k, v in kernels.items()
                if any(w in k.lower() for w in CONV_KERNEL_WORDS))
    conv_ops = sum(flops.values())
    conv_bound, _ = bound(conv_ops, 0.0)
    log(f"  one generator forward under torch.profiler (wall "
        f"{gen_wall * 1e3:.1f} ms): device kernel time {total:.2f} ms in "
        f"{len(kernels)} kernel names, convolutions {convs:.2f} ms "
        f"({convs / total:.1%}) for {conv_ops / 1e9:.1f} GFLOP (conv "
        f"{flops['conv'] / 1e9:.1f}, transposed {flops['deconv'] / 1e9:.1f}"
        f"): {conv_ops / convs / 1e9:.1f} TFLOP/s, f32 bound "
        f"{conv_bound:.2f} ms ({conv_bound / convs:.1%}), B1 "
        f"{sum(v for k, v in kernels.items() if B1_NAMES[0] in k):.3f} ms; "
        f"top kernels:")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {ms:8.3f} ms  {name[:100]}")
    return counts


def full_size_run(build_session, mlstm):
    import torch
    from PIL import Image
    from sketchyscenecolorization_torch.config import (FrameworkConfig,
                                                       PipelineConfig)
    tmp = tempfile.mkdtemp(prefix="smoke_full_")
    cfg = FrameworkConfig(pipeline=PipelineConfig(
        data_base_dir=os.path.join(tmp, "examples"),
        results_base_dir=os.path.join(tmp, "outputs"),
        match_vocab_path=os.path.join(ROOT, "data", "match_vocab.txt"),
        fg_vocab_path=os.path.join(ROOT, "data", "fg_vocab.txt"),
        bg_vocab_path=os.path.join(ROOT, "data", "bg_vocab.txt"),
        match_ckpt_dir="", fg_ckpt_dir="", bg_ckpt_dir="",
        device_compositing=False))
    m, f = cfg.matching, cfg.fg_gan
    eligible = write_scene(os.path.join(tmp, "examples"), m.H)
    log(f"full-width config: ResNet-101 at {m.H}x{m.W}, m_rnn {m.m_rnn_size},"
        f" w_rnn {m.w_rnn_size}, FG {f.image_size}^2 base_channels "
        f"{f.base_channels}; eligible instances {eligible}")
    t0 = time.perf_counter()
    session = build_session(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"build_session (fresh parameters): "
        f"{time.perf_counter() - t0:.3f} s")
    text = "the bus is yellow"
    state = session._state(IMAGE_ID)    # fixture decode: set-up, not timed
    torch.cuda.reset_peak_memory_stats()

    reset_counts()                                    # main path starts
    t0 = time.perf_counter()
    session.colorize(IMAGE_ID, text)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    after_color = mlstm.mlstm_cuda.launches
    session.colorize_foreground(IMAGE_ID, text, eligible,
                                f"{IMAGE_ID}_forced.png", f"{IMAGE_ID}_1.png")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    after_forced = mlstm.mlstm_cuda.launches
    launches = read_counts()                          # main path ends
    if after_color < 1 or after_forced - after_color < 1:
        raise AssertionError(f"kernel launches: {after_color} in the color "
                             f"command, {after_forced - after_color} in the "
                             "forced FG pass; expected >= 1 each")
    log(f"kernel launches on the main path: {after_color} in the color "
        f"command (matching), {after_forced - after_color} in the forced FG "
        f"pass (generator); cold wall times: color {t1 - t0:.3f} s, forced "
        f"FG pass {t2 - t1:.3f} s")

    # the same commands again, timed with the kernels warm
    records_dir = os.path.join(tmp, "outputs", "update_records")
    rec_path = os.path.join(records_dir, f"{IMAGE_ID}_records.json")
    with open(rec_path) as fh:
        n_before = len(json.load(fh))
    texts = ["the yellow bus with gray windows", "the car is red"]
    matched, times = run_sequence(session, eligible, texts)
    with open(rec_path) as fh:
        records = json.load(fh)
    if len(records) != n_before + 1 or records[-1]["input_text"] != texts[1]:
        raise AssertionError(f"records after color/withdraw/color: {records}")

    results = os.path.join(tmp, "outputs", "results", str(IMAGE_ID))
    forced = np.array(Image.open(os.path.join(results,
                                              f"{IMAGE_ID}_forced.png")))
    if forced.shape != (m.H, m.W, 3) or forced.dtype != np.uint8:
        raise AssertionError(f"forced result {forced.shape} {forced.dtype}")
    for i in eligible:
        region = state.inner_mask == i + 1
        if (forced[region] == 255).all():
            raise AssertionError(f"instance {i} left white by the forced pass")
    if not (forced[state.drawings_region]
            == state.moved[state.drawings_region]).all():
        raise AssertionError("stroke overlay missing from the result")

    # finite model outputs at full width (after the counted run)
    dev, k = session.device, len(eligible)
    with torch.no_grad():
        words, lens = session.matching.encode_texts([text])
        up = session.matching.model.apply_fused(
            state.visual_dev, torch.from_numpy(words).long().to(dev),
            torch.from_numpy(lens).long().to(dev)).up
        rows = torch.from_numpy(np.stack(
            [state.prepared_instance(i, f.image_size) for i in eligible]))
        gen = session.fg.model(
            rows.to(dev), torch.ones(k, f.max_len, dtype=torch.long).to(dev),
            torch.zeros(k, dtype=torch.long).to(dev),
            torch.randn(k, f.noise_dim).to(dev), per_sample=True)
    if up.shape != (1, m.H, m.W, 1) or not torch.isfinite(up).all():
        raise AssertionError(f"matching logits {tuple(up.shape)} not finite")
    s = f.image_size
    if gen.shape != (k, s, s, 3) or not torch.isfinite(gen).all():
        raise AssertionError(f"generator output {tuple(gen.shape)} not finite")

    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"full-width session: matched {matched}; "
        + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
        + f" (warm, new texts); peak device memory "
          f"{peak:.2f} GiB")
    return launches


def matching_batch(rng, cfg):
    """A seeded batch at the shapes of ``make_matching_train_step``."""
    image = rng.randn(1, cfg.H, cfg.W, 3).astype(np.float32) * 50
    words = np.zeros((1, cfg.max_len), np.int32)
    words[0, :3] = rng.randint(1, cfg.vocab_size, 3)
    target = (rng.rand(1, cfg.H, cfg.W, 1) > 0.5).astype(np.float32)
    return {"image": image, "words": words,
            "seq_len": np.array([3], np.int32), "target_mask": target}


# A bias added to every word's logit before a softmax, which cannot see it:
# its gradient is zero up to rounding, so its Adam updates are rounding
# noise and it is neither compared across devices nor required to move.
SHIFT_INVARIANT = ("text_sketchyscene.attn_fc.biases",)


def check_training_against_cpu(variant: str = ""):
    """Three matching train steps at a small config on CUDA and on the CPU
    from the same seeded weights and batches, with the default fusion or
    the ``variant`` of VARIANTS.  Text leaves agree within 3e-2 lr; for a
    variant fusion an element whose gradient is near Adam's eps may differ
    more (a rounding difference in a gradient of 1e-8 moves its update by
    a large part of lr), so there at most 1e-4 of a leaf's elements may
    exceed that, by at most 10 lr."""
    import torch
    from sketchyscenecolorization_torch.config import MatchingConfig
    from sketchyscenecolorization_torch.models.rmi import RMI
    from sketchyscenecolorization_torch.parallel import to_device
    from sketchyscenecolorization_torch.train import (
        create_matching_state, make_matching_train_step)
    cfg = MatchingConfig(vf_h=6, vf_w=6, H=48, W=48, vocab_size=12,
                         w_emb_dim=16, v_emb_dim=16, m_rnn_size=8,
                         w_rnn_size=16, max_len=5, lr_decay_step=100,
                         **VARIANTS.get(variant, {}))
    fwd_name, bwd_name = FUSION_KERNELS[variant]
    cost_rtol, leaf_atol = 1e-4, 3 * 1e-2 * cfg.start_lr
    init = RMI(cfg, torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.RandomState(0)
    batches = [matching_batch(rng, cfg) for _ in range(3)]
    runs = {}
    for device in ("cuda", "cpu"):
        model = RMI(cfg)
        model.load_state_dict(init)
        state = create_matching_state(model.to(device), cfg)
        step = make_matching_train_step(cfg)
        reset_counts()
        costs = []
        for batch in batches:
            state, metrics = step(state, to_device(batch, device))
            costs.append(float(metrics["cost"]))
        counts = read_counts()
        runs[device] = (costs, {k: v.detach().cpu() for k, v in
                                model.state_dict().items()},
                        counts[fwd_name], counts[bwd_name])
    (c_gpu, w_gpu, f_gpu, b_gpu), (c_cpu, w_cpu, f_cpu, b_cpu) = \
        runs["cuda"], runs["cpu"]
    if f_gpu < 3 or b_gpu < 3 or f_cpu or b_cpu:
        raise AssertionError(f"launches {fwd_name}/{bwd_name}: CUDA "
                             f"{f_gpu}/{b_gpu}, CPU {f_cpu}/{b_cpu}; expected "
                             ">= 3 on CUDA only")
    cost_err = max(abs(a / b - 1) for a, b in zip(c_gpu, c_cpu))
    if not (np.isfinite(c_gpu).all() and cost_err <= cost_rtol):
        raise AssertionError(f"costs CUDA {c_gpu} vs CPU {c_cpu}")
    leaf_err, n_over = 0.0, 0
    for key, want in w_cpu.items():
        if key.startswith("ResNet."):
            if not (torch.equal(w_gpu[key], init[key])
                    and torch.equal(want, init[key])):
                raise AssertionError(f"{key} moved")
            continue
        if key in SHIFT_INVARIANT:
            if not torch.isfinite(w_gpu[key]).all():
                raise AssertionError(f"{key} not finite")
            continue
        diff = (w_gpu[key] - want).abs()
        if torch.equal(want, init[key]):
            raise AssertionError(f"{key} did not move")
        over = int((diff > leaf_atol).sum())
        if over and not (variant and over <= 1e-4 * diff.numel()
                         and float(diff.max()) <= 10 * cfg.start_lr):
            raise AssertionError(f"{key} CUDA vs CPU: {over} elements beyond "
                                 f"{leaf_atol}, max-abs {float(diff.max())}")
        n_over += over
        leaf_err = max(leaf_err,
                       float(diff.masked_fill(diff > leaf_atol, 0).max()))
    log(f"small-config matching training{' (' + variant + ' fusion)' if variant else ''}"
        f", 3 steps, CUDA vs CPU: costs {[f'{c:.4f}' for c in c_gpu]}, max "
        f"relative difference {cost_err:.2e} (tol {cost_rtol:.0e}); text "
        f"leaves max-abs {leaf_err:.2e} (tol {leaf_atol:.1e}; {n_over} "
        f"near-eps elements beyond it); ResNet bit-unchanged; {f_gpu} "
        f"{fwd_name} and {b_gpu} {bwd_name} launches on CUDA")


def write_matching_corpus(base: str, size: int, n_images: int = 2):
    """Synthetic training split in the layout ``load_data_gt`` reads
    (``train/DRAWING_GT`` PNG, ``train/INSTANCE_GT`` and ``train/CLASS_GT``
    .mat with sparse instance ids) plus ``sentence_instance_train.json``."""
    import scipy.io
    from PIL import Image
    train = os.path.join(base, "train")
    for sub in ("DRAWING_GT", "INSTANCE_GT", "CLASS_GT"):
        os.makedirs(os.path.join(train, sub), exist_ok=True)
    line = max(1, size // 256)
    captions = []
    for image_id in range(1, n_images + 1):
        sketch = np.full((size, size, 3), 255, np.uint8)
        inst = np.zeros((size, size), np.uint8)
        cls = np.zeros((size, size), np.uint8)
        shift = int(0.03 * size) * (image_id - 1)
        for i, (cat, _, frac) in enumerate(INSTANCES):
            y1, x1, y2, x2 = (int(f * size) for f in frac)
            x1, x2 = x1 + shift, x2 + shift
            box = sketch[y1:y2 + 1, x1:x2 + 1]
            box[:line], box[-line:], box[:, :line], box[:, -line:] = 0, 0, 0, 0
            inst[y1:y2 + 1, x1:x2 + 1] = 2 * i + 3
            cls[y1:y2 + 1, x1:x2 + 1] = cat
        Image.fromarray(sketch).save(os.path.join(
            train, "DRAWING_GT", f"L0_sample{image_id}.png"))
        scipy.io.savemat(os.path.join(
            train, "INSTANCE_GT", f"sample_{image_id}_instance.mat"),
            {"INSTANCE_GT": inst})
        scipy.io.savemat(os.path.join(
            train, "CLASS_GT", f"sample_{image_id}_class.mat"),
            {"CLASS_GT": cls})
        caps = {f"the {name}": [i] for i, (_, name, _) in enumerate(INSTANCES)}
        caps["the bus and the car"] = [0, 1]
        captions.append({"key": image_id, "sen_instIdx_map": caps})
    with open(os.path.join(base, "sentence_instance_train.json"), "w") as f:
        json.dump(captions, f)


def profile_kernels(fn):
    """``fn()`` under ``torch.profiler``: (its result, wall s, {kernel
    name: device ms})."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0 and getattr(ev, "device_type", None) != \
                torch.autograd.DeviceType.CPU:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3
    return result, wall, kernels


def profile_step(step, state, batch):
    """One train step under ``torch.profiler``: (state, metrics, wall s,
    {kernel name: device ms})."""
    (state, metrics), wall, kernels = profile_kernels(
        lambda: step(state, batch))
    return state, metrics, wall, kernels


def full_width_training(mlstm):
    """``cli_matching --mode train`` at the default full-width config on a
    synthetic corpus, then resumed.  Returns ({"mlstm_fwd": launches,
    "mlstm_bwd": launches}, the corpus directory, whose ``run`` holds the
    snapshots, and the trained module)."""
    import torch
    from sketchyscenecolorization_torch import cli_matching
    from sketchyscenecolorization_torch.config import MatchingConfig
    from sketchyscenecolorization_torch.models.rmi import RMI
    from sketchyscenecolorization_torch.train import harness
    from sketchyscenecolorization_torch.utils.checkpoint import (
        latest_checkpoint, restore_checkpoint)
    cfg = MatchingConfig()
    tmp = tempfile.mkdtemp(prefix="smoke_train_")
    write_matching_corpus(tmp, cfg.H)
    run_dir = os.path.join(tmp, "run")
    argv = ["--mode", "train", "--data_base_dir", tmp,
            "--captions_base_dir", tmp,
            "--vocab_path", os.path.join(ROOT, "data", "match_vocab.txt"),
            "--run_dir", run_dir]
    log(f"full-width matching training: ResNet-101 at {cfg.H}x{cfg.W} "
        f"(frozen), m_rnn {cfg.m_rnn_size}, w_rnn {cfg.w_rnn_size}, T "
        f"{cfg.max_len}, batch 1, synthetic corpus of 2 images x 5 captions")

    records, profiled, trained = [], {}, {}
    make_step = harness.make_matching_train_step

    def instrumented(step_cfg):
        step = make_step(step_cfg)

        def timed(state, batch):
            trained["model"] = state.model
            fwd, bwd = mlstm.mlstm_cuda.launches, mlstm.mlstm_bwd_cuda.launches
            if len(records) + 1 == PROFILED_STEP:
                state, metrics, wall, kernels = profile_step(step, state,
                                                             batch)
                profiled.update(kernels=kernels, wall=wall)
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            records.append((wall, mlstm.mlstm_cuda.launches - fwd,
                            mlstm.mlstm_bwd_cuda.launches - bwd,
                            float(metrics["cost"]), float(metrics["cls_loss"]),
                            int((batch["words"] != 0).sum())))
            return state, metrics
        return timed

    torch.cuda.reset_peak_memory_stats()
    reset_counts()                                                 # path
    harness.make_matching_train_step = instrumented
    try:
        cli_matching.main(argv + ["--max_iteration", str(TRAIN_STEPS)])
        first = latest_checkpoint(os.path.join(run_dir, "snapshots"))
        cli_matching.main(argv + ["--max_iteration",
                                  str(TRAIN_STEPS + RESUME_STEPS)])
    finally:
        harness.make_matching_train_step = make_step
    launches = read_counts()                                       # ends
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    last = latest_checkpoint(os.path.join(run_dir, "snapshots"))

    if len(records) != TRAIN_STEPS + RESUME_STEPS:
        raise AssertionError(f"{len(records)} steps ran, expected "
                             f"{TRAIN_STEPS} then {RESUME_STEPS} resumed")
    if first is None or first[0] != TRAIN_STEPS or last[0] != \
            TRAIN_STEPS + RESUME_STEPS:
        raise AssertionError(f"snapshots: {first} after the first run, "
                             f"{last} after the resumed run")
    for i, (_, fwd, bwd, cost, cls, _) in enumerate(records):
        if fwd < 1 or bwd < 1 or not np.isfinite([cost, cls]).all():
            raise AssertionError(f"step {i + 1}: {fwd} B1 and {bwd} B2 "
                                 f"launches, cost {cost}, cls_loss {cls}")
    init = RMI(cfg, torch.Generator().manual_seed(0)).state_dict()
    saved = restore_checkpoint(last[1])
    if saved["step"] != last[0]:
        raise AssertionError(f"snapshot step {saved['step']} != {last[0]}")
    moved = []
    for key, value in saved["model"].items():
        same = torch.equal(value.cpu(), init[key])
        if key.startswith("ResNet.") and not same:
            raise AssertionError(f"{key} moved in training")
        if key.startswith("text_sketchyscene.") and not same:
            moved.append(key)
    text_keys = [k for k in init if k.startswith("text_sketchyscene.")]
    if sorted(moved) != sorted(text_keys):
        raise AssertionError(f"text leaves that did not move: "
                             f"{sorted(set(text_keys) - set(moved))}")

    walls = [r[0] for r in records]
    warm = [w for i, w in enumerate(walls) if i not in
            (0, TRAIN_STEPS, PROFILED_STEP - 1)]
    kernels = profiled["kernels"]
    total = sum(kernels.values())
    b2_ms, b1_ms = (sum(v for k, v in kernels.items()
                        if any(name in k for name in names))
                    for names in (B2_NAMES, B1_NAMES))
    if total <= 0 or b2_ms <= 0 or b1_ms <= 0:
        raise AssertionError("torch.profiler saw no device time for the "
                             f"kernels: {sorted(kernels)[:20]}")
    log(f"  losses (cost, cls_loss) per step: "
        + ", ".join(f"{c:.1f}/{l:.1f}" for _, _, _, c, l, _ in records)
        + f"; words per step {[r[5] for r in records]} (B1 and B2 run one "
        f"step per word)")
    log(f"  launches per step (B1, B2): "
        f"{[(r[1], r[2]) for r in records]}; on this path B1 "
        f"{launches['mlstm_fwd']}, B2 {launches['mlstm_bwd']}")
    log(f"  snapshot at step {first[0]}, resumed to step {last[0]}; "
        f"{len(moved)} text leaves moved, ResNet bit-unchanged")
    median_ms = float(np.median(warm)) * 1e3
    log(f"  step wall: first {walls[0]:.3f} s, first after resume "
        f"{walls[TRAIN_STEPS]:.3f} s, median warm {median_ms / 1e3:.4f} s "
        f"(n={len(warm)}, min {min(warm):.4f}, max {max(warm):.4f}); peak "
        f"device memory {peak:.2f} GiB")
    log(f"  profiled step {PROFILED_STEP} ({records[PROFILED_STEP - 1][5]} "
        f"words; torch.profiler on, wall "
        f"{profiled['wall'] * 1e3:.1f} ms): device kernel time "
        f"{total:.2f} ms, B2 {b2_ms:.2f} ms ({b2_ms / total:.1%} of device "
        f"time), B1 {b1_ms:.2f} ms; against the median warm step without "
        f"the profiler: B2 {b2_ms / median_ms:.1%} of the wall, device idle "
        f"{1 - total / median_ms:.1%}")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    for name, ms in top:
        log(f"    {ms:8.3f} ms  {name[:100]}")
    return launches, tmp, trained["model"]


def serve_trained(build_session, tmp, trained):
    """A full-width session built on the training run's snapshots
    (``match_ckpt_dir``) holds the trained module's weights and gives its
    ``up`` logits bit for bit on the card."""
    import torch
    from sketchyscenecolorization_torch.config import (FrameworkConfig,
                                                       PipelineConfig)
    cfg = FrameworkConfig(pipeline=PipelineConfig(
        data_base_dir=os.path.join(tmp, "examples"),
        results_base_dir=os.path.join(tmp, "outputs"),
        match_vocab_path=os.path.join(ROOT, "data", "match_vocab.txt"),
        fg_vocab_path="", bg_vocab_path="",
        match_ckpt_dir=os.path.join(tmp, "run", "snapshots"), fg_ckpt_dir="",
        bg_ckpt_dir="", device_compositing=False))
    session = build_session(cfg, seed=1, device="cuda")
    served = session.matching.model
    want = trained.state_dict()
    for key, value in served.state_dict().items():
        if not torch.equal(value, want[key]):
            raise AssertionError(f"served {key} differs from the trained one")
    m = cfg.matching
    rng = np.random.RandomState(5)
    image = torch.from_numpy((rng.randn(1, m.H, m.W, 3) * 50)
                             .astype(np.float32)).cuda()
    words, lens = session.matching.encode_texts(["the bus and the car"])
    words = torch.from_numpy(words).long().cuda()
    lens = torch.from_numpy(lens).long().cuda()
    with torch.no_grad():
        got = served(image, words, lens).up
        ref = trained.eval()(image, words, lens).up
    if not (torch.isfinite(got).all() and torch.equal(got, ref)):
        raise AssertionError("served up logits differ from the trained "
                             f"module's: max-abs {float((got - ref).abs().max())}")
    log(f"session on the training run's snapshots: {len(want)} leaves equal "
        f"the trained module's, up logits {tuple(got.shape)} bit-equal")
    del session


def infer_matching(tmp):
    """``cli_matching --mode inference`` on the training run: restores its
    newest snapshot and writes ``visualize/L0_sample1_pred.png``.  Returns
    the launch counts of the command."""
    import shutil
    import torch
    from PIL import Image
    from sketchyscenecolorization_torch import cli_matching
    val = os.path.join(tmp, "val", "DRAWING_GT")
    os.makedirs(val, exist_ok=True)
    shutil.copy(os.path.join(tmp, "train", "DRAWING_GT", "L0_sample1.png"),
                val)
    run_dir = os.path.join(tmp, "run")
    argv = ["--mode", "inference", "--data_base_dir", tmp, "--vocab_path",
            os.path.join(ROOT, "data", "match_vocab.txt"), "--run_dir",
            run_dir, "--image_id", "1", "--instruction", "the bus"]
    reset_counts()                                    # path starts
    t0 = time.perf_counter()
    cli_matching.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()                            # path ends
    pred = np.array(Image.open(os.path.join(run_dir, "visualize",
                                            "L0_sample1_pred.png")))
    sketch = np.array(Image.open(os.path.join(val, "L0_sample1.png")))
    if pred.shape != sketch.shape or counts["mlstm_fwd"] < 1:
        raise AssertionError(f"inference: prediction {pred.shape}, "
                             f"{counts['mlstm_fwd']} B1 launches")
    changed = int((pred[..., 0] != sketch[..., 0]).sum())
    log(f"cli_matching --mode inference: {wall:.3f} s (model build, "
        f"restore and one prediction), {changed} pixels marked, launches "
        f"{counts['mlstm_fwd']} of B1")
    return counts


def variant_session_run(build_session, variant):
    """The session at full width with the ``variant`` fusion on the
    synthetic 768x768 scene: a ``color`` command (the variant's forward
    kernel launches) and a forced FG pass (B1 in the generator), counted;
    then a warm ``color`` command with a new text.  Returns the launch
    counts of the counted run."""
    import torch
    from sketchyscenecolorization_torch.config import (
        FrameworkConfig, MatchingConfig, PipelineConfig)
    tmp = tempfile.mkdtemp(prefix=f"smoke_full_{variant}_")
    cfg = FrameworkConfig(
        matching=MatchingConfig(**VARIANTS[variant]),
        pipeline=PipelineConfig(
            data_base_dir=os.path.join(tmp, "examples"),
            results_base_dir=os.path.join(tmp, "outputs"),
            match_vocab_path=os.path.join(ROOT, "data", "match_vocab.txt"),
            fg_vocab_path=os.path.join(ROOT, "data", "fg_vocab.txt"),
            bg_vocab_path=os.path.join(ROOT, "data", "bg_vocab.txt"),
            match_ckpt_dir="", fg_ckpt_dir="", bg_ckpt_dir="",
            device_compositing=False))
    m = cfg.matching
    fwd_name = FUSION_KERNELS[variant][0]
    eligible = write_scene(os.path.join(tmp, "examples"), m.H)
    session = build_session(cfg, seed=0, device="cuda")
    state = session._state(IMAGE_ID)    # fixture decode: set-up, not timed
    torch.cuda.reset_peak_memory_stats()
    text = "the bus is yellow"

    reset_counts()                                    # path starts
    t0 = time.perf_counter()
    session.colorize(IMAGE_ID, text)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    after_color = read_counts()
    session.colorize_foreground(IMAGE_ID, text, eligible,
                                f"{IMAGE_ID}_forced.png", f"{IMAGE_ID}_1.png")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = read_counts()                            # path ends
    if after_color[fwd_name] < 1 or \
            counts["mlstm_fwd"] - after_color["mlstm_fwd"] < 1:
        raise AssertionError(f"{variant} session: {after_color[fwd_name]} "
                             f"{fwd_name} launches in the color command, "
                             f"{counts['mlstm_fwd'] - after_color['mlstm_fwd']}"
                             " B1 launches in the forced FG pass")
    t3 = time.perf_counter()
    session.colorize(IMAGE_ID, "the car is red")
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    with torch.no_grad():
        words, lens = session.matching.encode_texts([text])
        up = session.matching.model.apply_fused(
            state.visual_dev, torch.from_numpy(words).long().to("cuda"),
            torch.from_numpy(lens).long().to("cuda")).up
    if up.shape != (1, m.H, m.W, 1) or not torch.isfinite(up).all():
        raise AssertionError(f"{variant} logits {tuple(up.shape)} not finite")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"full-width session, {variant} fusion (m_rnn {m.m_rnn_size}, w_rnn "
        f"{m.w_rnn_size}): launches {counts}; cold color {t1 - t0:.3f} s "
        f"({after_color[fwd_name]} {fwd_name}), forced FG pass {t2 - t1:.3f} s"
        f", warm color (new text) {t4 - t3:.3f} s; up logits finite; peak "
        f"device memory {peak:.2f} GiB")
    return counts


def variant_training(variant):
    """``train_matching`` at full width with the ``variant`` fusion for
    VARIANT_STEPS steps on the synthetic corpus, the last under
    ``torch.profiler``: every step launches the fusion's forward and
    backward kernel, losses are finite, the text leaves move (but
    SHIFT_INVARIANT) and ResNet does not.  Returns the launch counts of the
    run."""
    import torch
    from sketchyscenecolorization_torch.config import MatchingConfig
    from sketchyscenecolorization_torch.data import MatchingTrainDataset
    from sketchyscenecolorization_torch.models.rmi import RMI
    from sketchyscenecolorization_torch.text import load_vocab
    from sketchyscenecolorization_torch.train import harness
    cfg = MatchingConfig(**VARIANTS[variant])
    fwd_name, bwd_name = FUSION_KERNELS[variant]
    tmp = tempfile.mkdtemp(prefix=f"smoke_train_{variant}_")
    write_matching_corpus(tmp, cfg.H)
    ds = MatchingTrainDataset(
        os.path.join(tmp, "train"),
        os.path.join(tmp, "sentence_instance_train.json"),
        load_vocab(os.path.join(ROOT, "data", "match_vocab.txt")),
        max_len=cfg.max_len)
    model = RMI(cfg, torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    records, profiled = [], {}
    make_step = harness.make_matching_train_step

    def instrumented(step_cfg):
        step = make_step(step_cfg)

        def timed(state, batch):
            before = read_counts()
            if len(records) + 1 == VARIANT_STEPS:
                state, metrics, wall, kernels = profile_step(step, state,
                                                             batch)
                profiled.update(kernels=kernels, wall=wall)
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            after = read_counts()
            records.append((wall,
                            after[fwd_name] - before[fwd_name],
                            after[bwd_name] - before[bwd_name],
                            float(metrics["cost"]),
                            float(metrics["cls_loss"]),
                            int((batch["words"] != 0).sum())))
            return state, metrics
        return timed

    torch.cuda.reset_peak_memory_stats()
    reset_counts()                                    # path starts
    harness.make_matching_train_step = instrumented
    try:
        state = harness.train_matching(cfg, ds, model,
                                       os.path.join(tmp, "run"),
                                       log_every=VARIANT_STEPS,
                                       max_iters=VARIANT_STEPS, device="cuda")
    finally:
        harness.make_matching_train_step = make_step
    counts = read_counts()                            # path ends
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if len(records) != VARIANT_STEPS:
        raise AssertionError(f"{len(records)} {variant} steps ran")
    for i, (_, fwd, bwd, cost, cls, _) in enumerate(records):
        if fwd < 1 or bwd < 1 or not np.isfinite([cost, cls]).all():
            raise AssertionError(f"{variant} step {i + 1}: {fwd} {fwd_name} "
                                 f"and {bwd} {bwd_name} launches, cost "
                                 f"{cost}, cls_loss {cls}")
    still = []
    for key, value in state.model.state_dict().items():
        same = torch.equal(value.cpu(), init[key])
        if key.startswith("ResNet.") and not same:
            raise AssertionError(f"{key} moved in {variant} training")
        if key.startswith("text_sketchyscene.") and same and \
                key not in SHIFT_INVARIANT:
            still.append(key)
    if still:
        raise AssertionError(f"{variant} text leaves that did not move: "
                             f"{still}")
    walls = [r[0] for r in records]
    warm_ms = float(np.median(walls[1:-1])) * 1e3
    kernels = profiled["kernels"]
    total = sum(kernels.values())
    f_ms, b_ms = (sum(v for k, v in kernels.items()
                      if any(name in k for name in names))
                  for names in PROFILE_NAMES[variant])
    if total <= 0 or f_ms <= 0 or b_ms <= 0:
        raise AssertionError("torch.profiler saw no device time for the "
                             f"{variant} kernels: {sorted(kernels)[:20]}")
    log(f"full-width training, {variant} fusion, {VARIANT_STEPS} steps: "
        f"losses (cost/cls) "
        + ", ".join(f"{c:.1f}/{l:.1f}" for _, _, _, c, l, _ in records)
        + f"; words per step {[r[5] for r in records]}; launches per step "
        f"({fwd_name}, {bwd_name}) {[(r[1], r[2]) for r in records]}; step "
        f"wall first {walls[0]:.4f} s, then "
        + ", ".join(f"{w:.4f}" for w in walls[1:-1])
        + f" s (median {warm_ms / 1e3:.4f} s); peak device memory "
        f"{peak:.2f} GiB; text leaves moved, ResNet bit-unchanged")
    log(f"  profiled step {VARIANT_STEPS} (torch.profiler on, wall "
        f"{profiled['wall'] * 1e3:.1f} ms): device kernel time {total:.2f} "
        f"ms, {fwd_name} {f_ms:.2f} ms, {bwd_name} {b_ms:.2f} ms "
        f"({(f_ms + b_ms) / total:.1%} of device time); against the median "
        f"warm step: device idle {1 - total / warm_ms:.1%}")
    return counts


def kernel_entry(name, source, replaces, launches_by_path, err, ms,
                 plain_ms, bound_ms_by, shape_name, **extra):
    """One entry of the kernels line.  ``launches`` is the total over the
    paths' runs, ``launches_by_path`` the count of each path (every count
    set to 0 just before that path and read just after it).  ``bound_ms``
    is the bound at the precision the kernel runs; ``bound_tc_ms`` (the
    3xTF32 tensor-core bound) and ``bound_f32_ms`` (the f32 CUDA-core
    bound) default to it; ``extra`` keys are added as they are."""
    extra.setdefault("bound_tc_ms", bound_ms_by[0])
    extra.setdefault("bound_f32_ms", bound_ms_by[0])
    return {**extra, "name": name, "route": "cuda",
            "source": f"sketchyscenecolorization_torch/csrc/{source}",
            "replaces": f"sketchyscenecolorization_tpu/ops/pallas_mlstm.py:"
                        f"{replaces}",
            "launches": sum(launches_by_path.values()),
            "launches_by_path": launches_by_path, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms_by[0],
            "bound_by": bound_ms_by[1], "library_ms": None,
            "shape": shape_name}


def kernels_line(by_kernel, fwd, bwd, sass, attn, recur, profiles):
    """The six entries of the kernels line from the phases' results: the
    launches of each path, B1's and B2's checks, the SASS counts, B3-B6's
    checks and every kernel's profile (``profiles``: {"B1": its launch
    kinds, ...}), at each kernel's main shape."""
    rmi, (_, n, p, hid, t, rows) = SHAPES[0], RECUR_SHAPES[0]
    a_shape = ATTN_SHAPES[0]

    def by_kind(label):
        return {k: v[0] for k, v in profiles[label].items() if v[1]}

    def hmma(label):
        return sum(sass[name][0] for name in SASS_PRODUCTS[label])
    return [
        kernel_entry("mlstm_fwd", "mlstm_fwd.cu", 45, by_kernel["mlstm_fwd"],
                     max(e for e, _, _ in fwd.values()), fwd["rmi"][1],
                     fwd["rmi"][2], fwd_bound(*rmi[1:6], tensor_cores=True),
                     rmi[0], bound_f32_ms=fwd_bound(*rmi[1:6])[0],
                     ms_by_kind=by_kind("B1"), hmma=hmma("B1")),
        kernel_entry("mlstm_bwd", "mlstm_bwd.cu", 778, by_kernel["mlstm_bwd"],
                     max(e for e, _, _, _ in bwd.values()), bwd["rmi"][2],
                     bwd["rmi"][3], bwd_bound(*rmi[1:6], tensor_cores=True),
                     rmi[0], bound_f32_ms=bwd_bound(*rmi[1:6])[0],
                     ms_by_kind=by_kind("B2"), hmma=hmma("B2/B4")),
        kernel_entry("mlstm_attn_fwd", "mlstm_fwd.cu", 143,
                     by_kernel["mlstm_attn_fwd"],
                     max(r[0] for r in attn.values()), attn[a_shape[0]][1],
                     attn[a_shape[0]][2],
                     attn_fwd_bound(*a_shape[1:], tensor_cores=True),
                     a_shape[0], bound_f32_ms=attn_fwd_bound(*a_shape[1:])[0],
                     ms_by_kind=by_kind("B3"), hmma=hmma("B3")),
        kernel_entry("mlstm_attn_bwd", "mlstm_bwd.cu", 279,
                     by_kernel["mlstm_attn_bwd"],
                     max(r[3] for r in attn.values()), attn[a_shape[0]][5],
                     attn[a_shape[0]][6],
                     attn_bwd_bound(*a_shape[1:], tensor_cores=True),
                     a_shape[0],
                     bound_f32_ms=attn_bwd_bound(*a_shape[1:])[0],
                     hmma=hmma("B2/B4")),
        kernel_entry("recur_attn_fwd", "recur_attn_fwd.cu", 430,
                     by_kernel["recur_attn_fwd"],
                     max(r[0] for r in recur.values()), recur["recur"][1],
                     recur["recur"][2],
                     recur_fwd_bound(n, p, hid, t, rows, tensor_cores=True),
                     "recur",
                     bound_f32_ms=recur_fwd_bound(n, p, hid, t, rows)[0],
                     ms_by_kind=by_kind("B5"), hmma=hmma("B5")),
        kernel_entry("recur_attn_bwd", "recur_attn_bwd.cu", 554,
                     by_kernel["recur_attn_bwd"],
                     max(r[3] for r in recur.values()), recur["recur"][5],
                     recur["recur"][6],
                     recur_bwd_bound(n, p, hid, t, rows, tensor_cores=True),
                     "recur",
                     bound_f32_ms=recur_bwd_bound(n, p, hid, t, rows)[0],
                     ms_by_kind=by_kind("B6"), hmma=hmma("B6"))]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from sketchyscenecolorization_torch.ops import mlstm
    from sketchyscenecolorization_torch.pipeline.factory import build_session

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    report = mlstm.build()
    log(f"built {os.path.relpath(mlstm.LIBRARY, ROOT)} from "
        f"{[os.path.relpath(src, ROOT) for src in mlstm.SOURCES]} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if any(w in line for w in ("Compiling", "registers", "spill",
                                   "error")):
            log("  nvcc:", line.strip())

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    fwd = check_kernel(mlstm)
    profiles = {"B1": profile_fwd_call(mlstm)}
    bwd = check_bwd_kernel(mlstm)
    profiles["B2"] = profile_bwd_call(mlstm)
    sass = sass_counts(mlstm.LIBRARY)
    attn = check_variant_kernels("attn")
    recur = check_variant_kernels("recur")
    profiles["B3"] = profile_variant_call("B3", ATTN_FWD_KINDS, ("stage",))
    profiles["B5"] = profile_variant_call("B5", RECUR_FWD_KINDS,
                                          ("F3 gates+cell",))
    profiles["B6"] = profile_variant_call(
        "B6", RECUR_BWD_KINDS, ("F3 gates+cell", "S3 dh+cell grad"))
    log(f"library call: none for B1-B6 ({NO_LIBRARY}; B5/B6 also attend "
        "over the word-LSTM outputs inside the recurrence)")
    check_against_cpu(build_session)
    check_bg_against_cpu(build_session)
    check_training_against_cpu()
    paths = {"color": full_size_run(build_session, mlstm)}
    torch.cuda.empty_cache()
    paths["color_bg"] = full_width_bg(build_session, smi.splitlines()[0])
    torch.cuda.empty_cache()
    paths["train_matching"], corpus, trained = full_width_training(mlstm)
    serve_trained(build_session, corpus, trained)
    del trained
    torch.cuda.empty_cache()
    paths["infer_matching"] = infer_matching(corpus)
    for variant in VARIANTS:
        torch.cuda.empty_cache()
        check_against_cpu(build_session, variant)
        check_training_against_cpu(variant)
        paths[f"color_{variant}"] = variant_session_run(build_session, variant)
        torch.cuda.empty_cache()
        paths[f"train_{variant}"] = variant_training(variant)

    by_kernel = {k: {path: c[k] for path, c in paths.items() if c[k]}
                 for k in kernel_counters()}
    idle = [k for k, v in by_kernel.items() if not v]
    if idle:
        raise AssertionError(f"kernels never launched on a path: {idle}")
    log(json.dumps({"kernels": kernels_line(
        by_kernel, fwd, bwd, sass, attn, recur, profiles)}))
    log(smi.splitlines()[0])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
