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
  2. print the TF32 flags as torch sets them; the port's entry points
     turn TF32 off (``ops/conv.py:apply_compute_dtype``), and after the
     first ``build_session`` (phase 5) the script prints them again and
     fails if either is on; where it builds models itself it calls
     ``apply_compute_dtype``;
  3. hold B1 against ``mlstm_plain`` on the card at the RMI, FG (serving,
     N = 4, and GAN training, N = 2) and BG shapes, at H = 250 (not a
     multiple of 4), at the FG shape with a row without a kept step and at
     the matching evaluation's (N = 5 captions of one image, P = 9216,
     H = 500) (max-abs error on h <= 1e-4) and time both;
     profile one B1 call at the RMI shape by launch kind;
  4. hold B2 against ``mlstm_bwd_plain`` at the same shapes but the two
     that only B1 runs (max-abs error of each gradient <= 1e-4 of its largest magnitude),
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
     every session here and below runs the default ``PipelineConfig``
     (device compositing, compact fetch, the device sky gradient); then
     the serving layer's device ops against their host twins on the card
     (the PIL resize, ``sky_detect_trace`` with ties, the compositor over
     48 chained 768^2 passes read back through pinned memory and events:
     byte-equal) and a ``colorize_stream`` queue with write-behind PNGs
     through the default-config CUDA session against the CPU host chain
     (gradient off: records byte-equal, canvases within 1 LSB) and, with
     the device gradient's gate forced, against the CUDA host chain
     (byte-equal) and the CPU host chain (records byte-equal, the canvas
     difference printed);
  6. three matching train steps at a small config on CUDA and on the CPU
     from the same seeded weights and batches: costs and text leaves agree,
     ResNet bit-unchanged;
  7. write a synthetic 768x768 scene and run the session at the default
     full-width configuration on the card: a FG ``color`` command, a FG
     pass forced onto every eligible instance, a ``withdraw`` and a second
     ``color`` command, with B1's launches counted, then 8 warm FG
     commands as served (the random matcher selects nothing) and 8 on a
     clone whose matching forward runs but whose selection is routed to
     one instance, so the generator and the compositor run; then the BG
     branch at
     the default full width (ResidualGenerator, ngf 64, 768^2): the sky
     gradient's LUT built and timed apart, a FG command, then a cold BG
     command and 12 warm ones (path ``color_bg``: B1 at P = 576, H = 1024,
     T = 8, one launch a command), with the generator's device time and
     the session's serving stages (``stage_trace``) timed apart, peak
     device memory with the LUT, one generator forward profiled by
     kernel, the results checked; then path ``color_stream``: a queue of
     eight instructions (a FG run of 3, BG, a FG run of 3, BG) through
     ``colorize_stream``, a cold round and 5 warm ones, per-pass walls and
     the stage breakdown, as served and then routed (path
     ``color_stream_routed``: one FG generator launch per segment, B1's
     launches tallied by shape), records equal to sequential ``colorize``;
     and
     one A/B line each for ``device_compositing``, ``compact_fetch``,
     ``device_color_gradient`` and ``async_png_writes``; after the BG
     phase one line with a 768^2 BG generator forward in f32 and with TF32
     switched on locally (max-abs difference, both times);
  8. write a synthetic 768x768 matching corpus and run ``cli_matching
     --mode train`` at the default full-width configuration for 6 steps,
     then resume it for 2 more: B1 and B2 launch every step, losses are
     finite, the text leaves move and ResNet does not, the snapshot is
     written and resumed; step wall times, B2's share of a step
     (``torch.profiler``) and peak device memory; a session built on the
     run's snapshots holds the trained weights and gives the trained
     module's ``up`` logits bit for bit, and ``cli_matching --mode
     inference`` on the run writes its prediction (path
     ``infer_matching``); ``cli_matching --mode eval`` at the default
     full width on the run's snapshot over a synthetic val split of 4
     768^2 images x 5 captions with mask AP (path ``eval_matching``: walls
     per image and per caption, B1 launches and shape, peak memory, the
     summary lines), then ``eval_matching`` at 48^2 on CUDA and on the CPU
     from the same weights (masks and results equal);
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
 11. GAN training: three FG and three BG train steps at small configs on
     CUDA and on the CPU, each from the same state, batches and draws
     (losses, EMAs, committed spectral-norm vectors and updated parameters
     agree; B1 twice and B2 once a CUDA step); then ``cli_fg_gan --mode
     train`` at the default ``FGGanConfig`` (192^2, batch 2, base 64) on a
     synthetic 384^2 record shard for 6 steps, resumed to 8 (path
     ``train_fg_gan``), and ``cli_bg_gan --mode train`` at the default
     ``BGGanConfig`` (768^2, ngf/ndf 64, ``multi_residual``) on synthetic
     captions and images for 4 steps, resumed to 6 (path
     ``train_bg_gan``): step walls, one profiled step each (device ms,
     idle share, convolutions, B1 and B2), peak memory, B1/B2 launches by
     shape; then a full-width session on both runs' snapshots (path
     ``serve_gans``: its generators equal the snapshots', a routed FG and a
     BG command), ``cli_fg_gan --mode val`` and ``cli_bg_gan --mode test``
     on one entry each; the small-config CUDA-vs-CPU GAN check also runs
     three FG steps with the perceptual term;
 12. Inception-v4 with its heads (1001 classes) at 299^2, batch 8: forward
     ms, GFLOP/s and peak memory, CUDA against the CPU at batch 1 (each
     endpoint within 1e-4 of its largest magnitude), and
     ``inception_v4_class_probs``/``acgan_class_probs`` with
     ``inception_score`` on 16 outputs of the FG run's generator (path
     ``inception``);
 13. ``train_fg_gan`` at the default ``FGGanConfig`` with
     ``coeff_perceptual`` 1 and a fresh Inception-v4 stem, 3 steps resumed
     to 4 (path ``train_fg_gan_perceptual``: step walls, a profiled step,
     Inception's share of the device time, peak memory, B1 twice and B2
     once a step);
 14. the non-default models (A10): at 64^2, each backbone's session
     (FCN-8s, SegNet, DeepLab-v3+) on CUDA against the CPU (up logits
     within 1e-4, flipped mask pixels counted), one call of each engine
     with every model at bfloat16 (CUDA bf16's error against the CPU f32
     result within 1.5 x the CPU bf16 result's own), B1's wrapper refusing
     a bf16 operand, and one train step of Pix2Pix, Residual and MRU with
     ``num_blocks=2`` against the CPU as in 11; path ``color_bf16``: a
     full-width session at bfloat16 beside an f32 one from the same
     weights (the mixed sequence counted, B1 by shape; 12 warm BG
     commands each, interleaved; the BG generator's device ms; the
     canvases' largest u8 difference; peak memory); paths
     ``color_fcn8s``, ``color_segnet``, ``color_v3plus``: a full-width
     session with each backbone, one cold and three warm routed FG
     commands with the matching forward, the backbone's device ms and
     peak memory; paths ``train_fg_pix2pix`` and ``train_fg_residual``:
     ``cli_fg_gan --block_type`` at the default ``FGGanConfig``, 4 steps
     resumed to 6, reported as in 11; path ``serve_fg_variants``: a routed
     FG command from a session on each trained variant generator;
 15. print the kernels line (six kernels: launches per path, times, the
     f32 and 3xTF32 bounds, device ms by launch kind, HMMA counts),
     the card's name and power limit, and last ``{"ok": true, "device":
     {...}}``.

Without a CUDA device, or outside the repository, it exits non-zero before
printing any result.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
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
    ("fg_train", 2, 36, 512, 15, [6, 11], True),     # FG GAN training
    ("bg", 1, 576, 1024, 8, 5, True),
    ("h250", 2, 1001, 250, 15, 7, False),            # cli_matching scale 0.5
    ("fg_empty_row", 4, 36, 512, 15, [4, 4, 0, 4], True),   # B1 only
    # matching evaluation: one image's five captions (augmented) at once
    ("rmi_eval", 5, 9216, 500, 15, [8, 8, 8, 5, 12], False),  # B1 only
]
B1_ONLY = ("fg_empty_row", "rmi_eval")      # shapes B2 is not checked at
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
    """B2 vs plain on the card at the shapes of SHAPES but B1_ONLY, two
    launches bitwise equal; returns {shape name: (max_abs_err, max_rel_err,
    kernel ms, plain ms)}."""
    import torch
    results = {}
    for name, n, p, hid, t, n_valid, front in SHAPES:
        if name in B1_ONLY:
            continue
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
            color_gradient=color_gradient))


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


def read_outputs(tmp, outputs="outputs"):
    from PIL import Image
    rec = os.path.join(tmp, outputs, "update_records",
                       f"{IMAGE_ID}_records.json")
    d = os.path.join(tmp, outputs, "results", str(IMAGE_ID))
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
    """Times the parts of the commands on ``session`` (built with
    ``stage_trace``): the BG generator's forward in CUDA events, and the
    session's serving stages summed by label on the host clock
    (``ColorizationSession.trace_events``).  The hooks stay in place until
    ``close``."""

    def __init__(self, session):
        import torch
        self.torch, self.session, self.events = torch, session, []
        model = session.bg.model

        def pre(_module, _inputs):
            self.events.append([torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True)])
            self.events[-1][0].record()

        def post(_module, _inputs, _outputs):
            self.events[-1][1].record()
        self.hooks = [model.register_forward_pre_hook(pre),
                      model.register_forward_hook(post)]
        session.clear_trace()

    def take(self):
        """{part: ms} of the commands since the last ``take``."""
        self.torch.cuda.synchronize()
        self.session.flush()
        out = {}
        for label, t0, t1 in self.session.trace_events:
            out[label] = out.get(label, 0.0) + (t1 - t0) * 1e3
        self.session.clear_trace()
        out["generator (device)"] = sum(a.elapsed_time(b)
                                        for a, b in self.events)
        self.events = []
        return out

    def close(self):
        for hook in self.hooks:
            hook.remove()


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
# stage-trace labels of the PNG workers: not on the command's critical path
WORKER_LABELS = ("png_fetch", "png_encode", "generator (device)")
# substrings of cuDNN's and cuBLAS's convolution kernel names
CONV_KERNEL_WORDS = ("conv", "gemm", "xmma", "wgrad", "dgrad", "fft",
                     "winograd")


def full_width_bg(build_session, card):
    """The BG branch of ``color`` at the default full-width configuration
    (ResidualGenerator, ngf 64, multi_residual, 768^2; the default
    ``PipelineConfig``: device compositing and the device sky gradient,
    with ``stage_trace`` on) on the synthetic scene with fresh seeded
    weights: the sky gradient's 24-bit LUT built and timed apart and its
    device copy's upload, a FG command, then the first BG command of the
    session (cold) and BG_WARM warm ones with their parts timed
    (``BGSpans``), peak device memory with the LUT, then the results and
    the generator's outputs checked.  Returns the launch counts of the BG
    commands."""
    import torch
    from PIL import Image
    from sketchyscenecolorization_torch.pipeline import compositing as comp
    from sketchyscenecolorization_torch.text import colorization_encode
    tmp = tempfile.mkdtemp(prefix="smoke_bg_full_")
    cfg = full_width_config(tmp, stage_trace=True)
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
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    lut = session.bg.lut_device()       # the session's upload, waited for
    torch.cuda.synchronize()
    lut_dev_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in session.bg.model.parameters())
    log(f"full-width BG: ResidualGenerator ngf {b.ngf}, multi_residual "
        f"{b.multi_residual}, {b.image_size}^2, {n_params / 1e6:.1f}M "
        f"parameters; 24-bit sky-gradient LUT built in {lut_s:.3f} s (apart); "
        f"build_session {build_s:.3f} s, then {lut_dev_s:.3f} s until the "
        f"device LUT ({lut.numel() / 2 ** 20:.0f} MiB, "
        f"{(torch.cuda.memory_allocated() - before) / 2 ** 20:.0f} MiB more "
        f"allocated) was ready")
    state = session._state(IMAGE_ID)   # fixture decode: set-up, not timed
    session.colorize(IMAGE_ID, "the bus is yellow")   # a FG result under it
    spans = BGSpans(session)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2 ** 30
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
            v for k, v in parts[-1].items() if k not in WORKER_LABELS)
    counts = read_counts()                            # path ends
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    spans.close()
    if counts["mlstm_fwd"] != BG_WARM + 1:
        raise AssertionError(f"{counts['mlstm_fwd']} B1 launches in "
                             f"{BG_WARM + 1} BG commands, expected one each")
    if not all("bg_ramp_host" in p for p in parts):
        raise AssertionError("a warm BG command did not take the device "
                             f"gradient: {[sorted(p) for p in parts]}")

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
        + f"; peak device memory {peak:.2f} GiB ({resident:.2f} GiB resident "
          f"before the commands: the three models, the LUT, the cached "
          f"backbone features and canvas); B1 launches "
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


# up- and down-scales of tests/test_pil_resize.py, the compositor's among
# them (instance_size 192 -> box + 2 margins)
PIL_SIZES = [(192, 192, 300, 280), (192, 192, 64, 80), (192, 160, 192, 192),
             (100, 100, 100, 37), (7, 9, 23, 5), (192, 192, 192, 192),
             (192, 172, 310, 250), (55, 192, 21, 400), (1, 5, 3, 8),
             (768, 768, 384, 384), (33, 47, 47, 33), (192, 148, 116, 89)]
RACE_PASSES = 48    # chained compositing passes read back while queued


def sky_trials(rng, h, w):
    """The 12 images of ``test_sky_detect_device_matches_host``: few
    colours (count ties), sky only in row 0, a one-colour band; those whose
    band has a non-FG pixel.  Yields (img_bg, inner)."""
    for trial in range(12):
        img = rng.randint(0, 4, (h, w, 3)).astype(np.uint8) * 63
        inner = (rng.rand(h, w) < 0.3).astype(np.int32)
        img_bg = np.where((inner != 0)[..., None], np.uint8(255), img)
        if trial == 5:
            img_bg[1: h // 2 + 1] = 7
            img_bg[0, :] = img_bg[5, 0]
        if trial == 7:
            img_bg[5:7] = 42
        if (inner[5:7] == 0).any():
            yield img_bg, inner


def check_serving_ops():
    """The serving layer's device ops on the card against their host twins:
    the PIL resize over PIL_SIZES (byte-equal to Pillow and the numpy
    path), ``sky_detect_trace`` over the 12 trials with ties at 32x24 and
    at 768^2 (a 1536-pixel band), and the ``DeviceCompositor`` on the
    768^2 synthetic scene against the host chain fed the same generator
    bytes over RACE_PASSES chained passes, byte-equal: every pass's compact
    patch and full canvas read back through ``_LazyFetch`` (pinned memory
    and a CUDA event) while 40 ms of other work runs ahead of them on the
    stream, so a read that did not wait for its copy would see another
    pass's bytes."""
    import torch
    from PIL import Image
    from sketchyscenecolorization_torch.data.fixtures import (
        load_inner_mask, load_seg_data, load_sketch_image)
    from sketchyscenecolorization_torch.ops.pil_resize import (
        pil_resize_bilinear_u8, pil_resize_bilinear_u8_np)
    from sketchyscenecolorization_torch.pipeline import compositing as comp
    from sketchyscenecolorization_torch.pipeline.device_compositing import \
        DeviceCompositor
    from sketchyscenecolorization_torch.pipeline.engines import \
        sky_detect_trace
    from sketchyscenecolorization_torch.pipeline.session import _LazyFetch

    for h, w, oh, ow in PIL_SIZES:
        img = np.random.RandomState(h * ow).randint(0, 256, (h, w, 3)) \
            .astype(np.uint8)
        want = np.asarray(Image.fromarray(img).resize((ow, oh),
                                                      Image.BILINEAR))
        got = pil_resize_bilinear_u8(torch.from_numpy(img).cuda(), oh, ow)
        if not (np.array_equal(got.cpu().numpy(), want) and np.array_equal(
                pil_resize_bilinear_u8_np(img, oh, ow), want)):
            raise AssertionError(f"PIL resize {h}x{w} -> {oh}x{ow} differs "
                                 "from Pillow on the card")

    rng, n_sky = np.random.RandomState(0), 0
    for h, w in ((32, 24), (768, 768)):
        for img_bg, inner in sky_trials(rng, h, w):
            want_color, want_bottom = comp.detect_sky(img_bg, inner)
            color, bottom = sky_detect_trace(torch.from_numpy(img_bg).cuda(),
                                             torch.from_numpy(inner).cuda())
            got = ([int(v) for v in color.cpu()], int(bottom))
            if got != (want_color, want_bottom):
                raise AssertionError(f"sky_detect_trace {h}x{w} on the card "
                                     f"{got}, host {want_color, want_bottom}")
            n_sky += 1

    tmp = tempfile.mkdtemp(prefix="smoke_compositor_")
    base_dir = os.path.join(tmp, "examples")
    eligible = write_scene(base_dir, 768)
    sketch = load_sketch_image(os.path.join(base_dir, "sketches",
                                            f"{IMAGE_ID}.png"),
                               dtype=np.uint8, size=768)
    inner = load_inner_mask(os.path.join(base_dir, "inner_masks",
                                         f"{IMAGE_ID}.mat"))
    _, class_ids, boxes = load_seg_data(
        os.path.join(base_dir, "seg_data", f"{IMAGE_ID}_datas.npz"), size=768)
    grass = [i for i, c in enumerate(class_ids) if c == comp.GRASS_LABEL]
    moved, drawings = comp.shifted_drawings(
        sketch, comp.grass_free_inner_mask(inner, grass))
    dc = DeviceCompositor(inner, moved, drawings, boxes, class_ids, "cuda")
    passes, off = [], 0
    for m in range(RACE_PASSES):
        inst = tuple(eligible[(m + k) % len(eligible)]
                     for k in range(1 + m % len(eligible)))
        passes.append((inst, off))
        off += len(inst)
    rng = np.random.RandomState(2)
    gen = rng.randint(0, 256, (off, 192, 192, 3)).astype(np.uint8)
    base = rng.randint(0, 256, (768, 768, 3)).astype(np.uint8)
    host, canvas = [], base
    for inst, row in passes:
        canvas = canvas.copy()
        for k, i in enumerate(inst):
            color = comp.instance_result_postprocessing_u8(
                gen[row + k], boxes[i], int(class_ids[i]))
            comp.paste_instance(canvas, color, inner, i, boxes[i])
        canvas[drawings] = moved[drawings]
        host.append(canvas)
    gen_t, base_t = torch.from_numpy(gen).cuda(), torch.from_numpy(base).cuda()
    busy = torch.randn(4096, 4096, device="cuda")
    torch.cuda.synchronize()
    for _ in range(20):                 # ~40 ms queued ahead of the passes
        busy = busy @ busy / 64.0
    final, patches = dc.composite_run_compact(base_t, gen_t, passes)
    fetched = [_LazyFetch(p) for p in patches]
    got_patches = [f.get() for f in fetched]
    canvases = [_LazyFetch(c) for c in dc.composite_run(base_t, gen_t,
                                                        passes)]
    for m, ((inst, _), want) in enumerate(zip(passes, host)):
        flat = want.reshape(-1, 3)
        want_patch = np.concatenate([flat[dc.host_idx(i)] for i in inst])
        if not (np.array_equal(got_patches[m], want_patch)
                and np.array_equal(canvases[m].get(), want)):
            raise AssertionError(f"device compositing pass {m} {inst} differs "
                                 "from the host chain on the card")
    if not (np.array_equal(final.cpu().numpy(), host[-1])
            and np.array_equal(base_t.cpu().numpy(), base)):
        raise AssertionError("final device canvas differs, or the base "
                             "canvas was written")
    log(f"serving ops on the card: PIL resize byte-equal to Pillow at "
        f"{len(PIL_SIZES)} shapes; sky_detect_trace equal to the host scan "
        f"in {n_sky} trials with ties (32x24 and 768^2); the compositor "
        f"byte-equal to the host chain over {RACE_PASSES} chained 768^2 "
        f"passes ({off} generator rows), every compact patch and canvas "
        f"read through pinned memory and an event behind 40 ms of queued "
        f"work; the base canvas unchanged")


# a mixed queue for the 64^2 scene; the random-weight matcher may match
# nothing, so its FG instructions are routed to fixed instances (bus 0,
# car 1, grass 3) and the generator runs
SMALL_STREAM = ["the bus is yellow", "the car is red",
                "the sky is blue and the ground is green", "the bus is blue",
                "the car is yellow", "the sky is red"]
SMALL_ROUTES = {"the bus is yellow": [0], "the car is red": [1],
                "the bus is blue": [0, 1], "the car is yellow": [1, 3]}


def routed(session, routes=SMALL_ROUTES, match=False):
    """``session`` with its FG instructions matched by ``routes``; with
    ``match`` the matching forward still runs first (its selection is
    dropped), so a command does all a matched one does."""
    import types
    match_many = session._match_many

    def _match_many(self, state, input_texts):
        if match:
            match_many(state, input_texts)
        return [list(routes[t]) for t in input_texts]
    session._match_many = types.MethodType(_match_many, session)
    return session


@contextlib.contextmanager
def b1_shapes():
    """Yields a Counter of B1's launches by (N, P, H) and of B2's by
    ("B2", N, P, H) while the block runs, read from the inputs the
    wrappers hand to the launch (the wrappers' own counts are
    untouched)."""
    from sketchyscenecolorization_torch.ops import mlstm
    tally, fwd, bwd = collections.Counter(), mlstm._fwd_cuda, mlstm._bwd_cuda

    def spy(name, pixel_term, step_term, w_h, valid, attn=None):
        if name == "mlstm_cuda":
            tally[tuple(pixel_term.shape[:2]) + (w_h.shape[0],)] += 1
        return fwd(name, pixel_term, step_term, w_h, valid, attn)

    def spy_bwd(pixel_term, step_term, w_h, valid, g, attn=None):
        if attn is None:
            tally[("B2",) + tuple(pixel_term.shape[:2]) + (w_h.shape[0],)] \
                += 1
        return bwd(pixel_term, step_term, w_h, valid, g, attn)
    mlstm._fwd_cuda, mlstm._bwd_cuda = spy, spy_bwd
    try:
        yield tally
    finally:
        mlstm._fwd_cuda, mlstm._bwd_cuda = fwd, bwd


def text_fusion_hidden(model):
    """The hidden size of a generator's text-fusion LSTM (its B1 H)."""
    from sketchyscenecolorization_torch.models.gan_layers import (
        TextFusionLSTM)
    (c,) = {m.wlstm_b.shape[0] // 4 for m in model.modules()
            if isinstance(m, TextFusionLSTM)}
    return c


def by_hidden(tally, hidden):
    return sum(v for (_, _, h), v in tally.items() if h == hidden)


def check_serving_against_cpu(build_session):
    """The serving layer at 64^2 on the card against the host chain,
    through ``colorize_stream`` with write-behind PNGs:
      (A) sky gradient off, the default-config CUDA session against the
          CPU host-chain session (``device_compositing=False``), same
          seeded weights and noise: SMALL_STREAM as served (the matcher
          selects nothing, so the BG passes see equal inputs): records
          byte-equal, canvases within 1 LSB; and its FG instructions
          routed (the generator runs): records byte-equal, canvases within
          1 LSB and byte-equal outside the inner masks; B1 launched on the
          card.  (Routed and mixed, a FG difference of 1 LSB is a BG
          generator input difference, which the generator may amplify.)
      (B) SMALL_STREAM routed with the device-gradient gate forced: the
          default-config CUDA session against a CUDA host-chain clone (the
          same engines, so equal generator bytes; cuDNN deterministic):
          records and canvases byte-equal;
      (C) as (B) against the CPU host-chain session: records byte-equal,
          the canvas difference printed (the sky vote moves on a 1-LSB
          generator difference, so canvases are held on equal generator
          bytes in (B))."""
    import torch
    from sketchyscenecolorization_torch.pipeline import compositing as comp
    fg_only = [t for t in SMALL_STREAM if t in SMALL_ROUTES]

    def build(device, tag, color_gradient, route=True, **pipeline):
        tmp = tempfile.mkdtemp(prefix=f"smoke_serving_{tag}_")
        write_scene(os.path.join(tmp, "examples"), 64)
        cfg = small_config(tmp, color_gradient=color_gradient)
        cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
            cfg.pipeline, **pipeline))
        session = build_session(cfg, seed=0, device=device)
        return tmp, routed(session) if route else session

    def serve(session, tmp, texts=SMALL_STREAM, outputs="outputs"):
        session.colorize_stream(IMAGE_ID, texts)
        session.flush()
        return read_outputs(tmp, outputs)

    def compare(a, b, tol, what, inner=None):
        (rec_a, img_a), (rec_b, img_b) = a, b
        if rec_a != rec_b or sorted(img_a) != sorted(img_b):
            raise AssertionError(f"{what}: records equal {rec_a == rec_b}, "
                                 f"files {sorted(img_a)} vs {sorted(img_b)}")
        diffs = {n: np.abs(img_a[n].astype(int) - img_b[n]) for n in img_a}
        worst = max(int(d.max()) for d in diffs.values())
        if tol is not None and worst > tol:
            raise AssertionError(f"{what}: canvases differ by {worst} LSB")
        if inner is not None and any(d[inner == 0].any()
                                     for d in diffs.values()):
            raise AssertionError(f"{what}: canvases differ outside the "
                                 "inner masks")
        return worst, sum(int(d.any(axis=-1).sum()) for d in diffs.values())

    worst_a, launched = [], 0
    for route, texts in ((False, SMALL_STREAM), (True, fg_only)):
        tmp, gpu = build("cuda", f"a_gpu_{route}", False, route,
                         async_png_writes=True)
        reset_counts()
        out_gpu = serve(gpu, tmp, texts)
        launched += read_counts()["mlstm_fwd"]
        tmp, cpu = build("cpu", f"a_cpu_{route}", False, route,
                         device_compositing=False)
        worst_a.append(compare(
            out_gpu, serve(cpu, tmp, texts), 1, "(A) CUDA default vs CPU "
            f"host chain, gradient off, routed {route}",
            gpu._state(IMAGE_ID).inner_mask if route else None))
    if launched < 1:
        raise AssertionError("(A): B1 never launched in the CUDA sessions")

    saved = comp._LUT_MIN_PIXELS, torch.backends.cudnn.deterministic
    comp._LUT_MIN_PIXELS = 1
    torch.backends.cudnn.deterministic = True
    try:
        tmp, gpu = build("cuda", "b_gpu", True, async_png_writes=True)
        calls = []
        grad = gpu.bg.colorize_composited_gradient
        gpu.bg.colorize_composited_gradient = \
            lambda *a: calls.append(1) or grad(*a)
        out_gpu = serve(gpu, tmp)
        del gpu.bg.colorize_composited_gradient
        host = routed(gpu.clone(seed=0, results_base_dir=os.path.join(
            tmp, "host"), device_compositing=False))
        compare(out_gpu, serve(host, tmp, outputs="host"), 0,
                "(B) CUDA device gradient vs CUDA host chain")
        if len(calls) != 2:
            raise AssertionError(f"(B): the device gradient ran {len(calls)}"
                                 " times in two BG commands")
        tmp, cpu = build("cpu", "c_cpu", True, device_compositing=False)
        worst_c, pixels_c = compare(out_gpu, serve(cpu, tmp), None,
                          "(C) CUDA device gradient vs CPU host chain")
    finally:
        comp._LUT_MIN_PIXELS, torch.backends.cudnn.deterministic = saved
    log(f"small scene, serving layer ({len(SMALL_STREAM)}-instruction "
        f"colorize_stream, write-behind PNGs): (A) CUDA default config vs "
        f"CPU host chain, gradient off: records byte-equal, max diff "
        f"{worst_a[0][0]} LSB as served, {worst_a[1][0]} LSB with the FG run "
        f"routed, 0 outside the inner masks (tol 1), {launched} B1 launches"
        f"; (B) device gradient"
        f" (gate forced) vs the CUDA host chain on equal generator bytes: "
        f"records and canvases byte-equal; (C) the same against the CPU host"
        f" chain: records byte-equal, canvases differ by up to {worst_c} LSB"
        f" on {pixels_c} pixels of {len(out_gpu[1])} canvases (not held: a "
        f"1-LSB generator difference moves the sky gradient)")


STREAM_QUEUE = ["the bus is yellow", "the car is red", "the grass is green",
                "the sky is blue and the ground is green",
                "the bus is blue", "the car is yellow", "the grass is brown",
                "the sky is cyan"]
STREAM_WARM = 5     # warm rounds of the queue after the cold one


def full_width_config(tmp, **pipeline):
    """The default full-width ``FrameworkConfig`` on ``tmp``'s scene,
    vocabularies from ``data/``, no snapshots."""
    from sketchyscenecolorization_torch.config import (FrameworkConfig,
                                                       PipelineConfig)
    return FrameworkConfig(pipeline=PipelineConfig(
        data_base_dir=os.path.join(tmp, "examples"),
        results_base_dir=os.path.join(tmp, "outputs"),
        match_vocab_path=os.path.join(ROOT, "data", "match_vocab.txt"),
        fg_vocab_path=os.path.join(ROOT, "data", "fg_vocab.txt"),
        bg_vocab_path=os.path.join(ROOT, "data", "bg_vocab.txt"),
        match_ckpt_dir="", fg_ckpt_dir="", bg_ckpt_dir="", **pipeline))


def trace_ms(session, clear=True):
    """{stage label: summed ms} of the session's stage trace."""
    out = {}
    for label, t0, t1 in session.trace_events:
        key = re.sub(r"\[\d+\]$", "[k]", label)
        out[key] = out.get(key, 0.0) + (t1 - t0) * 1e3
    if clear:
        session.clear_trace()
    return out


def stream_rounds(session, rounds):
    """``rounds`` passes of STREAM_QUEUE through ``colorize_stream``:
    ([round wall s], [{stage label: ms}] per round, the first round's
    result paths)."""
    import torch
    walls, parts, first = [], [], None
    for _ in range(rounds):
        t0 = time.perf_counter()
        paths = session.colorize_stream(IMAGE_ID, STREAM_QUEUE)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        parts.append(trace_ms(session))
        first = first or paths
    return walls, parts, first


def log_rounds(label, walls, parts):
    """One line of round walls (the first is cold) and one of the warm
    rounds' median stage breakdown."""
    n = len(STREAM_QUEUE)
    warm = walls[1:]
    median = float(np.median(warm))
    share = {k: float(np.median([p.get(k, 0.0) for p in parts[1:]]))
             for k in sorted(set().union(*parts[1:]))}
    log(f"  {label}: cold round {walls[0]:.3f} s; warm rounds "
        f"{', '.join(f'{w * 1e3:.1f}' for w in warm)} ms (median "
        f"{median * 1e3:.1f} ms, {median * 1e3 / n:.1f} ms a pass)")
    log("    stage breakdown, median ms of a warm round: "
        + ", ".join(f"{k} {v:.2f}" for k, v in
                    sorted(share.items(), key=lambda kv: -kv[1])))


# the full-width scene's FG instructions routed to its eligible instances
# (bus 0, car 1, grass 3): the random-weight matcher selects none of the
# synthetic scene's box-shaped instances
STREAM_ROUTES = {"the bus is yellow": [0], "the car is red": [1],
                 "the grass is green": [3], "the bus is blue": [0, 1],
                 "the car is yellow": [1, 3], "the grass is brown": [3, 0]}


def full_width_stream(build_session, card):
    """Path ``color_stream``: STREAM_QUEUE (a FG run of 3, BG, a FG run of
    3, BG) through ``colorize_stream`` at the default full-width config
    (``stage_trace`` on) on the synthetic 768^2 scene, a cold round then
    STREAM_WARM warm ones, with B1's launches counted over all rounds.
    The matcher selects no instance of the synthetic scene, so the same
    rounds run again on a clone routed by STREAM_ROUTES, where the FG runs
    take the generator and the compositor; the routed queue through
    sequential ``colorize`` on another clone gives the same records, and
    the canvas difference (the generator's bucket-size reduction order) is
    printed.  Per-pass walls and the stage breakdown by label for both.
    Counts B1's launches of both as paths ``color_stream`` and
    ``color_stream_routed``, tallied by shape: as served 2 BG launches a
    round and the round's matching forwards, routed 2 BG launches and one
    FG launch per segment a round.  Returns ({path: launch counts}, the
    session, the eligible instances)."""
    import torch
    from PIL import Image
    from sketchyscenecolorization_torch.text import judge_colorize_type
    tmp = tempfile.mkdtemp(prefix="smoke_stream_")
    cfg = full_width_config(tmp, stage_trace=True)
    size = cfg.pipeline.image_size
    eligible = write_scene(os.path.join(tmp, "examples"), size)
    session = build_session(cfg, seed=0, device="cuda")
    state = session._state(IMAGE_ID)    # fixture decode: set-up, not timed
    session.bg.lut_device()             # the LUT upload: set-up
    torch.cuda.synchronize()
    session.clear_trace()
    torch.cuda.reset_peak_memory_stats()

    rounds = STREAM_WARM + 1
    fg_h = text_fusion_hidden(session.fg.model)
    bg_h = text_fusion_hidden(session.bg.model)
    if fg_h == bg_h:
        raise AssertionError(f"FG and BG text fusions share H = {fg_h}")
    with b1_shapes() as served_b1:
        reset_counts()                                # path starts
        walls, parts, _ = stream_rounds(session, rounds)
        counts = read_counts()                        # path ends
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = len(STREAM_QUEUE)
    n_bg = sum(judge_colorize_type(t) == "BG" for t in STREAM_QUEUE)
    matched = {t: session.match_instances(IMAGE_ID, t)
               for t in STREAM_QUEUE if t in STREAM_ROUTES}
    if by_hidden(served_b1, bg_h) != n_bg * rounds or \
            counts["mlstm_fwd"] != sum(served_b1.values()):
        raise AssertionError(f"color_stream: B1 launches {counts['mlstm_fwd']}"
                             f", by (N, P, H) {dict(served_b1)}; expected "
                             f"{n_bg * rounds} at the BG H = {bg_h}")
    log(f"path color_stream ({n} instructions, full width, default config, "
        f"on {card}): matched {matched}; B1 launches {counts['mlstm_fwd']} "
        f"over {rounds} rounds, by (N, P, H) {dict(served_b1)}; peak device "
        f"memory {peak:.2f} GiB")
    log_rounds("as served", walls, parts)

    # the same rounds routed: each FG run is one generator launch per
    # segment of its rows, the matching forward does not run
    dirs = {k: os.path.join(tmp, k) for k in ("routed", "seq")}
    fast = routed(session.clone(seed=0, results_base_dir=dirs["routed"]),
                  STREAM_ROUTES)
    segments = fg_segments(fast, STREAM_QUEUE, STREAM_ROUTES)
    with b1_shapes() as routed_b1:
        reset_counts()                                # path starts
        walls, parts, first = stream_rounds(fast, rounds)
        routed_counts = read_counts()                 # path ends
    fg_launches = by_hidden(routed_b1, fg_h)
    if fg_launches != segments * rounds or \
            by_hidden(routed_b1, bg_h) != n_bg * rounds or \
            routed_counts["mlstm_fwd"] != sum(routed_b1.values()):
        raise AssertionError(
            f"color_stream routed: B1 launches {routed_counts['mlstm_fwd']}, "
            f"by (N, P, H) {dict(routed_b1)}; expected {segments * rounds} "
            f"at the FG H = {fg_h} ({segments} segments a round) and "
            f"{n_bg * rounds} at the BG H = {bg_h}")
    log(f"path color_stream_routed: B1 launches {routed_counts['mlstm_fwd']}"
        f" over {rounds} rounds, by (N, P, H) {dict(routed_b1)}: "
        f"{fg_launches} FG generator launches = {segments} a round (one per "
        f"segment of a FG run's rows), {n_bg * rounds} BG generator "
        f"launches, no matching forward")
    log_rounds(f"routed {STREAM_ROUTES}", walls, parts)
    seq = routed(session.clone(seed=0, results_base_dir=dirs["seq"],
                               stage_trace=False), STREAM_ROUTES)
    seq_paths = [seq.colorize(IMAGE_ID, t) for t in STREAM_QUEUE]
    records = {}
    for k, d in dirs.items():
        with open(os.path.join(d, "update_records",
                               f"{IMAGE_ID}_records.json")) as fh:
            records[k] = json.load(fh)
    if len(records["routed"]) != n * (STREAM_WARM + 1) or \
            records["routed"][:n] != records["seq"]:
        raise AssertionError("routed color_stream records: "
                             f"{len(records['routed'])}, first round equal "
                             f"to sequential "
                             f"{records['routed'][:n] == records['seq']}")
    diffs = []
    for a, b in zip(first, seq_paths):
        img = np.array(Image.open(a).convert("RGB"))
        d = np.abs(img.astype(int) - np.array(Image.open(b).convert("RGB")))
        diffs.append((int(d.max()), int((d > 0).sum())))
        if img.shape != (size, size, 3) or not (
                img[state.drawings_region]
                == state.moved[state.drawings_region]).all():
            raise AssertionError(f"color_stream result {a}: shape "
                                 f"{img.shape} or the drawings changed")
    for i in eligible:
        last_fg = np.array(Image.open(first[n - 2]).convert("RGB"))
        if (last_fg[state.inner_mask == i + 1] == 255).all():
            raise AssertionError(f"routed stream left instance {i} white")
    log(f"  routed, against sequential colorize (a clone, same seed): "
        f"records equal; canvas difference per pass (max LSB, pixels) "
        f"{diffs} (the generator's bucket-size reduction order; a BG pass "
        f"carries an earlier FG difference into its sky vote)")
    return ({"color_stream": counts, "color_stream_routed": routed_counts},
            session, eligible)


def fg_segments(session, queue, routes):
    """Generator segments of one pass of ``queue`` through
    ``session.colorize_stream`` with FG runs matched by ``routes``, by the
    session's own segmentation rule."""
    from sketchyscenecolorization_torch.text import judge_colorize_type
    pl, out, run = session.cfg.pipeline, 0, []
    for text in list(queue) + ["the sky is blue"]:
        if judge_colorize_type(text) == "FG":
            run.append(len(routes[text]))
            continue
        if run:
            seg = pl.stream_segment_rows
            if pl.stream_small_segment_rows > 0 and sum(run) <= 96:
                seg = pl.stream_small_segment_rows
            out += len(session._segments(run, seg))
        run = []
    return out


AB_N = 8            # timed commands per side of each A/B line


def serving_ab(session, eligible, card):
    """One A/B line per serving knob on clones of the full-width
    ``session`` (the same engines), the two sides interleaved (on, off,
    off, on, ...), AB_N timed commands each after one untimed: a FG pass
    forced onto every eligible instance for ``device_compositing`` and
    ``compact_fetch``, a BG command for ``device_color_gradient`` and
    ``async_png_writes``.  A command's wall ends with
    ``torch.cuda.synchronize()``; write-behind PNGs drain untimed between
    commands.  Also the peak device memory of a command above what is
    allocated before it, the LUT included."""
    import torch
    tmp = tempfile.mkdtemp(prefix="smoke_ab_")

    def forced_fg(s, i):
        s.colorize_foreground(IMAGE_ID, ("the bus is yellow",
                                         "the car is red")[i % 2], eligible,
                              f"{IMAGE_ID}_ab.png",
                              f"{IMAGE_ID}_ab.png" if i else "")

    def bg(s, i):
        s.colorize(IMAGE_ID, BG_TEXTS[i % len(BG_TEXTS)])

    knobs = [("device_compositing", forced_fg, "FG pass over "
              f"{len(eligible)} instances"),
             ("compact_fetch", forced_fg, "FG pass over "
              f"{len(eligible)} instances"),
             ("device_color_gradient", bg, "BG command"),
             ("async_png_writes", bg, "BG command")]
    base_alloc = torch.cuda.memory_allocated() / 2 ** 30
    for knob, cmd, what in knobs:
        sides = {v: session.clone(seed=0, stage_trace=False,
                                  results_base_dir=os.path.join(
                                      tmp, f"{knob}_{v}"), **{knob: v})
                 for v in (True, False)}
        walls = {True: [], False: []}
        peaks = {True: 0.0, False: 0.0}
        for i in range(AB_N + 1):
            for v in ((True, False) if i % 2 == 0 else (False, True)):
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                cmd(sides[v], i)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                sides[v].flush()
                if i:
                    walls[v].append(wall * 1e3)
                    peaks[v] = max(peaks[v], (torch.cuda.max_memory_allocated()
                                              - before) / 2 ** 20)
        log(f"A/B {knob} ({what}, on {card}): "
            + "; ".join(f"{'on' if v else 'off'} n={len(walls[v])} median "
                        f"{np.median(walls[v]):.1f} ms ({min(walls[v]):.1f}-"
                        f"{max(walls[v]):.1f}), peak +{peaks[v]:.0f} MiB"
                        for v in (True, False)))
    log(f"  device memory allocated before the A/B commands (the models, "
        f"the 48 MiB LUT, cached canvases): {base_alloc:.2f} GiB")


WARM_FG_TEXTS = ["the bus is red", "the car is blue", "the grass is green",
                 "the bus is white", "the car is black", "the grass is yellow",
                 "the bus is green", "the car is orange"]


def full_size_run(build_session, mlstm):
    import torch
    from PIL import Image
    tmp = tempfile.mkdtemp(prefix="smoke_full_")
    cfg = full_width_config(tmp)
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
    fg_walls = []
    for text in WARM_FG_TEXTS:          # new texts: a matching forward each
        t0 = time.perf_counter()
        session.colorize(IMAGE_ID, text)
        torch.cuda.synchronize()
        fg_walls.append((time.perf_counter() - t0) * 1e3)
    n_warm = len(WARM_FG_TEXTS)
    with open(rec_path) as fh:
        records = json.load(fh)
    if len(records) != n_before + 1 + n_warm or \
            records[n_before]["input_text"] != texts[1]:
        raise AssertionError(f"records after color/withdraw/color: {records}")
    routed_walls, routed_b1 = routed_fg_commands(session, tmp)

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
        + f" (warm, new texts); {n_warm} more warm FG color commands as "
          f"served (new texts, default config; no instance selected): median"
          f" {np.median(fg_walls):.1f} ms ({min(fg_walls):.1f}-"
          f"{max(fg_walls):.1f}); peak device memory {peak:.2f} GiB")
    log(f"  {len(ROUTED_FG_TEXTS)} warm FG color commands, matching forward "
        f"run and the selection routed to one instance (generator, device "
        f"compositor, compact fetch, PNG): median "
        f"{np.median(routed_walls):.1f} ms ({min(routed_walls):.1f}-"
        f"{max(routed_walls):.1f}); B1 launches by (N, P, H) "
        f"{dict(routed_b1)}")
    return launches


# new texts for warm FG commands whose matching runs but whose selection
# is routed (by the noun) to one of the synthetic scene's instances
ROUTED_FG_TEXTS = ["the bus is purple", "the car is pink",
                   "the grass is olive", "the bus is orange",
                   "the car is white", "the grass is gray",
                   "the bus is black", "the car is brown"]
NOUN_ROUTES = {"bus": [0], "car": [1], "grass": [3]}


def routed_fg_commands(session, tmp):
    """ROUTED_FG_TEXTS as ``color`` commands on a clone of the warm
    full-width ``session`` (its engines) whose matching forward runs and
    whose selection is routed by NOUN_ROUTES, after one untimed command
    (the clone's fixture decode): each command then runs the matching
    forward, the generator on one row, the device compositor, the compact
    fetch and the PNG write.  Returns ([wall ms], B1's launches by shape),
    and checks one matching and one generator launch a command."""
    import torch
    routes = {t: NOUN_ROUTES[t.split()[1]] for t in ROUTED_FG_TEXTS}
    routes["the bus is teal"] = NOUN_ROUTES["bus"]
    clone = routed(session.clone(seed=0, results_base_dir=os.path.join(
        tmp, "routed_fg")), routes, match=True)
    clone.colorize(IMAGE_ID, "the bus is teal")
    torch.cuda.synchronize()
    walls = []
    with b1_shapes() as tally:
        for text in ROUTED_FG_TEXTS:
            t0 = time.perf_counter()
            clone.colorize(IMAGE_ID, text)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    n = len(ROUTED_FG_TEXTS)
    fg_h = text_fusion_hidden(session.fg.model)
    if by_hidden(tally, fg_h) != n or sum(tally.values()) != 2 * n:
        raise AssertionError(f"routed FG commands: B1 launches {dict(tally)}"
                             f", expected {n} at H = {fg_h} and {n} more")
    return walls, tally


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
    from sketchyscenecolorization_torch.ops.conv import apply_compute_dtype
    from sketchyscenecolorization_torch.parallel import to_device
    from sketchyscenecolorization_torch.train import (
        create_matching_state, make_matching_train_step)
    cfg = MatchingConfig(vf_h=6, vf_w=6, H=48, W=48, vocab_size=12,
                         w_emb_dim=16, v_emb_dim=16, m_rnn_size=8,
                         w_rnn_size=16, max_len=5, lr_decay_step=100,
                         **VARIANTS.get(variant, {}))
    apply_compute_dtype(cfg)            # the script builds the models itself
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


def write_matching_corpus(base: str, size: int, n_images: int = 2,
                          split: str = "train"):
    """Synthetic split in the layouts ``load_data_gt`` and ``load_seg_data``
    read (``<split>/DRAWING_GT`` PNG, ``<split>/INSTANCE_GT`` and
    ``<split>/CLASS_GT`` .mat with sparse instance ids,
    ``<split>/seg_data/<id>_datas.npz`` with each instance's box as a
    predicted instance) plus ``sentence_instance_<split>.json``, five
    captions an image."""
    import scipy.io
    from PIL import Image
    train = os.path.join(base, split)
    for sub in ("DRAWING_GT", "INSTANCE_GT", "CLASS_GT", "seg_data"):
        os.makedirs(os.path.join(train, sub), exist_ok=True)
    line = max(1, size // 256)
    captions = []
    for image_id in range(1, n_images + 1):
        sketch = np.full((size, size, 3), 255, np.uint8)
        inst = np.zeros((size, size), np.uint8)
        cls = np.zeros((size, size), np.uint8)
        shift = int(0.03 * size) * (image_id - 1)
        masks = np.empty(len(INSTANCES), dtype=object)
        boxes = np.zeros((len(INSTANCES), 4), np.int32)
        for i, (cat, _, frac) in enumerate(INSTANCES):
            y1, x1, y2, x2 = (int(f * size) for f in frac)
            x1, x2 = x1 + shift, x2 + shift
            box = sketch[y1:y2 + 1, x1:x2 + 1]
            box[:line], box[-line:], box[:, :line], box[:, -line:] = 0, 0, 0, 0
            inst[y1:y2 + 1, x1:x2 + 1] = 2 * i + 3
            cls[y1:y2 + 1, x1:x2 + 1] = cat
            boxes[i] = (y1, x1, y2, x2)
            masks[i] = np.ones((y2 - y1 + 1, x2 - x1 + 1), np.uint8)
        np.savez(os.path.join(train, "seg_data", f"{image_id}_datas.npz"),
                 pred_masks=masks,
                 pred_class_ids=np.array([c for c, _, _ in INSTANCES]),
                 pred_boxes=boxes)
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
    with open(os.path.join(base, f"sentence_instance_{split}.json"),
              "w") as f:
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
        bg_ckpt_dir=""))
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
            match_ckpt_dir="", fg_ckpt_dir="", bg_ckpt_dir=""))
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


# ------------------------------------------------------------ GAN training

GAN_SMALL_STEPS = 3           # CUDA-vs-CPU steps of each GAN
GAN_RUNS = {"fg": (6, 2), "bg": (4, 2),   # full-width steps, then resumed
            "fg_perceptual": (3, 1)}
GAN_PROFILED_STEP = 4         # a warm step of each run, under the profiler
GAN_LOSS_RTOL, GAN_SN_ATOL = 1e-4, 1e-5
GAN_CLEAR_MU, GAN_UPDATE_ATOL, GAN_ADAM_BOUND = 1e-5, 1e-2, 4.0
# Adam's first moment (with b1 = 0, the step's gradient), CUDA vs CPU:
# each leaf within GAN_GRAD_REL of its largest (floored at 1e-3 of the
# model's largest); an element is held to GAN_UPDATE_ATOL lr where its
# moment is at least GAN_CLEAR_MU and GAN_CLEAR_REL of its leaf's largest
# on both sides.  With b1 = 0 an element's update carries its gradient's
# relative error: f32 gradients summed in another order differ by up to
# ~7e-4 of a leaf's largest (the spectral-normed MRU discriminator), so an
# element at 0.4-1% of its leaf's largest moves 1.0-1.3% of lr apart on
# the two devices, and only elements at a tenth of it or more are held.
GAN_GRAD_REL, GAN_CLEAR_REL = 2e-2, 1e-1
GAN_TEXT = "the sky is blue and the ground is green"


def fg_small_batch(rng, fg):
    """One FG update's batch at ``fg``'s shapes, seeded."""
    s, b = fg.image_size, fg.batch_size
    return {"images": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
            "sketches": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
            "images_d": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
            "class_id": rng.randint(0, fg.num_classes, b),
            "class_id_d": rng.randint(0, fg.num_classes, b),
            "tokens": np.concatenate([np.zeros((b, 1), np.int64),
                                      rng.randint(1, fg.vocab_size,
                                                  (b, fg.max_len - 1))], 1)}


def small_gan_batches(rng, fg, bg):
    """One FG step's (D, G) batches and one BG step's batch, seeded."""
    s, b = bg.image_size, bg.batch_size
    tokens = rng.randint(1, bg.vocab_size, (b, bg.max_len))
    tokens[0, :2] = 0
    fg_batches = (fg_small_batch(rng, fg), fg_small_batch(rng, fg))
    return fg_batches, ({
        "inputs": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
        "targets": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
        "tokens": tokens, "labels": rng.randint(0, 3, (b, s, s))},)


def check_gan_training_against_cpu():
    """Three FG and three BG train steps at small configs (64^2, base 4,
    batch 2) on CUDA and on the CPU, with the same batches and draws (the
    steps draw on the host), and three FG steps with the perceptual term
    (``coeff_perceptual`` 1, a fresh Inception-v4 stem through Mixed_5b,
    the same weights on both).  Each step starts both from the CPU run's
    state: Adam's first updates move every element by about +-lr, the
    ones whose gradient is at rounding level either way, so free-running
    runs part by ~1% of some weights.  Losses and EMAs agree within
    GAN_LOSS_RTOL, the committed spectral-norm vectors within GAN_SN_ATOL,
    each leaf's gradient (Adam's first moment) within GAN_GRAD_REL of its
    largest, an element whose moment is at least GAN_CLEAR_MU and
    GAN_CLEAR_REL of its leaf's largest on both within GAN_UPDATE_ATOL lr
    and every element within GAN_ADAM_BOUND lr; B1
    twice and B2 once a step on CUDA (the fakes of the D update, the G
    update's forward and its backward), never on the CPU."""
    import torch
    import copy
    from sketchyscenecolorization_torch.config import (BGGanConfig,
                                                       FGGanConfig)
    from sketchyscenecolorization_torch.models.inception_v4 import \
        InceptionV4
    from sketchyscenecolorization_torch.ops.conv import apply_compute_dtype
    from sketchyscenecolorization_torch.train import (
        create_bg_gan_state, create_fg_gan_state, make_bg_gan_train_step,
        make_fg_gan_train_step)
    fg = FGGanConfig(batch_size=2, image_size=64, vocab_size=10, max_len=4,
                     base_channels=4, noise_dim=8, max_iters=100)
    bg = BGGanConfig(batch_size=2, image_size=64, vocab_size=8, max_len=4,
                     ngf=4, ndf=4, multi_residual=False, max_steps=100)
    fg_perc = dataclasses.replace(fg, coeff_perceptual=1.0)
    apply_compute_dtype(fg, bg)         # the script builds the models itself
    inception = InceptionV4("Mixed_5b",
                            generator=torch.Generator().manual_seed(5))

    def make_fg(cfg, device):
        return make_fg_gan_train_step(cfg)

    def make_fg_perceptual(cfg, device):
        return make_fg_gan_train_step(
            cfg, perceptual=copy.deepcopy(inception).to(device))

    def make_bg(cfg, device):
        return make_bg_gan_train_step(cfg)
    rng = np.random.RandomState(0)
    batches = [small_gan_batches(rng, fg, bg) for _ in range(GAN_SMALL_STEPS)]
    fg_lr = {"generator": fg.lr_g, "discriminator": fg.lr_d}
    for kind, cfg, create, make, lr in (
            ("FG", fg, create_fg_gan_state, make_fg, fg_lr),
            ("FG perceptual", fg_perc, create_fg_gan_state,
             make_fg_perceptual, fg_lr),
            ("BG", bg, create_bg_gan_state, make_bg,
             {"generator": bg.lr, "discriminator": bg.lr})):
        gan_steps_against_cpu(
            kind, cfg, create, make, lr,
            [b[1] if kind == "BG" else b[0] for b in batches])


def gan_steps_against_cpu(kind, cfg, create, make, lr, batches):
    """``len(batches)`` train steps of ``cfg``'s GAN on CUDA and on the CPU,
    each from the CPU run's state, with the checks and the log line of
    ``check_gan_training_against_cpu``."""
    import torch
    from sketchyscenecolorization_torch.parallel import to_device
    t0 = time.perf_counter()
    cpu, gpu = create(cfg, device="cpu"), create(cfg, device="cuda")
    step_cpu, step_gpu = make(cfg, "cpu"), make(cfg, "cuda")
    loss_err = sn_err = update_err = adam = grad_err = 0.0
    losses = []
    for i, args in enumerate(batches):
        gpu.load_state_dict(cpu.state_dict())
        reset_counts()
        gpu, m_gpu = step_gpu(gpu, *(to_device(b, "cuda") for b in args))
        torch.cuda.synchronize()
        counts = read_counts()
        cpu, m_cpu = step_cpu(cpu,
                              *(to_device(b, "cpu") for b in args))
        if read_counts() != counts or counts["mlstm_fwd"] != 2 or \
                counts["mlstm_bwd"] != 1:
            raise AssertionError(f"{kind} step {i + 1}: launches {counts}"
                                 f" on CUDA, {read_counts()} after the "
                                 "CPU step; expected B1 2, B2 1, CPU 0")
        for key, want in m_cpu.items():
            if key == "nan":
                if bool(want) or bool(m_gpu[key]):
                    raise AssertionError(f"{kind} step {i + 1}: NaN")
                continue
            err = abs(float(m_gpu[key]) / float(want) - 1)
            if not err <= GAN_LOSS_RTOL:
                raise AssertionError(f"{kind} step {i + 1} {key}: CUDA "
                                     f"{float(m_gpu[key])} vs CPU "
                                     f"{float(want)}")
            loss_err = max(loss_err, err)
        losses.append(float(m_cpu["gen_loss" if "gen_loss" in m_cpu
                                  else "loss_g"]))
        for want, got in zip(cpu.discriminator.buffers(),
                             gpu.discriminator.buffers()):
            sn_err = max(sn_err, float((got.cpu() - want).abs().max()))
        if sn_err > GAN_SN_ATOL:
            raise AssertionError(f"{kind} step {i + 1}: committed u "
                                 f"differ by {sn_err}")
        for side, opt_c, opt_g in (
                ("generator", cpu.g_opt, gpu.g_opt),
                ("discriminator", cpu.d_opt, gpu.d_opt)):
            want = dict(getattr(cpu, side).named_parameters())
            got = dict(getattr(gpu, side).named_parameters())
            top = max(float(m.abs().max()) for m in opt_c.mu.values())
            for name, w in want.items():
                leaf = float(opt_c.mu[name].abs().max())
                g_err = float((opt_g.mu[name].cpu() - opt_c.mu[name])
                              .abs().max()) / max(leaf, 1e-3 * top)
                grad_err = max(grad_err, g_err)
                if g_err > GAN_GRAD_REL:
                    raise AssertionError(f"{kind} step {i + 1} {side}."
                                         f"{name}: gradient {g_err}")
                clear_mu = max(GAN_CLEAR_MU, GAN_CLEAR_REL * leaf)
                diff = (got[name].detach().cpu() - w.detach()).abs() \
                    / lr[side]
                clear = (opt_c.mu[name].abs() >= clear_mu) & \
                    (opt_g.mu[name].cpu().abs() >= clear_mu)
                adam = max(adam, float(diff.max()))
                if clear.any():
                    update_err = max(update_err, float(diff[clear].max()))
                if update_err > GAN_UPDATE_ATOL or adam > GAN_ADAM_BOUND:
                    at = int(torch.argmax(diff * clear))
                    mu_c, mu_g = opt_c.mu[name], opt_g.mu[name].cpu()
                    log(f"  {side}.{name}: worst clear element {at}: moment "
                        f"CPU {float(mu_c.flatten()[at]):.6g}, CUDA "
                        f"{float(mu_g.flatten()[at]):.6g}; the leaf's "
                        f"largest {float(mu_c.abs().max()):.6g}; second "
                        f"moment {float(opt_c.nu[name].flatten()[at]):.6g}"
                        f"; largest leaf gradient difference "
                        f"{float((mu_g - mu_c).abs().max()):.6g}")
                    raise AssertionError(
                        f"{kind} step {i + 1} {side}.{name}: CUDA vs CPU "
                        f"{update_err} lr on clear elements, {adam} lr "
                        "on any")
    log(f"small-config {kind} GAN training, {len(batches)} steps from "
        f"the same states, CUDA vs CPU: G losses "
        f"{[f'{x:.4f}' for x in losses]}, losses and EMAs max relative "
        f"difference {loss_err:.2e} (tol {GAN_LOSS_RTOL:.0e}); committed "
        f"u max-abs {sn_err:.2e} (tol {GAN_SN_ATOL:.0e}); parameters "
        f"{update_err:.2e} lr where the moment >= {GAN_CLEAR_MU:.0e} and "
        f"{GAN_CLEAR_REL:.0e} of its leaf's largest (tol "
        f"{GAN_UPDATE_ATOL:.0e}), {adam:.2f} lr at most (Adam bound "
        f"{GAN_ADAM_BOUND}); gradients {grad_err:.2e} of each leaf's "
        f"largest (tol {GAN_GRAD_REL:.0e}); B1 2 and B2 1 launches a CUDA "
        f"step; {time.perf_counter() - t0:.1f} s")


def write_fg_gan_data(base, n=4, text_len=15):
    """records/train/bus.npz (``n`` synthetic 384^2 pairs) and
    records/val/bus.npz (one), written with the port's
    ``write_record_shard``."""
    from sketchyscenecolorization_torch.data import write_record_shard
    rng = np.random.RandomState(3)
    for split, k in (("train", n), ("val", 1)):
        cartoons = rng.randint(0, 256, (k, 384, 384, 3)).astype(np.uint8)
        sketches = np.full((k, 384, 384, 3), 255, np.uint8)
        sketches[:, 64:320:9, 40:340] = 0
        sketches[:, 40:340, 64:320:11] = 0
        tokens = rng.randint(1, 58, (k, text_len)).astype(np.uint8)
        tokens[:, :text_len // 2] = 0
        write_record_shard(os.path.join(base, "records", split, "bus.npz"),
                           [f"bus{i}.png" for i in range(k)], cartoons,
                           sketches, "bus", np.full(k, 7), ["red"] * k,
                           tokens)


def write_bg_gan_data(base, size, n=2):
    """captions/{train,test}.json and their foreground, background and
    segment PNGs (``n`` train entries, one test entry) at ``size``^2."""
    from PIL import Image
    rng = np.random.RandomState(4)
    for split, k in (("train", n), ("test", 1)):
        entries = []
        for i in range(k):
            name = f"{split}{i}.png"
            for sub in ("foreground", "background"):
                os.makedirs(os.path.join(base, sub, split), exist_ok=True)
                img = np.repeat(rng.randint(0, 256, (size // 16, size // 16,
                                                     3)), 16, 0)
                Image.fromarray(np.repeat(img, 16, 1).astype(np.uint8)).save(
                    os.path.join(base, sub, split, name))
            seg = np.full((size, size), 128, np.uint8)
            seg[size // 2:] = 255
            seg[size // 4: size // 2, size // 4: 3 * size // 4] = 0
            os.makedirs(os.path.join(base, "segment", split), exist_ok=True)
            Image.fromarray(np.repeat(seg[:, :, None], 3, 2)).save(
                os.path.join(base, "segment", split, name))
            entries.append({"fg_name": name, "bg_name": name,
                            "color_text": GAN_TEXT})
        os.makedirs(os.path.join(base, "captions"), exist_ok=True)
        with open(os.path.join(base, "captions", f"{split}.json"), "w") as f:
            json.dump(entries, f)


def gan_cli_run(kind, main, argv_for, harness, make_name):
    """Run a GAN CLI for GAN_RUNS[kind] steps and resume it, each step
    timed (synchronised), one warm step under ``torch.profiler``.  Returns
    (records [(wall, B1, B2, metrics)], {"kernels", "wall"} of the profiled
    step, launch counts of the path, B1/B2 launches by shape, peak GiB)."""
    import torch
    steps, resumed = GAN_RUNS[kind]
    records, profiled = [], {}
    make = getattr(harness, make_name)

    def instrumented(*a, **kw):
        step = make(*a, **kw)

        def timed(state, *batches):
            fwd, bwd = (read_counts()[k] for k in ("mlstm_fwd", "mlstm_bwd"))
            if len(records) + 1 == GAN_PROFILED_STEP:
                (state, metrics), wall, kernels = profile_kernels(
                    lambda: step(state, *batches))
                profiled.update(kernels=kernels, wall=wall)
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, *batches)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            after = read_counts()
            records.append((wall, after["mlstm_fwd"] - fwd,
                            after["mlstm_bwd"] - bwd,
                            {k: float(v) for k, v in metrics.items()}))
            return state, metrics
        return timed

    torch.cuda.reset_peak_memory_stats()
    reset_counts()                                                 # path
    setattr(harness, make_name, instrumented)
    try:
        with b1_shapes() as shapes:
            if main(argv_for(steps, False)) != 0:
                raise AssertionError(f"{kind} training returned non-zero")
            if main(argv_for(steps + resumed, True)) != 0:
                raise AssertionError(f"{kind} resumed training returned "
                                     "non-zero")
    finally:
        setattr(harness, make_name, make)
    counts = read_counts()                                         # ends
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if len(records) != steps + resumed:
        raise AssertionError(f"{kind}: {len(records)} steps ran, expected "
                             f"{steps} then {resumed} resumed")
    for i, (_, fwd, bwd, metrics) in enumerate(records):
        finite = np.isfinite([v for k, v in metrics.items() if k != "nan"])
        if fwd != 2 or bwd != 1 or not finite.all() or metrics["nan"]:
            raise AssertionError(f"{kind} step {i + 1}: {fwd} B1 and {bwd} "
                                 f"B2 launches, metrics {metrics}")
    return records, profiled, counts, dict(shapes), peak


def report_gan_run(kind, records, profiled, counts, shapes, peak, loss_key):
    """Log a GAN run's step walls, profiled breakdown and launches; returns
    (the profiled step's device ms, the median warm step's wall ms)."""
    steps, _ = GAN_RUNS[kind]
    walls = [r[0] for r in records]
    warm = [w for i, w in enumerate(walls)
            if i not in (0, steps, GAN_PROFILED_STEP - 1)]
    median_ms = float(np.median(warm)) * 1e3
    kernels = profiled["kernels"]
    total = sum(kernels.values())
    b1_ms, b2_ms = (sum(v for k, v in kernels.items()
                        if any(n in k for n in names))
                    for names in (B1_NAMES, B2_NAMES))
    conv_ms = sum(v for k, v in kernels.items()
                  if any(w in k.lower() for w in CONV_KERNEL_WORDS))
    if total <= 0 or b1_ms <= 0 or b2_ms <= 0:
        raise AssertionError(f"{kind}: torch.profiler saw no device time for "
                             f"B1/B2: {sorted(kernels)[:20]}")
    log(f"  {kind} losses ({loss_key}) per step: "
        + ", ".join(f"{r[3][loss_key]:.3f}" for r in records))
    log(f"  {kind} step wall: first {walls[0]:.3f} s, first after resume "
        f"{walls[steps]:.3f} s, median warm {median_ms:.1f} ms (n="
        f"{len(warm)}, min {min(warm) * 1e3:.1f}, max {max(warm) * 1e3:.1f});"
        f" peak device memory {peak:.2f} GiB")
    log(f"  {kind} profiled step {GAN_PROFILED_STEP} (torch.profiler on, wall "
        f"{profiled['wall'] * 1e3:.1f} ms): device kernel time {total:.2f} "
        f"ms, cuDNN/conv kernels {conv_ms:.2f} ms ({conv_ms / total:.1%}), B1 "
        f"{b1_ms:.3f} ms ({b1_ms / total:.1%}), B2 {b2_ms:.3f} ms "
        f"({b2_ms / total:.1%}); against the median warm step: device idle "
        f"{1 - total / median_ms:.1%}")
    log(f"  {kind} launches on the path: B1 {counts['mlstm_fwd']}, B2 "
        f"{counts['mlstm_bwd']}; by shape (N, P, H): "
        + ", ".join(f"{'B2' if k[0] == 'B2' else 'B1'} {k[-3:]}: {v}"
                    for k, v in sorted(shapes.items(), key=str)))
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {ms:8.3f} ms  {name[:100]}")
    return total, median_ms


def _moved_generator(kind, cfg, snapshot_root):
    """Check the newest snapshot's generator moved from its fresh init;
    returns (step, the snapshot's generator state)."""
    import torch
    from sketchyscenecolorization_torch.train import bg_gan, fg_gan
    from sketchyscenecolorization_torch.utils.checkpoint import (
        latest_checkpoint, restore_checkpoint)
    step, path = latest_checkpoint(snapshot_root)
    saved = restore_checkpoint(path, map_location="cpu")
    init = (fg_gan if kind == "fg" else bg_gan).build_models(cfg)[0] \
        .state_dict()
    moved = sum(not torch.equal(v, init[k])
                for k, v in saved["generator"].items())
    if saved["step"] != step or moved < len(init) // 2:
        raise AssertionError(f"{kind} snapshot step {saved['step']} (dir "
                             f"{step}), {moved}/{len(init)} leaves moved")
    return step, saved["generator"]


def full_width_gan_training():
    """``cli_fg_gan --mode train`` at the default ``FGGanConfig`` (192^2,
    batch 2, base 64, noise 256, 25 classes, vocab 58) on a synthetic 384^2
    record shard for 6 steps, then ``--resume_from`` to 8; ``cli_bg_gan
    --mode train`` at the default ``BGGanConfig`` (768^2, batch 1, ngf/ndf
    64, ``multi_residual``, the residual discriminator) on synthetic
    captions and images for 4 steps, then resumed to 6.  Returns ({path:
    launch counts}, {"fg"/"bg": (run dir, data dir)})."""
    from sketchyscenecolorization_torch import cli_bg_gan, cli_fg_gan
    from sketchyscenecolorization_torch.config import BGGanConfig, FGGanConfig
    from sketchyscenecolorization_torch.train import harness
    from sketchyscenecolorization_torch.utils.checkpoint import (
        list_checkpoint_steps)
    paths, runs = {}, {}
    t0 = time.perf_counter()
    fg_cfg = FGGanConfig()
    tmp = tempfile.mkdtemp(prefix="smoke_fg_gan_")
    write_fg_gan_data(tmp)
    out = os.path.join(tmp, "outputs")
    log(f"full-width FG GAN training (cli_fg_gan): {fg_cfg.image_size}^2, "
        f"batch {fg_cfg.batch_size}, base {fg_cfg.base_channels}, noise "
        f"{fg_cfg.noise_dim}, {fg_cfg.num_classes} classes, vocab "
        f"{fg_cfg.vocab_size}, spectral norm, WGAN-SN + ACGAN; synthetic "
        f"shard of 4 384^2 pairs")

    def fg_argv(steps, resume):
        run = os.path.join(out, os.listdir(out)[0]) if resume else ""
        return (["--mode", "train", "--data_base_dir", tmp,
                 "--max_iter_step", str(steps), "--device", "cuda"]
                + (["--resume_from", run] if resume
                   else ["--output_base_dir", out]))
    fg = gan_cli_run("fg", cli_fg_gan.main, fg_argv, harness,
                     "make_fg_gan_train_step")
    (fg_run,) = [os.path.join(out, d) for d in os.listdir(out)]
    snaps = list_checkpoint_steps(os.path.join(fg_run, "snapshot"))
    if snaps != [6, 8]:
        raise AssertionError(f"FG snapshots {snaps}, expected [6, 8]")
    _moved_generator("fg", fg_cfg, os.path.join(fg_run, "snapshot"))
    runs["fg_device_ms"], _ = report_gan_run("fg", *fg, "loss_g")
    log(f"  FG snapshots at steps {snaps}; train_fg_gan phase "
        f"{time.perf_counter() - t0:.1f} s")
    paths["train_fg_gan"] = fg[2]
    runs["fg"] = (fg_run, tmp)
    del fg
    release()

    t0 = time.perf_counter()
    bg_cfg = BGGanConfig()
    tmp = tempfile.mkdtemp(prefix="smoke_bg_gan_")
    write_bg_gan_data(tmp, bg_cfg.image_size)
    bg_run = os.path.join(tmp, "run")
    log(f"full-width BG GAN training (cli_bg_gan): {bg_cfg.image_size}^2, "
        f"batch {bg_cfg.batch_size}, ngf {bg_cfg.ngf}, ndf {bg_cfg.ndf}, "
        f"multi_residual, residual discriminator, remat off; 2 synthetic "
        f"entries")

    def bg_argv(steps, resume):
        return ["--mode", "train", "--data_base_dir", tmp, "--run_dir",
                bg_run, "--vocab_path",
                os.path.join(ROOT, "data", "bg_vocab.txt"), "--max_steps",
                str(steps), "--device", "cuda"]
    bg = gan_cli_run("bg", cli_bg_gan.main, bg_argv, harness,
                     "make_bg_gan_train_step")
    snaps = list_checkpoint_steps(os.path.join(bg_run, "snapshot"))
    if snaps != [4, 6]:
        raise AssertionError(f"BG snapshots {snaps}, expected [4, 6]")
    _moved_generator("bg", bg_cfg, os.path.join(bg_run, "snapshot"))
    report_gan_run("bg", *bg, "gen_loss")
    log(f"  BG snapshots at steps {snaps}; train_bg_gan phase "
        f"{time.perf_counter() - t0:.1f} s")
    paths["train_bg_gan"] = bg[2]
    runs["bg"] = (bg_run, tmp)
    return paths, runs


def serve_trained_gans(build_session, runs):
    """``build_session`` with ``fg_ckpt_dir``/``bg_ckpt_dir`` on the GAN
    runs' snapshots: its generators hold the snapshots' parameters; one FG
    command routed to an instance and one BG command run on them (path
    ``serve_gans``); then ``cli_fg_gan --mode val`` and ``cli_bg_gan
    --mode test`` on one entry each."""
    import torch
    from PIL import Image
    from sketchyscenecolorization_torch import cli_bg_gan, cli_fg_gan
    from sketchyscenecolorization_torch.utils.checkpoint import (
        latest_checkpoint, restore_checkpoint)
    t0 = time.perf_counter()
    (fg_run, fg_data), (bg_run, bg_data) = runs["fg"], runs["bg"]
    tmp = tempfile.mkdtemp(prefix="smoke_serve_gans_")
    cfg = full_width_config(tmp)
    eligible = write_scene(os.path.join(tmp, "examples"),
                           cfg.pipeline.image_size)
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, fg_ckpt_dir=os.path.join(fg_run, "snapshot"),
        bg_ckpt_dir=os.path.join(bg_run, "snapshot")))
    session = build_session(cfg, seed=0, device="cuda")
    for engine, root in ((session.fg, cfg.pipeline.fg_ckpt_dir),
                         (session.bg, cfg.pipeline.bg_ckpt_dir)):
        saved = restore_checkpoint(latest_checkpoint(root)[1],
                                   map_location="cpu")["generator"]
        served = engine.model.state_dict()
        for key, value in saved.items():
            if not torch.equal(served[key].cpu(), value):
                raise AssertionError(f"served {key} differs from {root}")
    routed(session, {"the bus is yellow": [eligible[0]]})
    reset_counts()                                     # path starts
    fg_out = session.colorize(IMAGE_ID, "the bus is yellow")
    bg_out = session.colorize(IMAGE_ID, GAN_TEXT)
    torch.cuda.synchronize()
    counts = read_counts()                             # path ends
    for out in (fg_out, bg_out):
        img = np.array(Image.open(out))
        if img.shape != (cfg.pipeline.image_size,) * 2 + (3,):
            raise AssertionError(f"{out}: shape {img.shape}")
    if counts["mlstm_fwd"] != 2:
        raise AssertionError(f"serving the trained generators: "
                             f"{counts['mlstm_fwd']} B1 launches, expected 2")
    del session
    release()
    if cli_fg_gan.main(["--mode", "val", "--resume_from", fg_run,
                        "--data_base_dir", fg_data, "--device",
                        "cuda"]) != 0:
        raise AssertionError("cli_fg_gan --mode val failed")
    val = sorted(os.listdir(os.path.join(fg_run, "results", "with_text")))
    if val != ["bus_bus0_input.png", "bus_bus0_output.png",
               "bus_bus0_target.png"]:
        raise AssertionError(f"cli_fg_gan --mode val wrote {val}")
    if cli_bg_gan.main(["--mode", "test", "--data_base_dir", bg_data,
                        "--run_dir", bg_run, "--vocab_path",
                        os.path.join(ROOT, "data", "bg_vocab.txt"),
                        "--device", "cuda"]) != 0:
        raise AssertionError("cli_bg_gan --mode test failed")
    test = sorted(os.listdir(os.path.join(bg_run, "test_results")))
    if len(test) != 3:
        raise AssertionError(f"cli_bg_gan --mode test wrote {test}")
    log(f"session on the GAN runs' snapshots: both generators equal the "
        f"snapshots'; a routed FG command and a BG command on them (B1 "
        f"{counts['mlstm_fwd']}); cli_fg_gan --mode val wrote {val}, "
        f"cli_bg_gan --mode test wrote {test}; "
        f"{time.perf_counter() - t0:.1f} s")
    return counts


# ------------------------------------------------------------ evaluation

EVAL_IMAGES = 4     # synthetic 768^2 val images of the full-width eval
EVAL_SMALL = 48     # image size of the CUDA-vs-CPU eval
INCEPTION_BATCH = 8     # inception_v4_class_probs' default batch
INCEPTION_ITERS = 10
INCEPTION_REL = 1e-4    # CUDA vs CPU: an endpoint's max-abs error over its
                        # largest magnitude
IS_IMAGES = 16      # FG generator outputs scored by the inception scores


def eval_matching_run(tmp):
    """``cli_matching --mode eval`` at the default full-width
    ``MatchingConfig`` on the training run's newest snapshot
    (``<tmp>/run``), over a synthetic val split of EVAL_IMAGES 768^2 images
    x 5 captions with mask AP on (path ``eval_matching``): the wall per
    image and per caption of ``eval_matching``'s loop (timed apart from the
    model's build and restore), each image's prediction (one backbone
    forward and one B1 launch for its captions), B1's launches by shape,
    peak device memory and the summary lines.  Returns the path's launch
    counts."""
    import torch
    from sketchyscenecolorization_torch import cli_matching, train
    from sketchyscenecolorization_torch.config import MatchingConfig
    cfg = MatchingConfig()
    write_matching_corpus(tmp, cfg.H, EVAL_IMAGES, split="val")
    run_dir = os.path.join(tmp, "run")
    argv = ["--mode", "eval", "--data_base_dir", tmp, "--captions_base_dir",
            tmp, "--seg_data_base_dir", tmp, "--vocab_path",
            os.path.join(ROOT, "data", "match_vocab.txt"), "--run_dir",
            run_dir]
    evaluate, timing = train.eval_matching, {"predict": []}

    def timed_eval(predict_fn, *args, predict_batch_fn=None, **kw):
        def predict(image, captions):
            t0 = time.perf_counter()
            out = predict_batch_fn(image, captions)     # host masks: synced
            timing["predict"].append((time.perf_counter() - t0,
                                      len(captions)))
            return out
        t0 = time.perf_counter()
        timing["result"] = evaluate(predict_fn, *args,
                                    predict_batch_fn=predict, **kw)
        timing["loop"] = time.perf_counter() - t0
        return timing["result"]

    torch.cuda.reset_peak_memory_stats()
    reset_counts()                                    # path starts
    train.eval_matching = timed_eval
    try:
        with b1_shapes() as shapes:
            t0 = time.perf_counter()
            if cli_matching.main(argv) != 0:
                raise AssertionError("cli_matching --mode eval returned "
                                     "non-zero")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        train.eval_matching = evaluate
    counts = read_counts()                            # path ends
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    result, predicts = timing["result"], timing["predict"]
    n_caps = sum(n for _, n in predicts)
    path = os.path.join(run_dir, "eval_results", "deeplab_val_result.txt")
    with open(path) as f:
        written = f.read()
    if (len(predicts) != EVAL_IMAGES or n_caps != 5 * EVAL_IMAGES
            or result.num_samples != n_caps or result.mean_ap is None
            or not np.isfinite([result.cum_iou, result.mean_ap]).all()
            or result.summary() not in written):
        raise AssertionError(f"eval: {len(predicts)} images, {n_caps} "
                             f"captions, {result.num_samples} samples, "
                             f"mAP {result.mean_ap}; the result file holds "
                             f"{len(written)} bytes")
    if counts["mlstm_fwd"] != EVAL_IMAGES or \
            dict(shapes) != {(5, cfg.vf_h * cfg.vf_w, cfg.m_rnn_size):
                             EVAL_IMAGES}:
        raise AssertionError(f"eval: B1 launches {counts['mlstm_fwd']}, by "
                             f"shape {dict(shapes)}; expected one a image at"
                             f" N = 5")
    loop = timing["loop"]
    pred = [w for w, _ in predicts]
    log(f"path eval_matching: cli_matching --mode eval at {cfg.H}^2 "
        f"(ResNet-101, m_rnn {cfg.m_rnn_size}), {EVAL_IMAGES} images x 5 "
        f"captions, mask AP on: command {wall:.3f} s (model build and "
        f"restore included), eval loop {loop:.3f} s = "
        f"{loop / EVAL_IMAGES * 1e3:.1f} ms an image, "
        f"{loop / n_caps * 1e3:.1f} ms a caption; prediction (backbone + B1 "
        f"on 5 captions + host masks) first {pred[0] * 1e3:.1f} ms, then "
        f"{', '.join(f'{w * 1e3:.1f}' for w in pred[1:])} ms; the rest of "
        f"the loop (GT loading on its worker, host metrics and mask AP) "
        f"{(loop - sum(pred)) / EVAL_IMAGES * 1e3:.1f} ms an image; peak "
        f"device memory {peak:.2f} GiB; B1 {counts['mlstm_fwd']} launches, "
        f"by (N, P, H) {dict(shapes)}")
    for line in result.summary().splitlines():
        log(f"  {line}")
    return counts


def _up_logits(engine, image_u8, captions):
    """The matching model's ``up`` logits [M, H, W] of ``predict_masks``."""
    import torch
    from sketchyscenecolorization_torch.pipeline.engines import PIXEL_MU
    image = (image_u8.astype(np.float32) - PIXEL_MU).astype(np.float32)
    words, lens = engine.encode_texts(captions)
    with torch.no_grad():
        visual = engine.model.extract_visual(
            torch.from_numpy(image[None]).to(engine.device))
        up = engine.model.apply_fused(
            visual, torch.from_numpy(words.astype(np.int64)).to(engine.device),
            torch.from_numpy(lens.astype(np.int64)).to(engine.device)).up
    return up[..., 0].cpu().numpy()


def check_eval_against_cpu():
    """``eval_matching`` with mask AP at a EVAL_SMALL^2 config on CUDA and
    on the CPU from the same seeded weights, over a synthetic val split of
    2 images x 5 captions: every mask equal and the results equal.  A pixel
    that flips at the 1e-9 threshold is printed with the logits' max-abs
    difference, and passes only where the CPU logit is within that
    difference of the threshold (a tie)."""
    import copy
    import torch
    from sketchyscenecolorization_torch.config import MatchingConfig
    from sketchyscenecolorization_torch.data import matching_dataset as md
    from sketchyscenecolorization_torch.models.rmi import RMI
    from sketchyscenecolorization_torch.ops.conv import apply_compute_dtype
    from sketchyscenecolorization_torch.pipeline.engines import \
        MatchingEngine
    from sketchyscenecolorization_torch.text import load_vocab
    from sketchyscenecolorization_torch.train import eval_matching
    t0 = time.perf_counter()
    s = EVAL_SMALL
    cfg = MatchingConfig(H=s, W=s, vf_h=s // 8, vf_w=s // 8, w_emb_dim=16,
                         v_emb_dim=16, m_rnn_size=8, w_rnn_size=16)
    apply_compute_dtype(cfg)            # the script builds the model itself
    model = RMI(cfg, torch.Generator().manual_seed(4))
    vocab = load_vocab(os.path.join(ROOT, "data", "match_vocab.txt"))
    tmp = tempfile.mkdtemp(prefix="smoke_eval_small_")
    write_matching_corpus(tmp, s, 2, split="val")
    base = os.path.join(tmp, "val")
    runs, image_size = [], md.IMAGE_SIZE
    md.IMAGE_SIZE = s
    try:
        for device in ("cuda", "cpu"):
            engine = MatchingEngine(cfg, copy.deepcopy(model), vocab,
                                    device=device)
            record = []

            def predict(image, captions):
                out = engine.predict_masks(image, captions)
                record.append((image, list(captions), out))
                return out
            reset_counts()
            result = eval_matching(
                None, base, os.path.join(tmp, "sentence_instance_val.json"),
                seg_data_base_dir=base, predict_batch_fn=predict)
            runs.append((result, record, engine, read_counts()))
    finally:
        md.IMAGE_SIZE = image_size
    (r_gpu, rec_gpu, e_gpu, c_gpu), (r_cpu, rec_cpu, e_cpu, c_cpu) = runs
    if c_gpu["mlstm_fwd"] != 2 or c_cpu["mlstm_fwd"] != 0:
        raise AssertionError(f"B1 launches: CUDA {c_gpu['mlstm_fwd']}, CPU "
                             f"{c_cpu['mlstm_fwd']}; expected 2 and 0")
    flips, logit_err, n_pixels = 0, 0.0, 0
    for (image, captions, m_gpu), (_, _, m_cpu) in zip(rec_gpu, rec_cpu):
        n_pixels += m_cpu.size
        up_gpu, up_cpu = (_up_logits(e, image, captions)
                          for e in (e_gpu, e_cpu))
        err = float(np.abs(up_gpu - up_cpu).max())
        logit_err = max(logit_err, err)
        flipped = m_gpu != m_cpu
        if flipped.any():
            flips += int(flipped.sum())
            near = np.abs(up_cpu - e_cpu.score_thresh)[flipped]
            log(f"  eval CUDA vs CPU: {int(flipped.sum())} mask pixels flip "
                f"at the threshold; logits max-abs difference {err:.3e}, "
                f"the flipped pixels' CPU logits within {near.max():.3e} of "
                f"it")
            if near.max() > err:
                raise AssertionError("a mask pixel flipped away from the "
                                     "threshold")
    if not flips and (r_gpu.summary() != r_cpu.summary()
                      or not np.array_equal(r_gpu.map_list, r_cpu.map_list)):
        raise AssertionError(f"eval results differ:\n{r_gpu.summary()}\n"
                             f"{r_cpu.summary()}")
    log(f"small-config eval_matching ({s}^2, 2 images x 5 captions, mask AP "
        f"on), CUDA vs CPU: {flips} of {n_pixels} mask pixels differ, "
        f"logits max-abs difference {logit_err:.3e}, results "
        f"{'equal' if not flips else 'printed'} (overall IoU "
        f"{r_gpu.cum_iou:.6f}, mAP {r_gpu.mean_ap}); B1 2 launches on CUDA; "
        f"{time.perf_counter() - t0:.1f} s")
    if flips:
        log(f"  CUDA:\n{r_gpu.summary()}\n  CPU:\n{r_cpu.summary()}")


def tf32_line():
    """One BG generator forward at the default full width (768^2, ngf 64,
    multi_residual, fresh seeded weights) in f32, as the port runs, and
    with TF32 switched on here for cuDNN and cuBLAS: the output's max-abs
    difference, both CUDA-event times and both device kernel times of one
    profiled forward (the host's enqueue is about as long as the forward,
    so the events alone can hide a faster device), to rank TF32 later."""
    import torch
    from sketchyscenecolorization_torch.config import BGGanConfig
    from sketchyscenecolorization_torch.models import bg_gan
    from sketchyscenecolorization_torch.ops.conv import apply_compute_dtype
    cfg = BGGanConfig()
    apply_compute_dtype(cfg)            # the script builds the model itself
    gen = bg_gan.build_generator(cfg, torch.Generator().manual_seed(0)) \
        .cuda().eval()
    rng = np.random.RandomState(6)
    s = cfg.image_size
    x = torch.from_numpy(rng.uniform(-1, 1, (1, s, s, 3))
                         .astype(np.float32)).cuda()
    tokens = torch.from_numpy(rng.randint(1, cfg.vocab_size,
                                          (1, cfg.max_len))).cuda()
    def forward():
        return gen(x, tokens)[0]

    def device_ms():
        return sum(profile_kernels(forward)[2].values())
    with torch.no_grad():
        f32_ms = cuda_ms(forward, 5)
        want, f32_dev = forward(), device_ms()
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32_ms = cuda_ms(forward, 5)
            got, tf32_dev = forward(), device_ms()
        finally:
            apply_compute_dtype(cfg)
    err = float((got - want).abs().max())
    log(f"TF32 (switched on here only): BG generator forward at {s}^2, ngf "
        f"{cfg.ngf}: f32 {f32_ms:.2f} ms, TF32 {tf32_ms:.2f} ms (CUDA events,"
        f" mean of 5); device kernel time of one profiled forward f32 "
        f"{f32_dev:.2f} ms, TF32 {tf32_dev:.2f} ms; output max-abs "
        f"difference {err:.3e} on [-1, 1], "
        f"{float((got - want).abs().mean()):.3e} mean")
    del gen


def inception_run(gan_runs):
    """Inception-v4 with its heads (1001 classes, AuxLogits) at 299^2 and
    batch INCEPTION_BATCH, fresh seeded weights: forward ms (CUDA events),
    GFLOP/s from the convolutions' and heads' shapes and peak memory;
    CUDA against the port's CPU path at batch 1, each endpoint's max-abs
    error over its largest magnitude within INCEPTION_REL; then
    ``inception_v4_class_probs`` and ``acgan_class_probs`` (on the FG run's
    restored discriminator) with ``inception_score`` on IS_IMAGES outputs
    of the FG run's restored generator (path ``inception``, no B kernel)."""
    import copy
    import torch
    from sketchyscenecolorization_torch.config import FGGanConfig
    from sketchyscenecolorization_torch.data import (preprocess_pair,
                                                     read_record_shard)
    from sketchyscenecolorization_torch.evaluation import (
        acgan_class_probs, inception_score, inception_v4_class_probs)
    from sketchyscenecolorization_torch.models import inception_v4 as inc
    from sketchyscenecolorization_torch.ops.conv import apply_compute_dtype
    from sketchyscenecolorization_torch.train import fg_gan
    from sketchyscenecolorization_torch.utils.checkpoint import (
        latest_checkpoint, restore_checkpoint)
    t0 = time.perf_counter()
    fg_cfg = FGGanConfig()
    apply_compute_dtype(fg_cfg)         # the script builds the models itself
    model = inc.InceptionV4(num_classes=1001,
                            generator=torch.Generator().manual_seed(0))
    cpu_model = copy.deepcopy(model)
    model = model.cuda()
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.uniform(-1, 1, (INCEPTION_BATCH, 299, 299, 3))
                         .astype(np.float32)).cuda()
    flops = [0.0]

    def count(module, inputs, out):
        w = module.weights
        flops[0] += 2.0 * out.numel() * (w.numel() // w.shape[0]
                                         if w.dim() == 4 else w.shape[0])
    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (inc.ConvBN, inc.Dense))]
    with torch.no_grad():
        inc.inception_v4(model, x)
    for hook in hooks:
        hook.remove()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: inc.inception_v4(model, x), INCEPTION_ITERS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        _, wall, kernels = profile_kernels(lambda: inc.inception_v4(model, x))
    device = sum(kernels.values())
    conv = sum(v for k, v in kernels.items()
               if any(w in k.lower() for w in CONV_KERNEL_WORDS))
    gflop = flops[0] / 1e9
    log(f"path inception: Inception-v4 with AuxLogits and Logits (1001 "
        f"classes, {n_params / 1e6:.2f}M parameters) at 299^2, batch "
        f"{INCEPTION_BATCH}: forward {fwd_ms:.2f} ms (CUDA events, mean of "
        f"{INCEPTION_ITERS}), {gflop:.1f} GFLOP (convolutions and heads) = "
        f"{gflop / fwd_ms:.1f} TFLOP/s, {gflop / fwd_ms / F32_FLOPS * 1e12:.1%}"
        f" of the f32 peak; peak device memory {peak:.2f} GiB "
        f"({resident:.2f} GiB resident before); one profiled forward: "
        f"device kernel time {device:.2f} ms (convolutions {conv:.2f} ms, "
        f"{gflop / conv:.1f} TFLOP/s), wall {wall * 1e3:.1f} ms, device idle "
        f"{1 - device / (wall * 1e3):.1%}")

    with torch.no_grad():
        _, got = inc.inception_v4(model, x[:1])
        _, want = inc.inception_v4(cpu_model, x[:1].cpu())
    errors = {}
    for name, w in want.items():
        rel = float((got[name].cpu() - w).abs().max()) / max(
            float(w.abs().max()), 1e-30)
        if not (torch.isfinite(got[name]).all() and rel <= INCEPTION_REL):
            raise AssertionError(f"Inception CUDA vs CPU at {name}: {rel:.3e}"
                                 f" of max|CPU| > {INCEPTION_REL} (or "
                                 "non-finite)")
        errors[name] = rel
    log(f"  Inception CUDA vs CPU at batch 1, each endpoint's max-abs error "
        f"over its largest magnitude (tol {INCEPTION_REL:.0e}): "
        + ", ".join(f"{k} {v:.1e}" for k, v in errors.items())
        + f"; activations grow to "
        f"{float(want['Mixed_7d'].abs().max()):.3e} on random weights")
    del cpu_model, got, want

    fg_run, fg_data = gan_runs["fg"]
    gen, disc = fg_gan.build_models(fg_cfg)
    step, path = latest_checkpoint(os.path.join(fg_run, "snapshot"))
    saved = restore_checkpoint(path, map_location="cpu")
    gen.load_state_dict(saved["generator"])
    disc.load_state_dict(saved["discriminator"])
    gen, disc = gen.cuda().eval(), disc.cuda()
    rec = read_record_shard(os.path.join(fg_data, "records", "train",
                                         "bus.npz"))
    pairs = [preprocess_pair(rec["cartoons"][i], rec["sketches"][i],
                             fg_cfg.image_size, fg_cfg.distance_map)
             for i in range(len(rec["cartoons"]))]
    idx = [i % len(pairs) for i in range(IS_IMAGES)]
    sketches = torch.from_numpy(np.stack([pairs[i][1] for i in idx])).cuda()
    tokens = torch.from_numpy(rec["text_indices"][idx].astype(np.int64)) \
        .cuda()
    labels = torch.from_numpy(rec["category_ids"][idx].astype(np.int64)) \
        .cuda()
    noise = torch.randn(IS_IMAGES, fg_cfg.noise_dim,
                        generator=torch.Generator().manual_seed(8)).cuda()
    with torch.no_grad():
        fakes = gen(sketches, tokens, labels, noise).cpu().numpy()
    u_before = [b.clone() for b in disc.buffers()]
    t1 = time.perf_counter()
    p_inc = inception_v4_class_probs(model, fakes)
    inc_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    p_ac = acgan_class_probs(disc, fakes)
    ac_s = time.perf_counter() - t1
    scores = {}
    for label, probs, classes in (("Inception-v4", p_inc, 1001),
                                  ("ACGAN head", p_ac, fg_cfg.num_classes)):
        if probs.shape != (IS_IMAGES, classes) or not np.isfinite(
                probs).all() or np.abs(probs.sum(1) - 1).max() > 1e-4:
            raise AssertionError(f"{label} posteriors {probs.shape}, sums "
                                 f"{probs.sum(1)}")
        scores[label] = inception_score(probs, splits=2)
        if not 1.0 - 1e-6 <= scores[label][0] <= classes + 1e-6:
            raise AssertionError(f"{label} inception score {scores[label]}")
    if not all(torch.equal(a, b) for a, b in zip(u_before, disc.buffers())):
        raise AssertionError("acgan_class_probs moved the spectral-norm u")
    log(f"  inception scores of {IS_IMAGES} outputs of the FG run's "
        f"generator (step {step}, {fg_cfg.image_size}^2): Inception-v4 "
        f"(random weights) "
        f"{scores['Inception-v4'][0]:.4f} +- {scores['Inception-v4'][1]:.4f}"
        f" ({inc_s:.3f} s for inception_v4_class_probs, batch "
        f"{INCEPTION_BATCH}), ACGAN head of the run's discriminator "
        f"{scores['ACGAN head'][0]:.4f} +- {scores['ACGAN head'][1]:.4f} "
        f"({ac_s:.3f} s); the discriminator's u unchanged; "
        f"{time.perf_counter() - t0:.1f} s")


def perceptual_gan_training(gan_runs):
    """``train_fg_gan`` at the default ``FGGanConfig`` (192^2, batch 2, base
    64) with ``coeff_perceptual`` 1 and a fresh Inception-v4 stem (through
    Mixed_5b) on the FG run's synthetic shard: 3 steps, then resumed to 4
    (path ``train_fg_gan_perceptual``): step walls, one profiled step with
    its device ms and idle share, Inception's share of the device time
    (the step's device ms less the plain FG step's, over the step's), peak
    memory, B1/B2 launches by shape; the snapshots hold no Inception
    parameter.  Returns the path's launch counts."""
    import torch
    from sketchyscenecolorization_torch.config import FGGanConfig
    from sketchyscenecolorization_torch.data import FGPairedDataset
    from sketchyscenecolorization_torch.models.inception_v4 import \
        InceptionV4
    from sketchyscenecolorization_torch.train import harness
    from sketchyscenecolorization_torch.utils.checkpoint import (
        latest_checkpoint, list_checkpoint_steps, restore_checkpoint)
    t0 = time.perf_counter()
    cfg = FGGanConfig(coeff_perceptual=1.0)
    inception = InceptionV4("Mixed_5b",
                            generator=torch.Generator().manual_seed(5))
    _, fg_data = gan_runs["fg"]
    ds = FGPairedDataset([os.path.join(fg_data, "records", "train",
                                       "bus.npz")], cfg.batch_size,
                         cfg.image_size, cfg.distance_map, seed=0)
    run_dir = tempfile.mkdtemp(prefix="smoke_fg_perceptual_")
    log(f"FG GAN training with the perceptual term (train_fg_gan): "
        f"{cfg.image_size}^2, batch {cfg.batch_size}, base "
        f"{cfg.base_channels}, coeff_perceptual {cfg.coeff_perceptual}, "
        f"Inception-v4 through Mixed_5b (frozen, "
        f"{sum(p.numel() for p in inception.parameters()) / 1e6:.2f}M "
        f"parameters) on both images resized to 299^2")

    def main(max_iters):
        return harness.train_fg_gan(cfg, ds, run_dir, max_iters=max_iters,
                                    device="cuda", perceptual=inception)
    rec = gan_cli_run("fg_perceptual", main, lambda steps, resume: steps,
                      harness, "make_fg_gan_train_step")
    steps, resumed = GAN_RUNS["fg_perceptual"]
    snaps = list_checkpoint_steps(os.path.join(run_dir, "snapshot"))
    saved = restore_checkpoint(latest_checkpoint(os.path.join(
        run_dir, "snapshot"))[1], map_location="cpu")
    if snaps != [steps, steps + resumed] or sorted(saved) != [
            "d_opt", "discriminator", "g_opt", "generator", "step"] or any(
            "Mixed_5b" in k or "Conv2d_1a" in k for k in saved["generator"]):
        raise AssertionError(f"perceptual run snapshots {snaps}, keys "
                             f"{sorted(saved)}")
    total, median_ms = report_gan_run("fg_perceptual", *rec, "loss_g")
    plain = gan_runs["fg_device_ms"]
    log(f"  perceptual step: device {total:.2f} ms against the plain FG "
        f"step's {plain:.2f} ms: Inception's share of the step's device "
        f"time {1 - plain / total:.1%} (forward on the real and generated "
        f"images, backward on the generated); of the median warm wall "
        f"{median_ms:.1f} ms, {(total - plain) / median_ms:.1%}; snapshots "
        f"{snaps} without Inception; {time.perf_counter() - t0:.1f} s")
    return rec[2]


# ------------------------------------------- A10: the non-default models

A10_BACKBONES = {"fcn_8s": "color_fcn8s", "segnet": "color_segnet",
                 "deeplab_v3plus": "color_v3plus"}
A10_FG_VARIANTS = {"Pix2Pix": "train_fg_pix2pix",
                   "Residual": "train_fg_residual"}
GAN_RUNS.update(fg_pix2pix=(4, 2), fg_residual=(4, 2))
A10_WARM_FG = 3     # warm routed FG commands of each backbone's session
A10_LOGIT_ATOL = 1e-4   # CUDA vs CPU up logits at 64^2 (|up| ~ 1)
BF16_WARM = 12      # warm BG commands of each side of the bf16 A/B
BF16_RATIO = 1.5    # CUDA bf16's mean-abs error against the CPU f32
                    # result, over the CPU bf16 result's own
BF16_MAX_RATIO = 2.0    # the same for the max-abs error
A10_FG_ARGS = []    # extra cli_fg_gan arguments of the variant runs
A10_ROUTES = {"the bus is yellow": [0], "the car is red": [1],
              "the grass is green": [3], "the bus is blue": [0]}


def a10_config(cfg, backbone=None, dtype=None, block_type=None, **pipeline):
    """``cfg`` with the matcher's backbone, every model's compute dtype,
    the FG block type and pipeline fields replaced where given."""
    m, f, b = cfg.matching, cfg.fg_gan, cfg.bg_gan
    if backbone:
        m = dataclasses.replace(m, backbone=backbone)
    if dtype:
        m, f, b = (dataclasses.replace(c, compute_dtype=dtype)
                   for c in (m, f, b))
    if block_type:
        f = dataclasses.replace(f, block_type=block_type)
    return dataclasses.replace(cfg, matching=m, fg_gan=f, bg_gan=b,
                               pipeline=dataclasses.replace(cfg.pipeline,
                                                            **pipeline))


def _engine_calls(session, state):
    """(matching up logits, FG rows u8, BG canvas u8) of one call of each
    engine on the small scene, on the host."""
    import torch
    from sketchyscenecolorization_torch.pipeline.engines import PIXEL_MU
    dev = session.device
    image = torch.from_numpy((state.sketch.astype(np.float32) - PIXEL_MU)
                             .astype(np.float32)[None]).to(dev)
    words, lens = session.matching.encode_texts(["the bus", "a red car"])
    up = session.matching.fuse_logits(
        session.matching.extract_visual_dev(image), words, lens)
    s = session.cfg.fg_gan.image_size
    rows = np.stack([state.prepared_instance(i, s) for i in (0, 1)])
    fg = session.fg.colorize_batch(rows, [0, 3], "the bus is red")
    bg, _ = session.bg.colorize(state.sketch, "the sky is blue")
    return (up.cpu().numpy()[..., 0], fg.astype(np.float32),
            bg.astype(np.float32))


def check_a10_against_cpu(build_session):
    """The A10 models on CUDA against the CPU at small configs (64^2) from
    the same seeded weights: each backbone's ``up`` logits (within
    A10_LOGIT_ATOL) and 1e-9-thresholded masks (the flipped pixels
    counted: a logit within the tolerance of the threshold may flip); one
    call of each engine with every model at bfloat16, whose error against
    the CPU's f32 result may be BF16_RATIO x (mean-abs) and
    BF16_MAX_RATIO x (max-abs) the CPU bf16 result's own;
    a bf16 operand refused by B1's wrapper on the card; one train step of
    Pix2Pix, Residual and MRU with ``num_blocks=2`` as
    ``check_gan_training_against_cpu`` takes them."""
    import torch
    from sketchyscenecolorization_torch.config import FGGanConfig
    from sketchyscenecolorization_torch.ops import mlstm
    from sketchyscenecolorization_torch.train import (create_fg_gan_state,
                                                      make_fg_gan_train_step)
    t0 = time.perf_counter()
    texts = ["the bus", "a red car"]
    for backbone in A10_BACKBONES:
        ups = []
        for device in ("cuda", "cpu"):
            tmp = tempfile.mkdtemp(prefix=f"smoke_a10_{backbone}_{device}_")
            write_scene(os.path.join(tmp, "examples"), 64)
            session = build_session(a10_config(small_config(tmp), backbone),
                                    seed=0, device=device)
            reset_counts()
            up = _engine_calls(session, session._state(IMAGE_ID))[0]
            launched = read_counts()["mlstm_fwd"]
            if (launched < 1) if device == "cuda" else launched:
                raise AssertionError(f"{backbone}: {launched} B1 launches on "
                                     f"{device}")
            ups.append(up)
        err = float(np.abs(ups[0] - ups[1]).max())
        flips = (ups[0] >= 1e-9) != (ups[1] >= 1e-9)
        near = np.abs(ups[1]) <= A10_LOGIT_ATOL
        if err > A10_LOGIT_ATOL or (flips & ~near).any():
            raise AssertionError(f"{backbone}: up max-abs {err}, "
                                 f"{int(flips.sum())} mask flips")
        log(f"small-config {backbone} session ({len(texts)} instructions, "
            f"64^2), CUDA vs CPU: up max-abs {err:.2e} (tol "
            f"{A10_LOGIT_ATOL:.0e}, |up| <= {np.abs(ups[1]).max():.3f}), "
            f"{int(flips.sum())} of {flips.size} mask pixels flipped")
    outs = {}
    for device, dtype in (("cuda", "bfloat16"), ("cpu", "bfloat16"),
                          ("cpu", "float32")):
        tmp = tempfile.mkdtemp(prefix=f"smoke_a10_{dtype}_{device}_")
        write_scene(os.path.join(tmp, "examples"), 64)
        session = build_session(a10_config(small_config(tmp), dtype=dtype),
                                seed=0, device=device)
        outs[(device, dtype)] = _engine_calls(session,
                                              session._state(IMAGE_ID))
    for i, name in enumerate(("matching up", "FG u8", "BG u8")):
        gpu, cpu16, cpu32 = (outs[k][i] for k in (
            ("cuda", "bfloat16"), ("cpu", "bfloat16"), ("cpu", "float32")))
        floor = 1.0 if "u8" in name else 1e-6
        own = (max(np.abs(cpu16 - cpu32).mean(), floor / 10),
               max(np.abs(cpu16 - cpu32).max(), floor))
        ours = (np.abs(gpu - cpu32).mean(), np.abs(gpu - cpu32).max())
        if ours[0] > BF16_RATIO * own[0] or \
                ours[1] > BF16_MAX_RATIO * own[1]:
            raise AssertionError(f"bf16 {name}: CUDA vs CPU f32 {ours}, CPU "
                                 f"bf16's own {own}")
        log(f"small-config bf16 engine call, {name}: CUDA bf16 vs CPU f32 "
            f"mean-abs {ours[0]:.4g} max-abs {ours[1]:.4g}; CPU bf16 vs f32 "
            f"{own[0]:.4g} / {own[1]:.4g} (ratio tol {BF16_RATIO} / "
            f"{BF16_MAX_RATIO}); CUDA vs "
            f"CPU bf16 max-abs {np.abs(gpu - cpu16).max():.4g}")
    bad = torch.zeros(1, 4, 16, device="cuda", dtype=torch.bfloat16)
    try:
        mlstm.mlstm_cuda(bad, torch.zeros(1, 2, 16, device="cuda"),
                         torch.zeros(4, 16, device="cuda"),
                         torch.ones(1, 2, dtype=torch.int32, device="cuda"))
    except TypeError:
        pass
    else:
        raise AssertionError("B1's wrapper took a bf16 operand")
    base = FGGanConfig(batch_size=2, image_size=64, vocab_size=10, max_len=4,
                       base_channels=4, noise_dim=8, max_iters=100)
    rng = np.random.RandomState(1)
    for kind, kw in (("FG Pix2Pix", dict(block_type="Pix2Pix")),
                     ("FG Residual", dict(block_type="Residual")),
                     ("FG MRU num_blocks=2", dict(num_blocks=2))):
        cfg = dataclasses.replace(base, **kw)
        batch = (fg_small_batch(rng, cfg), fg_small_batch(rng, cfg))
        gan_steps_against_cpu(kind, cfg, create_fg_gan_state,
                              lambda c, d: make_fg_gan_train_step(c),
                              {"generator": cfg.lr_g,
                               "discriminator": cfg.lr_d}, [batch])
    log(f"check_a10_against_cpu: {time.perf_counter() - t0:.1f} s")


def _bg_device_ms(session):
    """The BG generator's device time on one 768^2 forward under the
    session's compute dtype: (CUDA-event ms over 5 forwards, profiled
    kernel ms of one)."""
    import torch
    from sketchyscenecolorization_torch.ops.conv import compute_dtype_scope
    cfg = session.cfg.bg_gan
    x = torch.rand(1, cfg.image_size, cfg.image_size, 3,
                   generator=torch.Generator().manual_seed(0)).to("cuda") * 2 - 1
    tokens = torch.ones(1, cfg.max_len, dtype=torch.long, device="cuda")

    def forward():
        with torch.no_grad(), compute_dtype_scope(cfg.compute_dtype):
            return session.bg.model(x, tokens)
    ms = cuda_ms(forward, 5)
    _, _, kernels = profile_kernels(forward)
    return ms, sum(kernels.values())


def bf16_run(build_session, card):
    """Path ``color_bf16``: a full-width session with every model at
    bfloat16 (default widths, 768^2) beside an f32 session from the same
    seeded weights, on one synthetic scene.  The bf16 session runs the
    mixed FG/BG sequence with its FG instruction routed (counted: B1's
    launches by shape show the text fusions at f32 in the kernel); then
    BF16_WARM warm BG commands on each session, interleaved, the BG
    generator's device ms on each, the largest u8 difference of the two
    sessions' canvases and the bf16 session's peak memory.  Returns the
    launch counts of the counted run."""
    import torch
    tmp = tempfile.mkdtemp(prefix="smoke_bf16_")
    cfg32 = full_width_config(tmp)
    write_scene(os.path.join(tmp, "examples"), cfg32.pipeline.image_size)
    cfg16 = a10_config(cfg32, dtype="bfloat16",
                       results_base_dir=os.path.join(tmp, "outputs16"))
    sessions = {}
    for name, cfg in (("f32", cfg32), ("bf16", cfg16)):
        sessions[name] = routed(build_session(cfg, seed=0, device="cuda"),
                                A10_ROUTES)
        sessions[name]._state(IMAGE_ID)   # fixture decode: set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                                     # path starts
    t0 = time.perf_counter()
    with b1_shapes() as tally:
        run_mixed(sessions["bf16"])
        torch.cuda.synchronize()
    counts = read_counts()                             # path ends
    mixed_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if counts["mlstm_fwd"] < 4:
        raise AssertionError(f"bf16 mixed sequence: launches {counts}")
    run_mixed(sessions["f32"])
    _, img32 = read_outputs(tmp)
    _, img16 = read_outputs(tmp, "outputs16")
    if sorted(img32) != sorted(img16):
        raise AssertionError(f"canvases {sorted(img32)} vs {sorted(img16)}")
    diffs = {n: np.abs(img16[n].astype(int) - img32[n].astype(int))
             for n in img32}
    walls = {"f32": [], "bf16": []}
    for i in range(BF16_WARM):
        for name in (("f32", "bf16") if i % 2 else ("bf16", "f32")):
            t0 = time.perf_counter()
            sessions[name].colorize(IMAGE_ID, BG_TEXTS[i % len(BG_TEXTS)])
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    gen_ms = {name: _bg_device_ms(s) for name, s in sessions.items()}
    log(f"path color_bf16 (compute_dtype bfloat16 for the matcher, FG and "
        f"BG, 768^2, default widths; {card}): mixed sequence "
        f"{mixed_s:.3f} s, launches {counts}, B1 by (N, P, H) "
        f"{dict(tally)} (the kernel takes f32 only); peak device memory "
        f"{peak:.2f} GiB")
    log("  warm BG commands, interleaved, median wall ms: "
        + ", ".join(f"{n} {np.median(w):.1f} ({min(w):.1f}-{max(w):.1f})"
                    for n, w in walls.items()))
    log("  BG generator forward, device ms (CUDA events / profiled kernels):"
        " " + ", ".join(f"{n} {a:.2f} / {b:.2f}"
                        for n, (a, b) in gen_ms.items()))
    log("  bf16 vs f32 canvases: " + ", ".join(
        f"{n} max {int(d.max())} LSB, {int((d.max(axis=-1) > 0).sum())} "
        f"pixels differ" for n, d in sorted(diffs.items())))
    return counts


def backbone_session_run(build_session, backbone, card):
    """Path ``color_<backbone>``: a full-width session (768^2, default
    widths) with the ``backbone`` matcher on the synthetic scene: one cold
    and A10_WARM_FG warm FG ``color`` commands with the matching forward
    run and the selection routed (``routed(..., match=True)``): B1 once
    for the matcher and once for the generator a command; the backbone's
    device ms on one 768^2 image; the up logits finite; peak memory.
    Returns the launch counts."""
    import torch
    tmp = tempfile.mkdtemp(prefix=f"smoke_{backbone}_")
    cfg = a10_config(full_width_config(tmp), backbone)
    write_scene(os.path.join(tmp, "examples"), cfg.pipeline.image_size)
    t0 = time.perf_counter()
    session = routed(build_session(cfg, seed=0, device="cuda"), A10_ROUTES,
                     match=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    state = session._state(IMAGE_ID)
    torch.cuda.reset_peak_memory_stats()
    texts = list(A10_ROUTES)[:1 + A10_WARM_FG]
    walls = []
    reset_counts()                                     # path starts
    for text in texts:
        t0 = time.perf_counter()
        session.colorize(IMAGE_ID, text)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()                             # path ends
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if counts["mlstm_fwd"] != 2 * len(texts):
        raise AssertionError(f"{backbone}: launches {counts}, expected "
                             f"{2 * len(texts)} B1")
    model = session.matching.model
    image = torch.randn(1, cfg.matching.H, cfg.matching.W, 3,
                        device="cuda") * 50

    def backbone_fwd():
        with torch.no_grad():
            return model.backbone(image)
    bb_ms = cuda_ms(backbone_fwd, 3)
    words, lens = session.matching.encode_texts(texts[:1])
    up = session.matching.fuse_logits(state.visual_dev, words, lens)
    if not torch.isfinite(up).all():
        raise AssertionError(f"{backbone}: up logits not finite")
    n_params = sum(p.numel() for p in model.backbone.parameters())
    log(f"path {A10_BACKBONES[backbone]} ({backbone}, {n_params / 1e6:.1f}M "
        f"backbone parameters, 768^2; {card}): build_session {build_s:.2f} "
        f"s; routed FG commands with the matching forward: cold "
        f"{walls[0]:.1f} ms, warm " + ", ".join(f"{w:.1f}" for w in walls[1:])
        + f" ms; backbone forward {bb_ms:.2f} ms (CUDA events); launches "
        f"{counts}; peak device memory {peak:.2f} GiB")
    return counts


def variant_gan_training():
    """Paths ``train_fg_pix2pix`` and ``train_fg_residual``: ``cli_fg_gan
    --mode train --block_type ...`` at the default ``FGGanConfig`` (192^2,
    batch 2, base 64) on the synthetic record shard, 4 steps resumed to 6,
    as ``full_width_gan_training`` runs the MRU pair.  Returns ({path:
    launch counts}, {block type: run dir})."""
    from sketchyscenecolorization_torch import cli_fg_gan
    from sketchyscenecolorization_torch.config import FGGanConfig
    from sketchyscenecolorization_torch.train import harness
    from sketchyscenecolorization_torch.utils.checkpoint import (
        list_checkpoint_steps)
    paths, runs = {}, {}
    for block_type, path in A10_FG_VARIANTS.items():
        t0 = time.perf_counter()
        kind = f"fg_{block_type.lower()}"
        tmp = tempfile.mkdtemp(prefix=f"smoke_{kind}_")
        write_fg_gan_data(tmp)
        run = os.path.join(tmp, "run")
        steps, resumed = GAN_RUNS[kind]

        def argv(n, resume, run=run, tmp=tmp, block_type=block_type):
            return ["--mode", "train", "--data_base_dir", tmp,
                    "--resume_from", run, "--max_iter_step", str(n),
                    "--block_type", block_type, "--device", "cuda",
                    *A10_FG_ARGS]
        log(f"path {path}: cli_fg_gan --block_type {block_type} at the "
            f"default FGGanConfig")
        result = gan_cli_run(kind, cli_fg_gan.main, argv, harness,
                             "make_fg_gan_train_step")
        snaps = list_checkpoint_steps(os.path.join(run, "snapshot"))
        if snaps != [steps, steps + resumed]:
            raise AssertionError(f"{kind} snapshots {snaps}")
        cfg = FGGanConfig(**json.load(open(os.path.join(run,
                                                        "params.json"))))
        _moved_generator("fg", cfg, os.path.join(run, "snapshot"))
        report_gan_run(kind, *result, "loss_g")
        log(f"  {kind} phase {time.perf_counter() - t0:.1f} s")
        paths[path] = result[2]
        runs[block_type] = run
        release()
    return paths, runs


def serve_fg_variants(build_session, runs):
    """Path ``serve_fg_variants``: for each variant run, a full-width
    session whose FG generator is the run's (``fg_ckpt_dir``, and the
    run's ``FGGanConfig`` from its ``params.json``), checked equal to the
    snapshot's, serves one routed FG command: B1 once each."""
    import torch
    from PIL import Image
    from sketchyscenecolorization_torch.config import FGGanConfig
    from sketchyscenecolorization_torch.utils.checkpoint import (
        latest_checkpoint, restore_checkpoint)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="smoke_serve_variants_")
    base = full_width_config(tmp)
    write_scene(os.path.join(tmp, "examples"), base.pipeline.image_size)
    sessions = {}
    for block_type, run in runs.items():
        cfg = a10_config(base, fg_ckpt_dir=os.path.join(run, "snapshot"),
                         results_base_dir=os.path.join(tmp, block_type))
        cfg = dataclasses.replace(cfg, fg_gan=FGGanConfig(**json.load(
            open(os.path.join(run, "params.json")))))
        assert cfg.fg_gan.block_type == block_type
        session = routed(build_session(cfg, seed=0, device="cuda"),
                         {"the bus is yellow": [0]})
        saved = restore_checkpoint(latest_checkpoint(cfg.pipeline.fg_ckpt_dir)
                                   [1], map_location="cpu")["generator"]
        served = session.fg.model.state_dict()
        if any(not torch.equal(served[k].cpu(), v) for k, v in saved.items()):
            raise AssertionError(f"{block_type}: served generator differs")
        session._state(IMAGE_ID)
        sessions[block_type] = session
    reset_counts()                                     # path starts
    outs = [s.colorize(IMAGE_ID, "the bus is yellow")
            for s in sessions.values()]
    torch.cuda.synchronize()
    counts = read_counts()                             # path ends
    if counts["mlstm_fwd"] != len(runs):
        raise AssertionError(f"serve_fg_variants: launches {counts}")
    for out in outs:
        img = np.array(Image.open(out))
        if img.shape != (base.pipeline.image_size,) * 2 + (3,):
            raise AssertionError(f"{out}: shape {img.shape}")
    log(f"path serve_fg_variants: sessions on the {sorted(runs)} runs' "
        f"generators (equal to their snapshots), one routed FG command "
        f"each; launches {counts}; {time.perf_counter() - t0:.1f} s")
    return counts


def release():
    """Free what the last phase dropped (the engines' noise sources are
    reference cycles, so a dropped session waits for the collector), so
    that each phase's peak device memory is its own."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


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

    log(f"before the first build_session (torch's defaults): "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
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
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    log(f"after the first build_session: cudnn.allow_tf32={flags[0]} "
        f"cuda.matmul.allow_tf32={flags[1]}")
    if any(flags):
        raise AssertionError("build_session left TF32 on")
    check_bg_against_cpu(build_session)
    check_serving_ops()
    check_serving_against_cpu(build_session)
    check_training_against_cpu()
    card = smi.splitlines()[0]
    paths = {"color": full_size_run(build_session, mlstm)}
    release()
    paths["color_bg"] = full_width_bg(build_session, card)
    release()
    tf32_line()
    release()
    stream_paths, session, eligible = full_width_stream(build_session, card)
    paths.update(stream_paths)
    serving_ab(session, eligible, card)
    del session
    release()
    paths["train_matching"], corpus, trained = full_width_training(mlstm)
    serve_trained(build_session, corpus, trained)
    del trained
    release()
    paths["infer_matching"] = infer_matching(corpus)
    release()
    t0 = time.perf_counter()
    paths["eval_matching"] = eval_matching_run(corpus)
    log(f"eval_matching_run: {time.perf_counter() - t0:.1f} s")
    release()
    check_eval_against_cpu()
    for variant in VARIANTS:
        release()
        check_against_cpu(build_session, variant)
        check_training_against_cpu(variant)
        paths[f"color_{variant}"] = variant_session_run(build_session, variant)
        release()
        paths[f"train_{variant}"] = variant_training(variant)
    release()
    t0 = time.perf_counter()
    check_gan_training_against_cpu()
    log(f"check_gan_training_against_cpu: {time.perf_counter() - t0:.1f} s")
    release()
    t0 = time.perf_counter()
    gan_paths, gan_runs = full_width_gan_training()
    paths.update(gan_paths)
    log(f"full_width_gan_training: {time.perf_counter() - t0:.1f} s")
    release()
    t0 = time.perf_counter()
    paths["serve_gans"] = serve_trained_gans(build_session, gan_runs)
    log(f"serve_trained_gans: {time.perf_counter() - t0:.1f} s")
    release()
    inception_run(gan_runs)
    release()
    paths["train_fg_gan_perceptual"] = perceptual_gan_training(gan_runs)
    release()
    check_a10_against_cpu(build_session)
    release()
    t0 = time.perf_counter()
    paths["color_bf16"] = bf16_run(build_session, card)
    log(f"bf16_run: {time.perf_counter() - t0:.1f} s")
    for backbone, path in A10_BACKBONES.items():
        release()
        t0 = time.perf_counter()
        paths[path] = backbone_session_run(build_session, backbone, card)
        log(f"backbone_session_run {backbone}: "
            f"{time.perf_counter() - t0:.1f} s")
    release()
    variant_paths, variant_runs = variant_gan_training()
    paths.update(variant_paths)
    paths["serve_fg_variants"] = serve_fg_variants(build_session,
                                                   variant_runs)

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
