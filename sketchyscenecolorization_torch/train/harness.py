"""Training and evaluation harnesses
(``sketchyscenecolorization_tpu/train/harness.py``): matching (reference
``matching_main.py:81-241``) and its evaluation (``:244-417``), the FG GAN
(``obj_colorization_main.py`` + ``obj_lib/main_procedure.py:62-242``) and
the BG GAN (``bg_colorization_main.py:894-975``).

Background batch workers -> host-to-device copies in flight -> train step
-> loss / throughput printing and a JSONL metric log -> snapshots with
latest-step resume (``<run_dir>/snapshots`` for matching,
``<run_dir>/snapshot`` for the GANs, as in JAX).  The FG harness returns
-1 on a NaN loss so that ``run_with_nan_restart`` relaunches it from its
newest snapshot.  The JAX harness's optional profiler window is left out;
``chip_smoke.py`` profiles a step with ``torch.profiler`` instead.

The three trainers take a ``mesh`` (``parallel.create_mesh``), as JAX's
do: every rank resumes from the newest snapshot and then takes the mesh's
first rank's state (JAX's ``replicate``); the mesh's first rank makes the
global batches and broadcasts them (``parallel.mesh_batches``), each rank
copies its rows to its device (``cuda:<local rank>``, or ``cuda:0`` for
every rank of a one-card host) and runs the data-parallel step; only the
first rank prints, logs and writes snapshots, and every rank waits at a
barrier after each write.
"""
from __future__ import annotations

import json
import os
import random
from typing import Callable, Optional

import numpy as np
import torch

from ..config import BGGanConfig, FGGanConfig, MatchingConfig
from ..data.bg_dataset import BGDataset
from ..data.fg_records import FGPairedDataset
from ..data.matching_dataset import MatchingTrainDataset, load_data_gt
from ..evaluation import MatchingEvaluator, SegEvalResult
from ..models.rmi import RMI
from ..ops.conv import apply_compute_dtype
from ..parallel import (BackgroundGenerator, is_first_rank, mesh_batches,
                        prefetch_to_device, rank_device, replicate)
from ..utils.checkpoint import (latest_checkpoint, restore_checkpoint,
                                save_checkpoint)
from ..text import augment_caption_with_attr
from ..utils.logging import (JsonlMetricWriter, LossEMA, ThroughputMeter,
                             count_params)
from .bg_gan import (BGGanTrainState, LOSS_KEYS, create_bg_gan_state,
                     make_bg_gan_train_step)
from .fg_gan import create_fg_gan_state, make_fg_gan_train_step
from .matching import (MatchingTrainState, create_matching_state,
                       make_matching_train_step)
from .watchdog import NaNWatchdog


def _rank_setup(device, mesh):
    """(this rank's device, whether it is the mesh's first rank)."""
    device = rank_device(device, mesh)
    if mesh is not None and device.type == "cuda":
        torch.cuda.set_device(device)     # the device NCCL's objects use
    return device, is_first_rank(mesh)


def _replicate_state(state, mesh) -> None:
    """Every tensor of a train state (models, moments, EMAs) from the
    mesh's first rank (JAX ``_resume``'s ``replicate``)."""
    def leaves(tree):
        for value in tree.values():
            if isinstance(value, torch.Tensor):
                yield value
            elif isinstance(value, dict):
                yield from leaves(value)
    if mesh is not None:
        replicate(dict(enumerate(leaves(state.state_dict()))), mesh)


def _snapshot(ckpt_dir, step, state, max_to_keep, first, mesh) -> None:
    """The first rank writes; every rank waits for the write."""
    if first:
        save_checkpoint(ckpt_dir, step, state.state_dict(),
                        max_to_keep=max_to_keep)
    if mesh is not None:
        torch.distributed.barrier()


def train_matching(cfg: MatchingConfig, dataset: MatchingTrainDataset,
                   model: RMI, run_dir: str, log_every: int = 50,
                   max_iters: Optional[int] = None,
                   device="cuda", mesh=None) -> MatchingTrainState:
    """Batch-1 steps up to ``max_iters`` (default ``cfg.max_iters``),
    resuming from the newest snapshot under ``<run_dir>/snapshots``; loss
    EMA(0.99) printed every ``log_every`` steps; snapshots every
    ``cfg.snapshot_interval`` steps and at the end (10 kept).  With a
    ``mesh``, data-parallel (the module docstring)."""
    apply_compute_dtype(cfg)
    device, first = _rank_setup(device, mesh)
    max_iters = max_iters or cfg.max_iters
    ckpt_dir = os.path.join(run_dir, "snapshots")
    state = create_matching_state(model.to(device), cfg)
    found = latest_checkpoint(ckpt_dir)
    if found is not None:
        state.load_state_dict(restore_checkpoint(found[1], map_location=device))
    _replicate_state(state, mesh)
    start = state.step
    if first:
        count_params(state.mu, "text_sketchyscene")

    step_fn = make_matching_train_step(cfg, mesh)
    writer = JsonlMetricWriter(os.path.join(run_dir, "metrics.jsonl")) \
        if first else None
    ema = LossEMA(0.99)
    meter = ThroughputMeter(max_iters)
    gen = mesh_batches(dataset.make_batch, max_iters - start, mesh)
    n_iter = start
    try:
        for batch in prefetch_to_device(gen, device, depth=2, mesh=mesh):
            meter.start()
            state, metrics = step_fn(state, batch)
            cls = float(metrics["cls_loss"])
            stats = meter.stop(n_iter)
            ema.update(cls)
            n_iter += 1
            if first and (n_iter % log_every == 0 or n_iter == max_iters):
                print(f"iter {n_iter}: cls_loss(ema)={ema.value:.4f} "
                      f"lr={metrics['lr']:.6f} "
                      f"{stats['sec_per_step']:.3f}s/step "
                      f"eta={stats['eta_hours']:.2f}h")
                writer.write(n_iter, {"cls_loss": cls,
                                      "cls_loss_ema": ema.value,
                                      "lr": metrics["lr"], **stats})
                meter.window_reset()
            if n_iter % cfg.snapshot_interval == 0 or n_iter == max_iters:
                _snapshot(ckpt_dir, n_iter, state, 10, first, mesh)
    finally:
        gen.close()
        if writer is not None:
            writer.close()
    return state


def eval_matching(predict_fn: Optional[Callable[[np.ndarray, str],
                                                np.ndarray]],
                  dataset_base_dir: str, caption_json_path: str,
                  seg_data_base_dir: Optional[str] = None,
                  compute_mask_ap: bool = True,
                  result_path: Optional[str] = None,
                  augment: bool = True,
                  max_samples: Optional[int] = None,
                  predict_batch_fn: Optional[
                      Callable[[np.ndarray, list], np.ndarray]] = None
                  ) -> SegEvalResult:
    """``matching_main.test`` (:244-417; JAX ``train/harness.py:118``):
    cumulative IoU, precision@X and the instance mAP@[0.5:0.95] over a
    split, printed and, with ``result_path``, appended to that file.

    ``predict_fn(image_uint8, caption) -> binary [H, W] mask`` (a
    ``MatchingEngine.predict_mask`` bound method), or
    ``predict_batch_fn(image, captions) -> [M, H, W]``
    (``MatchingEngine.predict_masks``, equal to M single calls), with which
    the backbone runs once per image.  The GT loads on one background
    worker, so the images, and with them the draws of the caption
    augmentation (``random.Random(0)``), come in the JAX order."""
    with open(caption_json_path) as f:
        json_data = json.load(f)
    evaluator = MatchingEvaluator(compute_mask_ap=compute_mask_ap)
    rng = random.Random(0)

    def load(i):
        entry = json_data[i]
        return entry, load_data_gt(dataset_base_dir, entry["key"])

    gen = BackgroundGenerator(load, num_steps=len(json_data), num_workers=1)
    done = 0
    try:
        for entry, (sketch, _, _, gt_masks) in gen:
            img_idx = entry["key"]
            sketch_u8 = sketch.astype(np.uint8)
            seg_npz = (os.path.join(seg_data_base_dir, "seg_data",
                                    f"{img_idx}_datas.npz")
                       if seg_data_base_dir else None)
            items = list(entry["sen_instIdx_map"].items())
            if max_samples:
                items = items[:max(0, max_samples - done)]
            captions = [augment_caption_with_attr(c, rng) if augment else c
                        for c, _ in items]
            all_predicts = (predict_batch_fn(sketch_u8, captions)
                            if predict_batch_fn is not None and captions
                            else None)
            for k, (_, inst_indices) in enumerate(items):
                target = np.zeros(gt_masks.shape[:2], np.int32)
                cap_gt = np.zeros((*gt_masks.shape[:2], len(inst_indices)),
                                  np.int32)
                for t_i, inst_idx in enumerate(inst_indices):
                    target = np.logical_or(target, gt_masks[:, :, inst_idx])
                    cap_gt[:, :, t_i] = gt_masks[:, :, inst_idx]
                predicts = (all_predicts[k] if all_predicts is not None
                            else predict_fn(sketch_u8, captions[k]))
                evaluator.add(predicts, target,
                              cap_gt if compute_mask_ap and seg_npz else None,
                              seg_npz)
                done += 1
            if max_samples and done >= max_samples:
                break
    finally:
        gen.close()

    result = evaluator.result()
    print(result.summary())
    if result_path:
        os.makedirs(os.path.dirname(result_path) or ".", exist_ok=True)
        with open(result_path, "a") as f:
            f.write(result.summary() + "\n")
    return result


def _resume(state, ckpt_dir: str, device, first: bool, mesh) -> int:
    found = latest_checkpoint(ckpt_dir)
    if found is not None:
        state.load_state_dict(restore_checkpoint(found[1],
                                                 map_location=device))
    _replicate_state(state, mesh)
    if state.step == 0 and first:
        count_params(dict(state.generator.named_parameters()), "generator")
        count_params(dict(state.discriminator.named_parameters()),
                     "discriminator")
    return state.step


def train_fg_gan(cfg: FGGanConfig, dataset: FGPairedDataset, run_dir: str,
                 seed: int = 0, log_every: int = 100,
                 max_iters: Optional[int] = None, device="cuda",
                 perceptual=None, mesh=None) -> int:
    """One FG GAN training launch (``main_procedure.train`` :62-242) up to
    ``max_iters`` (default ``cfg.max_iters``), resuming from the newest
    snapshot under ``<run_dir>/snapshot``; the D and G batches come from
    two independent streams, like the reference's two queues; snapshots
    every ``cfg.snapshot_interval`` steps and at the end (100 kept).
    ``perceptual`` is the frozen Inception-v4 of the perceptual term
    (``make_fg_gan_train_step``), moved to ``device``; snapshots do not
    hold it.  Returns 0 on completion, -1 on a NaN abort.  With a
    ``mesh``, data-parallel over the global batch ``cfg.batch_size`` (the
    module docstring)."""
    apply_compute_dtype(cfg)
    device, first = _rank_setup(device, mesh)
    max_iters = max_iters or cfg.max_iters
    ckpt_dir = os.path.join(run_dir, "snapshot")
    state = create_fg_gan_state(cfg, seed, device)
    start = _resume(state, ckpt_dir, device, first, mesh)
    step_fn = make_fg_gan_train_step(
        cfg, seed=seed + 1,
        perceptual=None if perceptual is None else perceptual.to(device),
        mesh=mesh)
    writer = JsonlMetricWriter(os.path.join(run_dir, "metrics.jsonl")) \
        if first else None
    meter = ThroughputMeter(max_iters)
    watchdog = NaNWatchdog()
    gen_d = mesh_batches(dataset.make_batch, max_iters - start, mesh)
    gen_g = mesh_batches(dataset.make_batch, max_iters - start, mesh)
    i = start
    try:
        for batch_d, batch_g in zip(
                prefetch_to_device(gen_d, device, mesh=mesh),
                prefetch_to_device(gen_g, device, mesh=mesh)):
            meter.start()
            state, metrics = step_fn(state, batch_d, batch_g)
            tripped = watchdog.check(metrics, i + 1)   # waits for the step
            stats = meter.stop(i)
            i += 1
            if tripped:
                print(f"NaN at iter {i}; aborting with status -1")
                return -1
            if first and (i % log_every == 0 or i == max_iters):
                print(f"iter {i}: loss_d={float(metrics['loss_d']):.4f} "
                      f"loss_g={float(metrics['loss_g']):.4f} "
                      f"{stats['sec_per_step']:.3f}s/step")
                writer.write(i, {k: metrics[k] for k in
                                 ("loss_d", "loss_g", "recon_l1")} | stats)
            if i % cfg.snapshot_interval == 0 or i == max_iters:
                _snapshot(ckpt_dir, i, state, 100, first, mesh)
    finally:
        gen_d.close()
        gen_g.close()
        if writer is not None:
            writer.close()
    return 0


def train_bg_gan(cfg: BGGanConfig, dataset: BGDataset, run_dir: str,
                 seed: int = 0, progress_every: int = 50,
                 max_steps: Optional[int] = None,
                 device="cuda", mesh=None) -> BGGanTrainState:
    """The ``bg_colorization`` training loop (:894-975) up to ``max_steps``
    (default ``cfg.max_steps``), resuming from the newest snapshot under
    ``<run_dir>/snapshot``; the loss EMAs printed every ``progress_every``
    steps; snapshots every ``cfg.snapshot_interval`` steps and at the end
    (10 kept).  With a ``mesh``, data-parallel over the global batch
    ``cfg.batch_size`` (the module docstring)."""
    apply_compute_dtype(cfg)
    device, first = _rank_setup(device, mesh)
    max_steps = max_steps or cfg.max_steps
    ckpt_dir = os.path.join(run_dir, "snapshot")
    state = create_bg_gan_state(cfg, seed, device)
    start = _resume(state, ckpt_dir, device, first, mesh)
    step_fn = make_bg_gan_train_step(cfg, mesh)
    writer = JsonlMetricWriter(os.path.join(run_dir, "metrics.jsonl")) \
        if first else None
    meter = ThroughputMeter(max_steps)
    gen = mesh_batches(dataset.make_batch, max_steps - start, mesh)
    step = start
    try:
        for batch in prefetch_to_device(gen, device, depth=2, mesh=mesh):
            meter.start()
            state, metrics = step_fn(state, batch)
            ema = dict(zip(LOSS_KEYS, torch.stack(     # waits for the step
                [metrics["ema/" + k] for k in LOSS_KEYS]).tolist()))
            stats = meter.stop(step)
            step += 1
            if first and (step % progress_every == 0 or step == max_steps):
                print(f"step {step}: " + " ".join(
                    f"{k}={v:.4f}" for k, v in ema.items())
                    + f" image/sec={stats['steps_per_sec']:.1f}")
                writer.write(step, {f"ema/{k}": v for k, v in ema.items()}
                             | stats)
            if step % cfg.snapshot_interval == 0 or step == max_steps:
                _snapshot(ckpt_dir, step, state, 10, first, mesh)
    finally:
        gen.close()
        if writer is not None:
            writer.close()
    return state
