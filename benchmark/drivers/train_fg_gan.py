"""Driver of the FG GAN training cell: the program's ``create_fg_gan_state``
and ``make_fg_gan_train_step`` on its MRU generator and spectral-norm
ACGAN discriminator, fed one D batch and one G batch a step through its
``prefetch_to_device``, each step waited on through its ``NaNWatchdog``,
as ``train/harness.py:train_fg_gan`` runs them.

Set-up loads the reference's seeded weights and spectral-norm vectors
into the program, drives it through its first steps (the output check
replays the first three, each from the state the program held before
it, kept on the host), and hands the same state to the window, which
steps until ``--seconds`` have passed and ends on a synchronize.  With
``--trace 1`` the step runs with the program's tracer (its spans go to
``stages``), CUDA events time the generator's and the discriminator's
forwards, and the profiler records the device.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import itertools
import statistics
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
from PIL import Image

from .. import fg_gan_train_check as check
from .. import scenes as scn
from .. import trace as tr
from .. import train_check
from ..device import host_counters, host_delta, on_cuda, release, sync
from ..harness import load_json
from ..record import Run
from ..reference import fg_gan_step
from ..reference.fg_gan_step import record, snapshot
from ..reference.compositing import SKE_ID_TO_CAT_ID
from ..reference.init import load_into
from ..reference.text import colorization_encode, fg_color_text
from ..serve_check import vocab

CHECKED_STEPS = 3
WARM_STEPS = 3            # further set-up steps (the window's shapes)
SCENE = 768
RAW = 384                 # the FG records' crop size
MARGIN = 10
CAT46 = {v: k for k, v in SKE_ID_TO_CAT_ID.items()}
# RGB of the caption colours (assumed: the cell's colour images are flat)
COLORS = {
    "light gray": (200, 200, 200), "orange": (250, 140, 20),
    "red": (220, 30, 30), "purple": (130, 50, 160), "brown": (140, 90, 45),
    "dark green": (20, 100, 30), "black": (20, 20, 20),
    "cyan": (20, 200, 220), "pink": (250, 160, 190), "blue": (30, 60, 220),
    "yellow": (250, 220, 30), "white": (250, 250, 250),
    "green": (40, 170, 60), "dark gray": (90, 90, 90),
    "light green": (150, 230, 130), "light blue": (150, 200, 250),
    "dark blue": (20, 30, 120)}


def _square(img: np.ndarray, size: int) -> np.ndarray:
    """Resize to fit ``size`` with a white margin, then pad white to a
    square (the serving crop's rule, in colour)."""
    h, w = img.shape[:2]
    scale = size / max(h + 2 * MARGIN, w + 2 * MARGIN)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = np.array(Image.fromarray(img).resize((nw, nh), Image.LANCZOS))
    top, left = (size - nh) // 2, (size - nw) // 2
    return np.pad(out, [(top, size - nh - top), (left, size - nw - left),
                        (0, 0)], constant_values=255)


def _crops(scene, k: int, inst) -> Tuple[np.ndarray, np.ndarray]:
    """(colour image, sketch) of instance ``k`` as u8 [RAW, RAW, 3]."""
    y1, x1, y2, x2 = (int(v) for v in scene.boxes[k])
    win = (slice(y1, y2 + 1), slice(x1, x2 + 1))
    stroke = scene.masks[k][win] == 1
    fill = scene.inner[win] == k + 1
    sketch = np.full(stroke.shape + (3,), 255, np.uint8)
    sketch[stroke] = 0
    cartoon = sketch.copy()
    cartoon[fill & ~stroke] = COLORS[inst.fill]
    cartoon[stroke] = COLORS[inst.edge] if inst.edge else 0
    return _square(cartoon, RAW), _square(sketch, RAW)


def make_batches(plan, f: dict, seed: int) -> List[Tuple[dict, dict]]:
    """(D batch, G batch) host arrays of every pair of the plan, as the FG
    loader makes them: the image and sketch of each captioned instance
    (``preprocess_pair``: BILINEAR / AREA to the training size, the
    image min-max normalised with 1/256 dequantisation noise), the real
    image of another instance for D, class ids, front-padded tokens."""
    from sketchyscenecolorization_torch.data.fg_records import (
        preprocess_image, preprocess_pair)
    fv = vocab("fg_vocab.txt")
    size = f["image_size"]
    out = []
    for j, pair in enumerate(plan):
        two = []
        for side, batch in enumerate((pair.d, pair.g)):
            rng = np.random.default_rng([seed, 4000 + j, side])
            insts = batch.pairs + batch.reals
            scene = scn.draw_scene(rng, SCENE,
                                   [CAT46[i.class_id] for i in insts],
                                   [i.side for i in insts])
            raw = [_crops(scene, k, inst) for k, inst in enumerate(insts)]
            noise = rng.integers(0, 1 << 31, size=len(insts))
            n = len(batch.pairs)
            pairs = [preprocess_pair(c, s, size, False,
                                     np.random.RandomState(noise[k]))
                     for k, (c, s) in enumerate(raw[:n])]
            reals = [preprocess_image(c, size,
                                      np.random.RandomState(noise[n + k]))
                     for k, (c, _) in enumerate(raw[n:])]
            two.append({
                "images": np.stack([p[0] for p in pairs]).astype(np.float32),
                "sketches": np.stack([p[1] for p in pairs]).astype(
                    np.float32),
                "images_d": np.stack(reals).astype(np.float32),
                "class_id": np.asarray([i.class_id for i in batch.pairs],
                                       np.int32),
                "class_id_d": np.asarray([i.class_id for i in batch.reals],
                                         np.int32),
                "tokens": np.asarray([colorization_encode(
                    fg_color_text(i.caption), fv, f["max_len"])
                    for i in batch.pairs], np.int32)})
        out.append(tuple(two))
    return out


def parts(state) -> Tuple[dict, dict, dict]:
    """(leaves {"g", "d"}, stored spectral-norm vectors, Adam {"g", "d"})
    of the program's train state, read afresh: a commit rebinds the
    vectors."""
    return ({"g": dict(state.generator.named_parameters()),
             "d": dict(state.discriminator.named_parameters())},
            dict(state.discriminator.named_buffers()),
            {"g": state.g_opt, "d": state.d_opt})


def record_step(prog: dict, state, metrics) -> None:
    """``fg_gan_step.record`` of the program's step; its gradients are
    Adam's first moments (b1 = 0)."""
    params, u, opts = parts(state)
    record(prog, (metrics["loss_d"], metrics["loss_g"]),
           {m: o.mu for m, o in opts.items()}, params, u)


@contextlib.contextmanager
def steady_host():
    """The host's side of the window, the same in every run: one
    intra-op CPU thread (the step's host work is its launches, which no
    pool speeds up; on an 8-core H100 host the pool's idle workers took
    0.17 of a core through the window, and the steps' quartile spread
    within a run read 25-29% of their median with them, 10-13% without)
    and the set-up's objects frozen out of the collector's sweeps."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    gc.collect()
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()
        torch.set_num_threads(threads)


def run(cell, config, traffic, seed, seconds, trace, started, device) -> Run:
    from sketchyscenecolorization_torch.config import FGGanConfig
    from sketchyscenecolorization_torch.ops.conv import apply_compute_dtype
    from sketchyscenecolorization_torch.parallel import prefetch_to_device
    from sketchyscenecolorization_torch.train.fg_gan import (
        create_fg_gan_state, make_fg_gan_train_step)
    from sketchyscenecolorization_torch.train.watchdog import NaNWatchdog
    from sketchyscenecolorization_torch.utils.tracing import Tracer
    f = config["framework"]["fg_gan"]
    cfg = FGGanConfig(**f)
    tracer = Tracer() if trace else None
    step_fn = make_fg_gan_train_step(cfg, seed=seed, trace=tracer)
    gen = importlib.import_module(f"benchmark.traffic.{traffic['kind']}")
    plan = gen.make_plan(traffic, seed)
    limits = load_json("limits", f"{cell['name']}.json")
    rec = Run(device={"platform": "gpu", "count": 1,
                      "kind": torch.cuda.get_device_name(0)}
              if on_cuda(device) else {"platform": "cpu", "count": 1,
                                       "kind": "cpu"})
    batches = make_batches(plan, f, seed)

    apply_compute_dtype(cfg)
    state = create_fg_gan_state(cfg, seed, device)
    gen, disc = fg_gan_step.models(f, seed, device)
    load_into(state.generator, gen.state_dict())
    load_into(state.discriminator, disc.state_dict())
    del gen, disc
    release(device)
    if on_cuda(device):
        torch.cuda.reset_peak_memory_stats()
    feed_d = prefetch_to_device(itertools.cycle([b[0] for b in batches]),
                                device, depth=2)
    feed_g = prefetch_to_device(itertools.cycle([b[1] for b in batches]),
                                device, depth=2)
    watchdog = NaNWatchdog()

    def one_step(i):
        _, metrics = step_fn(state, next(feed_d), next(feed_g))
        if watchdog.check(metrics, i):          # waits for the step
            raise RuntimeError(f"NaN loss at step {i}")
        return metrics

    prog = {k: [] for k in ("losses", "grads", "change", "sn", "starts")}
    for s in range(CHECKED_STEPS + WARM_STEPS):
        if s < CHECKED_STEPS:
            prog["starts"].append(snapshot(*parts(state)))
        metrics = one_step(s + 1)
        if s < CHECKED_STEPS:
            record_step(prog, state, metrics)
    sync(device)

    if tracer is not None:
        tracer.clear()
    timers = tr.ModuleTimers({"generator": state.generator,
                              "discriminator": state.discriminator}) \
        if trace else None
    device_trace = tr.DeviceTrace() if trace else None
    if device_trace:
        device_trace.__enter__()
    with steady_host():
        host0, main0 = host_counters(), time.thread_time()
        t_start = time.perf_counter()
        rec.setup_s = time.time() - started
        deadline = t_start + seconds
        steps = 0
        while time.perf_counter() < deadline:
            t0 = time.perf_counter()
            one_step(CHECKED_STEPS + WARM_STEPS + steps + 1)
            t1 = time.perf_counter()
            steps += 1
            rec.walls_s.append(t1 - t0)
            rec.spans.append(("train_step", t0, t1))
        sync(device)
        t_end = time.perf_counter()
        main_cpu_s = time.thread_time() - main0
    rec.notes.update(host_delta(host0, host_counters()))
    rec.steps = rec.attempted = steps
    rec.window = (t_start, t_end)
    rec.window_s = t_end - t_start
    rec.notes["main_cpu_share"] = main_cpu_s / rec.window_s
    if steps >= 2:
        q = statistics.quantiles(rec.walls_s, n=4)
        rec.notes["step_iqr_share"] = (q[2] - q[0]) / statistics.median(
            rec.walls_s)
    if device_trace:
        device_trace.__exit__(None, None, None)
        rec.kernels = device_trace.kernels
        rec.module_ms = timers.close()
        rec.stages = list(tracer.events)
        rec.traced_window_s = rec.window_s
        rec.busy_s, rec.breakdown = tr.breakdown(
            rec.kernels, rec.spans, rec.stages, t_start, t_end)
        rec.work = check.train_work(f, batches, CHECKED_STEPS + WARM_STEPS,
                                    steps)
        for label, name in (("b1_kernels_a_step", "mlstm_stage_kernel<1>"),
                            ("b2_sweeps_a_step", "mlstm_bwd_")):
            rec.notes[label] = sum(name in k[0] for k in rec.kernels) \
                / max(steps, 1)
    rec.peak_bytes = torch.cuda.max_memory_allocated() \
        if on_cuda(device) else 0
    rec.device["memory_peak_bytes"] = rec.peak_bytes
    del state, feed_d, feed_g, step_fn
    gc.collect()
    release(device)

    want = fg_gan_step.reference_steps(f, batches[:CHECKED_STEPS], seed,
                                       device, starts=prog["starts"])
    rec.checks = check.checks(prog, want, f, limits)
    rec.correct = train_check.passed(rec.checks)
    return rec


def control(cell, config, traffic, seed, device="cuda", precision="tf32"
            ) -> Dict[str, float]:
    """The control (``benchmark/control.py``): the reference's first
    steps at ``precision`` in the program's place, each checked against
    the reference's step from the same state."""
    f = config["framework"]["fg_gan"]
    gen = importlib.import_module(f"benchmark.traffic.{traffic['kind']}")
    batches = make_batches(gen.make_plan(traffic, seed)[:CHECKED_STEPS],
                           f, seed)
    got = fg_gan_step.reference_steps(f, batches, seed, device, precision)
    want = fg_gan_step.reference_steps(f, batches, seed, device,
                                       starts=got["starts"])
    limits = load_json("limits", f"{cell['name']}.json")
    return {c["name"]: c["value"]
            for c in check.checks(got, want, f, limits)}
