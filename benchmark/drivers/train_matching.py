"""Driver of the matcher-training cell: the program's
``create_matching_state`` and ``make_matching_train_step`` on its RMI,
fed by its ``prefetch_to_device``, as ``train/harness.py:train_matching``
runs them (the loss read back every step, as the harness prints it).

Set-up builds one train state with the seeded weights, drives it through
its first steps on batches that all differ (the first three are the ones
the output check replays), and hands the same state to the window, which
steps until ``--seconds`` have passed and ends on a synchronize.
"""
from __future__ import annotations

import gc
import importlib
import itertools
import time
from typing import Dict

import numpy as np
import torch

from .. import reference, scenes as scn, trace as tr, train_check
from ..device import host_counters, host_delta, on_cuda, release, sync
from ..harness import load_json
from ..record import Run
from ..reference.init import load_into
from ..reference.text import matching_encode
from ..serve_check import PIXEL_MU, vocab

CHECKED_STEPS = 3
WARM_STEPS = 3            # further set-up steps (the window's shapes)


def make_batches(plan, m: dict, seed: int):
    """Host batches as the training loader makes them: the mean-subtracted
    sketch, the end-padded caption and its length, the label mask."""
    mv = vocab("match_vocab.txt")
    out = []
    for j, b in enumerate(plan):
        rng = np.random.default_rng([seed, 2000 + j])
        scene = scn.draw_scene(rng, m["H"], b.class_ids, b.sides)
        words, n = matching_encode(b.caption, mv, m["max_len"])
        target = np.zeros((m["H"], m["W"]), np.float32)
        for t in b.targets:
            target[scene.masks[t] == 1] = 1.0
        out.append({
            "image": (scene.sketch.astype(np.float32) - PIXEL_MU)
            .astype(np.float32)[None],
            "words": np.asarray(words, np.int32)[None],
            "seq_len": np.asarray([n], np.int32),
            "target_mask": target[None, :, :, None]})
    return out


def run(cell, config, traffic, seed, seconds, trace, started, device) -> Run:
    from sketchyscenecolorization_torch.config import MatchingConfig
    from sketchyscenecolorization_torch.models.rmi import RMI
    from sketchyscenecolorization_torch.ops.conv import apply_compute_dtype
    from sketchyscenecolorization_torch.parallel import prefetch_to_device
    from sketchyscenecolorization_torch.train.matching import (
        create_matching_state, make_matching_train_step)
    m = config["framework"]["matching"]
    gen = importlib.import_module(f"benchmark.traffic.{traffic['kind']}")
    plan = gen.make_plan(traffic, seed)
    limits = load_json("limits", f"{cell['name']}.json")
    rec = Run(device={"platform": "gpu", "count": 1,
                      "kind": torch.cuda.get_device_name(0)}
              if on_cuda(device) else {"platform": "cpu", "count": 1,
                                       "kind": "cpu"})
    batches = make_batches(plan, m, seed)

    cfg = MatchingConfig(**m)
    apply_compute_dtype(cfg)
    model = RMI(cfg).to(device)
    _, weights = reference.build("matching", m, seed, device)
    load_into(model, weights)
    del weights
    release(device)
    state = create_matching_state(model, cfg)
    step_fn = make_matching_train_step(cfg)
    if on_cuda(device):
        torch.cuda.reset_peak_memory_stats()
    feed = prefetch_to_device(itertools.cycle(batches), device, depth=2)
    names = list(state.mu)
    params = dict(model.named_parameters())

    first = {"start": {n: params[n].detach().to("cpu", copy=True) for n in names},
             "losses": []}
    for s in range(CHECKED_STEPS + WARM_STEPS):
        state, metrics = step_fn(state, next(feed))
        loss = float(metrics["cost"])
        if s < CHECKED_STEPS:
            first["losses"].append(loss)
        if s == 0:
            first["mu"] = {n: state.mu[n].detach().to("cpu", copy=True) for n in names}
        if s == CHECKED_STEPS - 1:
            first["end"] = {n: params[n].detach().to("cpu", copy=True) for n in names}
    sync(device)

    timers = tr.ModuleTimers({"backbone": model.backbone}) if trace else None
    device_trace = tr.DeviceTrace() if trace else None
    if device_trace:
        device_trace.__enter__()
    host0 = host_counters()
    t_start = time.perf_counter()
    rec.setup_s = time.time() - started
    deadline = t_start + seconds
    steps = 0
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, next(feed))
        float(metrics["cls_loss"])
        t1 = time.perf_counter()
        steps += 1
        rec.walls_s.append(t1 - t0)
        rec.spans.append(("train_step", t0, t1))
    sync(device)
    t_end = time.perf_counter()
    rec.notes.update(host_delta(host0, host_counters()))
    rec.steps = rec.attempted = steps
    rec.window = (t_start, t_end)
    rec.window_s = t_end - t_start
    if device_trace:
        device_trace.__exit__(None, None, None)
        rec.kernels = device_trace.kernels
        rec.module_ms = timers.close()
        rec.traced_window_s = rec.window_s
        rec.busy_s, rec.breakdown = tr.breakdown(
            rec.kernels, rec.spans, [], t_start, t_end)
        rec.work = train_check.train_work(m, plan, CHECKED_STEPS + WARM_STEPS,
                                          steps)
    rec.peak_bytes = torch.cuda.max_memory_allocated() \
        if on_cuda(device) else 0
    rec.device["memory_peak_bytes"] = rec.peak_bytes
    prog = {"losses": first["losses"],
            "grads": {n: v / (1.0 - train_check.ADAM_B1)
                      for n, v in first["mu"].items()},
            "change": {n: first["end"][n] - first["start"][n]
                       for n in names}}
    del state, model, params, first, feed, step_fn
    gc.collect()
    release(device)

    want = train_check.reference_steps(m, batches[:CHECKED_STEPS], seed,
                                       device)
    rec.checks = train_check.checks(prog, want, limits)
    rec.correct = train_check.passed(rec.checks)
    return rec


def control(cell, config, traffic, seed, device="cuda", precision="tf32"
            ) -> Dict[str, float]:
    """The control (``benchmark/control.py``): the reference's first
    steps at ``precision`` in the program's place."""
    m = config["framework"]["matching"]
    gen = importlib.import_module(f"benchmark.traffic.{traffic['kind']}")
    batches = make_batches(gen.make_plan(traffic, seed)[:CHECKED_STEPS],
                           m, seed)
    want = train_check.reference_steps(m, batches, seed, device)
    got = train_check.reference_steps(m, batches, seed, device, precision)
    limits = load_json("limits", f"{cell['name']}.json")
    return {c["name"]: c["value"]
            for c in train_check.checks(got, want, limits)}
