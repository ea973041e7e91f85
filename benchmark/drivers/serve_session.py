"""Driver of the interactive serving cells: one ``ColorizationSession``
built by the program's ``build_session``, one client in a closed loop.

Set-up: the traffic's scenes are written under ``$TMPDIR``, the session is
built, the seeded weights are loaded into its three models (the normal
``load_state_dict`` a snapshot restore ends in), its FG noise rows come
from a stream drawn from the seed (``noise_source``), and warm-up visits
serve every generator bucket and command kind the traffic uses.  The
window then runs the planned visits, one command after the other, until
``--seconds`` have passed; the command in flight completes and counts.

The benchmark watches the timed path from outside: it wraps the public
``match_instances`` and ``MatchingEngine.fuse_logits`` and hooks the
generators' forwards, to keep the outputs of the sampled visits and the
instances every FG command matched.  With ``--trace 1`` the session's
stage trace is on, the profiler traces the device and CUDA events time
the backbone and the generators.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from .. import reference, scenes as scn, serve_check, trace as tr, work
from ..device import host_counters, host_delta, on_cuda, release, sync
from ..harness import BENCH_DIR, load_json
from ..record import Run
from ..reference import ops, text as rtext
from ..reference.init import load_into
from ..reference.text import is_fg

SAMPLE_VISITS = 6         # visits the output check replays, drawn among
                          # the window's first cycle through the pool


class NoiseStream:
    """FG noise rows drawn from the seed, handed out in order; each call
    is logged with the command that made it."""

    def __init__(self, seed: int, dim: int, rows: int = 16384):
        self.rows = np.random.default_rng([seed, 5]).standard_normal(
            (rows, dim)).astype(np.float32)
        self.pos = 0
        self.current = None
        self.log: Dict[int, List[np.ndarray]] = {}

    def __call__(self, k: int) -> np.ndarray:
        idx = (self.pos + np.arange(k)) % len(self.rows)
        self.pos += k
        out = self.rows[idx]
        if self.current is not None:
            self.log.setdefault(self.current, []).append(out)
        return out


def framework_config(config: dict, data_dir: str, out_dir: str, trace: bool):
    from sketchyscenecolorization_torch.config import FrameworkConfig
    cfg = FrameworkConfig.from_json(json.dumps(config["framework"]))
    vocab = os.path.join(BENCH_DIR, "data")
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, data_base_dir=data_dir, results_base_dir=out_dir,
        match_vocab_path=os.path.join(vocab, "match_vocab.txt"),
        fg_vocab_path=os.path.join(vocab, "fg_vocab.txt"),
        bg_vocab_path=os.path.join(vocab, "bg_vocab.txt"),
        match_ckpt_dir="", fg_ckpt_dir="", bg_ckpt_dir="",
        stage_trace=trace))


def write_scenes(plan, seed: int, size: int, data_dir: str):
    pool = []
    for j, sp in enumerate(plan.pool):
        rng = np.random.default_rng([seed, 1000 + j])
        scene = scn.draw_scene(rng, size, [sp.class_id] * sp.k, sp.sides)
        scn.write_scene(data_dir, f"p{j}", scene)
        pool.append(scene)
    for visit in plan.warmup + plan.visits:
        scn.link_scene(data_dir, f"p{visit.pool}", visit.name)
    return pool


def load_weights(session, fw: dict, seed: int, device) -> None:
    """The seeded weights into the session's three models, one model's
    tensors on the device at a time."""
    for kind, model in (("matching", session.matching.model),
                        ("fg_gan", session.fg.model),
                        ("bg_gan", session.bg.model)):
        _, state = reference.build(kind, fw[kind], seed, device)
        load_into(model, state)
        del state
    release(device)


class Watch:
    """Outputs and matches of the timed path, kept from outside."""

    def __init__(self, session, noise: NoiseStream, spans=None):
        self.cmd = None
        self.spans = spans
        self.capture = False
        self.noise = noise
        self.matched: Dict[int, List[int]] = {}
        self.out: Dict[int, dict] = {}
        match, fuse = session.match_instances, session.matching.fuse_logits

        def match_instances(image_id, text):
            t0 = time.perf_counter()
            found = match(image_id, text)
            if self.spans is not None:
                self.spans.append(("match_instances", t0,
                                   time.perf_counter()))
            self.matched[self.cmd] = list(found)
            return found

        def fuse_logits(visual, words, lens):
            up = fuse(visual, words, lens)
            if self.capture:
                self.out.setdefault(self.cmd, {}).setdefault(
                    "up", []).append(up)
            return up

        session.match_instances = match_instances
        session.matching.fuse_logits = fuse_logits
        session.fg.model.register_forward_hook(self._keep("fg", False))
        session.bg.model.register_forward_hook(self._keep("bg", True))

    def _keep(self, key, first):
        def hook(_module, _inputs, output):
            if self.capture:
                self.out.setdefault(self.cmd, {}).setdefault(key, []).append(
                    output[0] if first else output)
        return hook

    def start(self, cmd: int, capture: bool) -> None:
        self.cmd, self.capture = cmd, capture
        self.noise.current = cmd if capture else None

    def host_outputs(self, cmd: int) -> dict:
        """The kept outputs of command ``cmd`` on the host: ``up`` [M, H,
        W] (one row per text the matcher ran), ``fg`` the generator's real
        rows in order (each call's first k rows, k the noise rows it drew),
        ``bg`` [H, W, 3], the noise rows and the matched instances."""
        kept = {k: [t.float().cpu().numpy() for t in v]
                for k, v in self.out.pop(cmd, {}).items()}
        noise = self.noise.log.get(cmd, [])
        got = {"matched": self.matched.get(cmd),
               "noise": np.concatenate(noise) if noise else None}
        if "up" in kept:
            got["up"] = np.concatenate(kept["up"])[..., 0]
        if "fg" in kept:
            got["fg"] = np.concatenate([o[:len(n)] for o, n in
                                        zip(kept["fg"], noise)])
        if "bg" in kept:
            got["bg"] = kept["bg"][-1][0]
        return got


def issue(session, visit, command) -> List[str]:
    """Run one planned command; the result paths it wrote."""
    if command[0] == "withdraw":
        session.withdraw(visit.name)
        return []
    if command[0] == "stream":
        return list(session.colorize_stream(visit.name, command[1]))
    return [session.colorize(visit.name, command[1])]


def texts_of(command) -> List[str]:
    return [] if command[0] == "withdraw" else (
        list(command[1]) if command[0] == "stream" else [command[1]])


def run(cell, config, traffic, seed, seconds, trace, started, device
        ) -> Run:
    from sketchyscenecolorization_torch.pipeline.factory import build_session
    fw = config["framework"]
    pl = fw["pipeline"]
    gen = importlib.import_module(f"benchmark.traffic.{traffic['kind']}")
    plan = gen.make_plan(traffic, seed)
    limits = load_json("limits", f"{cell['name']}.json")
    rec = Run(device={"platform": "gpu", "count": 1,
                      "kind": torch.cuda.get_device_name(0)}
              if on_cuda(device) else {"platform": "cpu", "count": 1,
                                       "kind": "cpu"})
    root = tempfile.mkdtemp(prefix="bench-")
    try:
        data_dir, out_dir = os.path.join(root, "data"), os.path.join(root, "out")
        pool = write_scenes(plan, seed, pl["image_size"], data_dir)
        rec.notes["scenes_s"] = time.time() - started
        session = build_session(framework_config(config, data_dir, out_dir,
                                                 trace), seed=seed,
                                device=device)
        rec.notes["built_s"] = time.time() - started
        load_weights(session, fw, seed, device)
        rec.notes["weights_s"] = time.time() - started
        noise = NoiseStream(seed, fw["fg_gan"]["noise_dim"])
        session.fg.noise_source = noise
        watch = Watch(session, noise, rec.spans if trace else None)
        if on_cuda(device):
            torch.cuda.reset_peak_memory_stats()

        # warm-up: every K of the pool once, with the traffic's commands
        misses = 0
        for visit in plan.warmup:
            k = plan.pool[visit.pool].k
            for command in visit.commands:
                watch.start(-1, False)
                issue(session, visit, command)
                if command[0] == "color" and is_fg(command[1]):
                    misses += watch.matched.get(-1) != list(range(k))
                watch.matched.pop(-1, None)
        # at the default 768^2 the session builds the sky gradient's 24-bit
        # lookup table on a thread of its own from its start (the program
        # does so above 200,000 pixels a half-canvas); set-up waits for it,
        # so that no window shares the host with that build
        t_lut = time.perf_counter()
        if pl["color_gradient"] and pl["image_size"] ** 2 // 2 >= 200_000:
            session.bg.lut_device()
        rec.notes["lut_wait_s"] = time.perf_counter() - t_lut
        sync(device)
        session.clear_trace()
        del rec.spans[:]

        sample = set(serve_check.sample_visits(plan, seed, SAMPLE_VISITS,
                                               len(plan.pool)))
        timers = tr.ModuleTimers({
            "backbone": session.matching.model.backbone,
            "fg_generator": session.fg.model,
            "bg_generator": session.bg.model}) if trace else None
        device_trace = tr.DeviceTrace() if trace else None
        log: List[dict] = []
        if device_trace:
            device_trace.__enter__()
        host0 = host_counters()
        t_start = time.perf_counter()
        rec.setup_s = time.time() - started
        deadline = t_start + seconds
        done = False
        for v, visit in enumerate(plan.visits):
            for command in visit.commands:
                if time.perf_counter() >= deadline:
                    done = True
                    break
                i = len(log)
                watch.start(i, v in sample)
                t0 = time.perf_counter()
                ok, paths = True, []
                try:
                    paths = issue(session, visit, command)
                except Exception as exc:          # a command that fails
                    ok = False
                    rec.failed += 1
                    print(f"benchmark: command {command} on {visit.name} "
                          f"failed: {exc!r}", flush=True)
                t1 = time.perf_counter()
                texts = texts_of(command)
                kind = command[0] if command[0] != "color" else (
                    "fg" if is_fg(command[1]) else "bg")
                log.append({"visit": v, "kind": command[0], "ok": ok,
                            "texts": texts, "paths": paths,
                            "cmd_kind": kind, "end": t1})
                rec.walls_s.append(t1 - t0 if ok else float("inf"))
                rec.kinds.append(kind)
                rec.counts.append(max(len(texts), 1))
                rec.spans.append((f"command:{kind}", t0, t1))
            if done:
                break
        sync(device)
        t_end = time.perf_counter()
        rec.notes.update(host_delta(host0, host_counters()))
        for j in range(6):                    # commands done per sixth
            lo = t_start + j * (t_end - t_start) / 6
            hi = t_start + (j + 1) * (t_end - t_start) / 6
            rec.notes[f"sixth{j}"] = sum(lo <= e["end"] < hi for e in log)
        first = [i == 0 or log[i - 1]["visit"] != e["visit"]
                 for i, e in enumerate(log)]
        for tag, pick in (("first_ms", True), ("rest_ms", False)):
            walls = sorted(w for w, f in zip(rec.walls_s, first) if f == pick)
            if walls:
                rec.notes[tag] = walls[len(walls) // 2] * 1e3
        rec.window = (t_start, t_end)
        rec.window_s = t_end - t_start
        rec.attempted = len(log)
        if device_trace:
            device_trace.__exit__(None, None, None)
            rec.kernels = device_trace.kernels
            rec.module_ms = timers.close()
            rec.stages = session.trace_events
            rec.traced_window_s = rec.window_s
            rec.busy_s, rec.breakdown = tr.breakdown(
                rec.kernels, rec.spans, rec.stages, t_start, t_end)
        rec.peak_bytes = torch.cuda.max_memory_allocated() \
            if on_cuda(device) else 0
        rec.device["memory_peak_bytes"] = rec.peak_bytes

        # the program's outputs of the sample, then the program goes
        entries: Dict[int, List[dict]] = {}
        for i, e in enumerate(log):
            if e["visit"] in sample:
                e.update(watch.host_outputs(i))
                entries.setdefault(e["visit"], []).append(e)
            elif e["cmd_kind"] == "fg":
                k = plan.pool[plan.visits[e["visit"]].pool].k
                misses += watch.matched.get(i) != list(range(k))
        session.close()
        del session, watch
        release(device)

        ref = serve_check.Reference(fw, seed, device)
        results = [serve_check.replay_visit(
            ref, pool[plan.visits[v].pool], es, pl)
            for v, es in sorted(entries.items())]
        del ref
        kinds = {"fg" if e["cmd_kind"] == "stream" else e["cmd_kind"]
                 for e in log}
        rec.checks = serve_check.checks(results, misses, limits, kinds)
        rec.checks.append({"name": "visits_compared",
                           "value": len(results), "limit": 1})
        rec.correct = (serve_check.passed(rec.checks[:-1])
                       and len(results) >= 1 and rec.failed == 0)
        if trace:
            rec.work = work.serve_work(fw, plan, log)
    finally:
        written = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(root) for f in fs
                      if not os.path.islink(os.path.join(d, f)))
        print(f"benchmark: {written / 2 ** 20:.1f} MiB left under $TMPDIR "
              "at the end of the run", flush=True)
        shutil.rmtree(root, ignore_errors=True)
    return rec


# the control (``benchmark/control.py``): the reference at ``precision`` in
# the program's place, on the visits the output check replays

def _serve_entries(plan, visit, noise) -> List[dict]:
    out = []
    k = plan.pool[visit.pool].k
    for command in visit.commands:
        if command[0] == "withdraw":
            out.append({"kind": "withdraw"})
            continue
        texts = list(command[1]) if command[0] == "stream" else [command[1]]
        n_fg = sum(rtext.is_fg(t) for t in texts)
        out.append({"kind": command[0], "texts": texts, "paths": [],
                    "noise": noise(k * n_fg) if n_fg else None})
    return out


def _outputs(ref, scene, entries, pl, precision) -> List[dict]:
    """What the reference at ``precision`` puts where the program's
    outputs go: logits, matched instances, generator rows."""
    got = []
    visual = None
    bg_text = ""
    k = len(scene.masks)
    for e in entries:
        if e["kind"] == "withdraw":
            got.append({})
            continue
        g = {"up": [], "fg": []}
        with ops.precision(precision):
            for j, text in enumerate(t for t in e["texts"] if rtext.is_fg(t)):
                visual = ref.visual(scene.sketch) if visual is None else visual
                g["up"].append(ref.logits(visual, text))
                g["fg"].append(ref.fg_rows(scene, list(range(k)), text,
                                           e["noise"][j * k:(j + 1) * k]))
            for text in e["texts"]:
                if not rtext.is_fg(text):
                    bg_text = rtext.merge_bg_text(
                        text, bg_text or rtext.DEFAULT_BG_TEXT)
                    g["bg"] = ref.bg_rgb(scene.sketch, scene.inner, bg_text)
        g["up"] = np.stack(g["up"]) if g["up"] else None
        g["fg"] = np.concatenate(g["fg"]) if g["fg"] else None
        g = {key: v for key, v in g.items() if v is not None}
        if e["kind"] == "color" and "up" in g:
            g["matched"] = list(range(k))
        g["noise"] = e["noise"]
        got.append(g)
    return got


def control(cell: dict, config: dict, traffic: dict, seed: int,
            device="cuda", precision="tf32") -> Dict[str, float]:
    fw = config["framework"]
    pl = fw["pipeline"]
    gen = importlib.import_module(f"benchmark.traffic.{traffic['kind']}")
    plan = gen.make_plan(traffic, seed)
    noise = NoiseStream(seed, fw["fg_gan"]["noise_dim"])
    ref = serve_check.Reference(fw, seed, device)
    results = []
    for v in serve_check.sample_visits(plan, seed, SAMPLE_VISITS,
                                       len(plan.pool)):
        visit = plan.visits[v]
        sp = plan.pool[visit.pool]
        rng = np.random.default_rng([seed, 1000 + visit.pool])
        scene = scn.draw_scene(rng, pl["image_size"],
                               [sp.class_id] * sp.k, sp.sides)
        entries = _serve_entries(plan, visit, noise)
        program = _outputs(ref, scene, entries, pl, precision)
        results.append(serve_check.replay_visit(ref, scene, entries, pl,
                                                program=program))
    kinds = {"fg" if rtext.is_fg(t) else "bg"
             for v in plan.visits for c in v.commands for t in texts_of(c)}
    limits = load_json("limits", f"{cell['name']}.json")
    return {c["name"]: c["value"]
            for c in serve_check.checks(results, 0, limits, kinds)}
