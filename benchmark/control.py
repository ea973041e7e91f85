"""The control of the output check: the plain reference put in the
program's place and computed one precision lower than the configuration
states (the configurations state float32 with TF32 off; the control runs
with TF32 on), at the cell's own size, on the commands or steps the check
replays.  It has to come out as not correct; its readings set the upper
end of each limit.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13

prints one JSON line per seed with the compared numbers.  The benchmark's
own runs never run it; ``tests/test_bench_control.py`` does, on the card.
"""
from __future__ import annotations

import argparse
import importlib
import json
from typing import Dict, List

import numpy as np

from . import harness, serve_check, train_check
from .reference import ops
from .reference import text as rtext


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


def serve_control(cell: dict, config: dict, traffic: dict, seed: int,
                  device="cuda", precision="tf32") -> Dict[str, float]:
    from .drivers import serve_session as drv
    fw = config["framework"]
    pl = fw["pipeline"]
    gen = importlib.import_module(f"benchmark.traffic.{traffic['kind']}")
    plan = gen.make_plan(traffic, seed)
    noise = drv.NoiseStream(seed, fw["fg_gan"]["noise_dim"])
    ref = serve_check.Reference(fw, seed, device)
    results = []
    for v in serve_check.sample_visits(plan, seed, drv.SAMPLE_VISITS,
                                       len(plan.pool)):
        visit = plan.visits[v]
        sp = plan.pool[visit.pool]
        rng = np.random.default_rng([seed, 1000 + visit.pool])
        scene = drv.scn.draw_scene(rng, pl["image_size"],
                                   [sp.class_id] * sp.k, sp.sides)
        entries = _serve_entries(plan, visit, noise)
        program = _outputs(ref, scene, entries, pl, precision)
        results.append(serve_check.replay_visit(ref, scene, entries, pl,
                                                program=program))
    from .drivers.serve_session import texts_of
    kinds = {"fg" if rtext.is_fg(t) else "bg"
             for v in plan.visits for c in v.commands for t in texts_of(c)}
    limits = harness.load_json("limits", f"{cell['name']}.json")
    return {c["name"]: c["value"]
            for c in serve_check.checks(results, 0, limits, kinds)}


def train_control(cell: dict, config: dict, traffic: dict, seed: int,
                  device="cuda", precision="tf32") -> Dict[str, float]:
    from .drivers import train_matching as drv
    m = config["framework"]["matching"]
    gen = importlib.import_module(f"benchmark.traffic.{traffic['kind']}")
    batches = drv.make_batches(gen.make_plan(traffic, seed)[:drv.CHECKED_STEPS],
                               m, seed)
    want = train_check.reference_steps(m, batches, seed, device)
    got = train_check.reference_steps(m, batches, seed, device, precision)
    limits = harness.load_json("limits", f"{cell['name']}.json")
    return {c["name"]: c["value"]
            for c in train_check.checks(got, want, limits)}


def control(name: str, seed: int, device="cuda", precision="tf32"):
    cell, config, traffic = harness.cell_files(name)
    fn = train_control if config["driver"] == "train_matching" \
        else serve_control
    return fn(cell, config, traffic, seed, device, precision)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--precision", default="tf32")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": args.precision,
                          **control(args.workload, seed,
                                    precision=args.precision)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
