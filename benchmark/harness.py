"""The benchmark's driver-independent half: the manifest, the cell's files,
the environment, the device check, the metric readers and the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by its name: ``configs/<config>.json`` names its driver
(``drivers/<driver>.py``), ``traffic/<traffic>.json`` names its generator
(``traffic/<kind>.py``), and each metric of ``BENCHMARK.json`` is read by
``metrics/<name>.py``.  Adding one adds files; nothing here changes.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level modules a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "sketchyscenecolorization_tpu")


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(*parts) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def cell_files(name: str, man: Optional[dict] = None):
    """(cell entry, config dict, traffic dict) of workload ``name``."""
    man = man or manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    return (cell, load_json("configs", f"{cell['config']}.json"),
            load_json("traffic", f"{cell['traffic']}.json"))


def cell_metrics(cell: dict, man: dict, trace: bool) -> List[dict]:
    """The metrics the cell reports: its end-to-end ones with ``--trace 0``,
    its per-layer ones with ``--trace 1``."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group
            if cell["name"] in m.get("workloads", [cell["name"]])]


def metric_reader(name: str):
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, and no
    JAX behind any library."""
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None, started: Optional[float] = None) -> int:
    started = time.time() if started is None else started
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    man = manifest()
    cell, config, traffic = cell_files(args.workload, man)

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    driver = importlib.import_module(f"benchmark.drivers.{config['driver']}")
    run = driver.run(cell=cell, config=config, traffic=traffic,
                     seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), started=started, device="cuda")
    return finish(run, cell, man, bool(args.trace))


def finish(run, cell: dict, man: dict, trace: bool) -> int:
    """Read the cell's metrics from ``run`` and print the result line."""
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run holds {found}: the port and its harness "
              "must not load JAX or the JAX package", file=sys.stderr)
        return 4
    metrics = {}
    for m in cell_metrics(cell, man, trace):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(run.device)
    if trace:
        device["busy_s"] = run.busy_s
        device["window_s"] = run.traced_window_s
    checks = run.checks
    correct = bool(run.correct)
    finite = sorted(w for w in run.walls_s if w != float("inf"))
    median = finite[len(finite) // 2] * 1e3 if finite else 0.0
    print(f"benchmark: setup {run.setup_s:.3f} s, window {run.window_s:.3f} s,"
          f" {run.attempted} attempted, {run.failed} failed, "
          f"{run.steps} steps, median call {median:.2f} ms, "
          + ", ".join(f"{k} {v:.3f}" for k, v in run.notes.items()),
          file=sys.stderr)
    print(f"correct: {correct}", file=sys.stderr)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    line = {"correct": correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if trace and run.breakdown:
        line["breakdown"] = run.breakdown
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0
