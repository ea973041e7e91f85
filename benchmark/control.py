"""The control of the output check: the plain reference put in the
program's place and computed one precision lower than the configuration
states (the configurations state float32 with TF32 off; the control runs
with TF32 on), at the cell's own size, on the commands or steps the check
replays.  It has to come out as not correct; its readings set the upper
end of each limit.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13

prints one JSON line per seed with the compared numbers.  The benchmark's
own runs never run it; ``tests/test_bench_control.py`` does, on the card.

Each configuration's driver brings its own control:
``drivers/<driver>.py:control(cell, config, traffic, seed, device,
precision) -> {number: value}``, found by the driver's name as the run
finds its ``run``.
"""
from __future__ import annotations

import argparse
import importlib
import json

from . import harness


def control(name: str, seed: int, device="cuda", precision="tf32"):
    cell, config, traffic = harness.cell_files(name)
    driver = importlib.import_module(f"benchmark.drivers.{config['driver']}")
    if not hasattr(driver, "control"):
        raise SystemExit(
            f"benchmark/drivers/{config['driver']}.py has no control(cell, "
            "config, traffic, seed, device, precision): each configuration's "
            "driver brings the control of its cells")
    return driver.control(cell, config, traffic, seed, device, precision)


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
