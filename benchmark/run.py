"""One run of one benchmark cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  See ``benchmark/README.md``.
"""
from __future__ import annotations

import os
import time


def _process_start() -> float:
    """Wall-clock time at which this process started (``/proc``), so that
    ``setup_s`` counts the interpreter's start and every import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


if __name__ == "__main__":
    STARTED = _process_start()
    from .harness import main
    raise SystemExit(main(started=STARTED))
