"""NaN watchdog and auto-restart (``sketchyscenecolorization_tpu/train/watchdog.py``).

The reference's only failure recovery: training aborts with status -1 when
a GAN loss goes NaN (``obj_lib/main_procedure.py:213-232``) and the
launcher relaunches from the last checkpoint
(``obj_colorization_main.py:240-246``).  The train steps put a ``nan``
flag in their metrics; ``NaNWatchdog`` turns it into an abort signal and
``run_with_nan_restart`` is the relaunch loop.
"""
from __future__ import annotations

from typing import Callable, Optional


class NaNWatchdog:
    """Tracks the per-step NaN flag; ``check`` returns True when training
    must abort (the caller then restarts from the last checkpoint).
    Reading a flag that is a device tensor waits for the step."""

    def __init__(self):
        self.tripped = False
        self.trip_step: Optional[int] = None

    def check(self, metrics, step: int) -> bool:
        flag = metrics.get("nan")
        if flag is not None and bool(flag):
            self.tripped = True
            self.trip_step = step
            return True
        return False


def run_with_nan_restart(train_fn: Callable[[], int],
                         max_restarts: int = 100) -> int:
    """Keep relaunching while ``train_fn`` reports status -1 (NaN abort);
    ``train_fn`` itself resumes from its newest checkpoint."""
    status = -1
    restarts = 0
    while status == -1:
        status = train_fn()
        if status == -1:
            restarts += 1
            print(f"NaN watchdog tripped; restarting from last checkpoint "
                  f"(restart {restarts}).")
            if restarts >= max_restarts:
                raise RuntimeError("NaN restart limit exceeded")
    return status
