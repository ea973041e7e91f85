"""What one run measured, as the metric readers see it.

Times on the host are ``time.perf_counter`` seconds; device intervals from
the profiler are converted to the same clock.  A reader returns None where
a run has nothing for it to read.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

Span = Tuple[str, float, float]


@dataclass
class Run:
    setup_s: float = 0.0
    window_s: float = 0.0            # first timed call to the last return
    walls_s: List[float] = field(default_factory=list)  # per command / step
    kinds: List[str] = field(default_factory=list)      # per command / step
    counts: List[int] = field(default_factory=list)     # instructions each
    attempted: int = 0
    failed: int = 0
    steps: int = 0                   # train steps completed in the window
    peak_bytes: int = 0
    device: Dict = field(default_factory=dict)
    # with --trace 1
    spans: List[Span] = field(default_factory=list)     # the benchmark's
    stages: List[Span] = field(default_factory=list)    # the program's
    module_ms: Dict[str, List[float]] = field(default_factory=dict)
    kernels: List[Span] = field(default_factory=list)   # device, host clock
    busy_s: float = 0.0
    traced_window_s: float = 0.0
    window: Tuple[float, float] = (0.0, 0.0)
    work: Dict[str, float] = field(default_factory=dict)  # FLOPs, bounds
    breakdown: Optional[Dict] = None
    # the output check
    checks: List[Dict] = field(default_factory=list)
    correct: bool = False
    notes: Dict[str, float] = field(default_factory=dict)  # diagnostics

    def instructions(self, kinds=None) -> int:
        """Instructions completed in the window (a queue counts each of
        its own), of the given command kinds or all."""
        counts = self.counts or [1] * len(self.walls_s)
        return sum(c for c, w, k in zip(counts, self.walls_s, self.kinds)
                   if w != float("inf") and (kinds is None or k in kinds))

    def p95_ms(self) -> Optional[float]:
        """The 95th percentile of every call's wall in the window; a failed
        call counts as missing (infinitely late), so more than 5% failed
        reads nothing."""
        if not self.walls_s:
            return None
        p95 = float(np.percentile(np.asarray(self.walls_s), 95,
                                  method="inverted_cdf"))
        return None if p95 == float("inf") else p95 * 1e3

    def stage_ms_per_command(self, labels) -> Optional[float]:
        """Sum of the program's stage events whose label is in ``labels``
        (or starts with one ending in '*'), per completed command."""
        def hit(label):
            return any(label == l or (l.endswith("*") and
                                      label.startswith(l[:-1]))
                       for l in labels)
        total = sum(t1 - t0 for label, t0, t1 in self.stages if hit(label))
        n = self.instructions()
        if not n or not any(hit(s[0]) for s in self.stages):
            return None
        return total * 1e3 / n
