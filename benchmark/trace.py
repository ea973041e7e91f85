"""Tracing of a ``--trace 1`` run, from the benchmark's side.

- ``ModuleTimers``: CUDA events recorded by forward hooks around named
  modules of the program (a generator, the backbone), read once the window
  has closed; the hooks sit outside the program and change none of it.
- ``DeviceTrace``: ``torch.profiler`` with CUDA activity over the window;
  every kernel, copy and memset as an interval on the host's
  ``perf_counter`` clock.  The two clocks are tied by a marker kernel
  (``torch.cuda._sleep``) launched right after a synchronize at the start.
- ``busy_intervals``, ``idle_gaps``, ``breakdown``: the device's busy time,
  its idle gaps named by what the host was doing, the top operations.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import torch

Span = Tuple[str, float, float]


class ModuleTimers:
    def __init__(self, modules: Dict[str, torch.nn.Module]):
        self.events: Dict[str, list] = defaultdict(list)
        self.handles = []
        for name, module in modules.items():
            self.handles.append(module.register_forward_pre_hook(
                self._pre(name)))
            self.handles.append(module.register_forward_hook(
                self._post(name)))

    def _pre(self, name):
        def hook(_module, _inputs):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[name].append([ev, None])
        return hook

    def _post(self, name):
        def hook(_module, _inputs, _outputs):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[name][-1][1] = ev
        return hook

    def close(self) -> Dict[str, List[float]]:
        for h in self.handles:
            h.remove()
        torch.cuda.synchronize()
        return {name: [a.elapsed_time(b) for a, b in pairs if b is not None]
                for name, pairs in self.events.items()}


class DeviceTrace:
    """``with DeviceTrace() as tr: ...``; then ``tr.kernels``."""

    def __init__(self):
        self.kernels: List[Span] = []
        self.prof = None
        self.offset = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.marker_host = time.perf_counter()
        torch.cuda._sleep(20000)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        events = []
        marker = None
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            start = ev.start_ns()
            events.append((ev.name(), start, start + ev.duration_ns()))
            if marker is None and "spin" in ev.name():
                marker = start
        if marker is None:          # no marker: assume the unix clock
            marker = (time.time_ns()
                      - (time.perf_counter() - self.marker_host) * 1e9)
        self.offset = self.marker_host - marker * 1e-9
        self.kernels = sorted(
            (name, s * 1e-9 + self.offset, e * 1e-9 + self.offset)
            for name, s, e in events if "spin" not in name)
        self.prof = None
        return False


def busy_intervals(kernels: Sequence[Span], t0: float, t1: float
                   ) -> List[Tuple[float, float]]:
    """Union of the device intervals, clipped to [t0, t1]."""
    out: List[List[float]] = []
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_gaps(busy: Sequence[Tuple[float, float]], t0: float, t1: float
              ) -> List[Tuple[float, float]]:
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    return gaps


def host_label(spans: Sequence[Span], stages: Sequence[Span], t: float) -> str:
    """What the host was doing at ``t``: the program's innermost stage,
    else the benchmark's innermost span, else 'between calls'."""
    for group in (stages, spans):
        inside = [s for s in group if s[1] <= t <= s[2]]
        if inside:
            return min(inside, key=lambda s: s[2] - s[1])[0]
    return "between calls"


def breakdown(kernels: Sequence[Span], spans: Sequence[Span],
              stages: Sequence[Span], t0: float, t1: float,
              top: int = 10) -> Tuple[float, Dict]:
    """(busy seconds, {"device_ops", "idle_gaps"}) of the window."""
    busy = busy_intervals(kernels, t0, t1)
    per_op: Dict[str, float] = defaultdict(float)
    for name, s, e in kernels:
        s, e = max(s, t0), min(e, t1)
        if e > s:
            per_op[name[:120]] += e - s
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(busy, t0, t1), key=lambda g: g[0] - g[1])[:top]
    named = [[host_label(spans, stages, (s + e) / 2), e - s] for s, e in gaps]
    return (sum(e - s for s, e in busy),
            {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named})


def attributed_seconds(kernels: Sequence[Span], own: Sequence[str],
                       shared: Sequence[str], others: Sequence[str],
                       t0: float, t1: float) -> float:
    """Device seconds of one kernel family: kernels whose name contains
    one of ``own``, plus the ``shared`` launches (layouts, tables) that
    precede the family's next kernel rather than another family's (one
    of ``others``)."""
    total, pending = 0.0, 0.0
    for name, s, e in sorted(kernels, key=lambda k: k[1]):
        d = min(e, t1) - max(s, t0)
        if d <= 0:
            continue
        if any(k in name for k in own):
            total += d + pending
            pending = 0.0
        elif any(k in name for k in others):
            pending = 0.0
        elif any(k in name for k in shared):
            pending += d
    return total
