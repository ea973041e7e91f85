"""Device and host helpers shared by the drivers."""
from __future__ import annotations

import gc
import os
import time
from typing import Dict

import torch


def on_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if on_cuda(device):
        torch.cuda.synchronize()


def release(device) -> None:
    gc.collect()
    if on_cuda(device):
        torch.cuda.empty_cache()


def host_counters():
    """(process CPU seconds, wall seconds)."""
    t = os.times()
    return t.user + t.system, time.perf_counter()


def host_delta(a, b) -> Dict[str, float]:
    """Diagnostic of a window: the share of it the process ran on a CPU
    (near 1: the host, not the card, sets the pace)."""
    return {"cpu_share": (b[0] - a[0]) / max(b[1] - a[1], 1e-9)}
