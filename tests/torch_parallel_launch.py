"""Start the ranks of a process mesh on one host, for the multi-process
tests (``tests/test_torch_parallel*.py``) and ``chip_smoke.py``.

``start_ranks(fn, world_size, init_method)`` starts ``world_size``
processes with the ``spawn`` start method; each joins the default process
group (``init_method`` is its rendezvous: a ``file://`` path, or
``tcp://localhost:<port>``), runs ``fn(rank, *args)`` and leaves the
group.  ``join_ranks`` waits for all of them and raises if one failed;
``torch.multiprocessing`` then ends the others.  The group's ``timeout``
bounds every collective, so a rank that dies makes the others fail within
it instead of waiting for ever.

Two ranks cannot share a card under NCCL; on a one-card host, ranks that
share ``cuda:0`` use ``gloo``, which takes CUDA tensors.
"""
from __future__ import annotations

import datetime
import os
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn: Callable, world_size: int, init_method: str,
               backend: str, timeout_s: float, threads: Optional[int],
               args: Sequence) -> None:
    os.environ["LOCAL_RANK"] = str(rank)       # one host
    if threads is not None:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def start_ranks(fn: Callable, world_size: int, init_method: str,
                args: Sequence = (), backend: str = "gloo",
                timeout_s: float = 120.0, threads: Optional[int] = None
                ) -> mp.ProcessContext:
    """Start ``fn(rank, *args)`` on ``world_size`` spawned ranks (``fn``
    and ``args`` are pickled: a module-level function); ``threads`` sets
    each rank's torch intra-op threads."""
    return mp.start_processes(
        _rank_main, args=(fn, world_size, init_method, backend, timeout_s,
                          threads, tuple(args)),
        nprocs=world_size, join=False, start_method="spawn")


def join_ranks(context: mp.ProcessContext) -> None:
    """Wait for every rank; raises if one failed (the others are ended)."""
    while not context.join():
        pass


def run_ranks(fn: Callable, world_size: int, init_method: str,
              args: Sequence = (), **kwargs) -> None:
    """``start_ranks`` then ``join_ranks``."""
    join_ranks(start_ranks(fn, world_size, init_method, args, **kwargs))
