"""Host-side batch workers and host-to-device copies
(``sketchyscenecolorization_tpu/parallel/prefetch.py``).

``BackgroundGenerator`` runs ``make_batch`` on worker threads (the
stand-in for the reference's TF1 queue runners).  ``prefetch_to_device``
keeps ``depth`` batches already on their way to the device: on a CUDA
device each array is copied from pinned host memory without blocking, on
a side stream, so the copy runs beside the step on the current stream;
the current stream waits for a batch's copy before the batch is handed
out.  On the CPU the arrays are wrapped.  Under a mesh it copies only
this rank's rows (JAX ``prefetch.py:24-35``).

Under a mesh every rank must see the same global batch at the same step,
while the batch workers draw from stateful generators in no fixed order.
So ``mesh_batches`` builds the batches on the mesh's first rank only and
broadcasts each one to the other ranks.
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import is_first_rank, shard_batch


def to_device(batch: Dict[str, np.ndarray], device,
              stream: Optional[torch.cuda.Stream] = None
              ) -> Dict[str, torch.Tensor]:
    """NumPy batch -> tensors on ``device``.  On CUDA each array is copied
    from pinned memory without blocking the host, on ``stream`` (default:
    the current stream)."""
    device = torch.device(device)
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        if device.type == "cuda":
            with torch.cuda.stream(stream):     # no-op when stream is None
                t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out


def prefetch_to_device(iterator: Iterable[Dict[str, np.ndarray]], device,
                       depth: int = 2, mesh=None
                       ) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield batches on ``device`` with ``depth`` copies in flight (on a
    side stream on CUDA); with a ``mesh``, this rank's rows of each global
    batch (``shard_batch``)."""
    device = torch.device(device)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def start_copy(batch):
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        out = to_device(batch, device, side)
        if side is None:
            return out, None
        copied = torch.cuda.Event()
        copied.record(side)
        return out, copied

    buf = collections.deque()
    it = iter(iterator)
    for batch in it:
        buf.append(start_copy(batch))
        if len(buf) == depth:
            break
    while buf:
        out, copied = buf.popleft()
        for batch in it:
            buf.append(start_copy(batch))
            break
        if copied is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(copied)
            for t in out.values():      # keep the allocator from reusing
                t.record_stream(current)  # the memory while the step runs
        yield out


class BackgroundGenerator:
    """Run a (possibly IO-bound) batch generator on worker threads.

    ``num_workers`` threads call ``make_batch(step)`` and push results into
    a bounded queue; iterating pops ready batches.  Order across workers is
    not guaranteed (neither was TF's shuffle_batch).  A worker's exception
    is raised to the consumer."""

    def __init__(self, make_batch: Callable[[int], Any], num_steps: int,
                 num_workers: int = 4, max_queue: int = 8):
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._lock = threading.Lock()
        self._next = 0
        self._num_steps = max(0, num_steps)
        self._make = make_batch
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(num_workers)]
        for t in self._threads:
            t.start()

    def _worker(self):
        while not self._stop.is_set():
            with self._lock:
                if self._next >= self._num_steps:
                    return
                step = self._next
                self._next += 1
            try:
                item = self._make(step)
            except Exception as e:  # surfaced to the consumer in __iter__
                item = e
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def close(self):
        """Stop the workers and drop queued batches (call when abandoning
        the iterator early)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=5.0)

    def __iter__(self):
        for _ in range(self._num_steps):
            item = self._q.get()
            if isinstance(item, Exception):
                raise item
            yield item


class _BroadcastBatches:
    """The global batches of ``make_batch``, made by a
    ``BackgroundGenerator`` on the mesh's first rank and broadcast to every
    rank of the default group, in order.  A worker's exception is
    broadcast too and raised on every rank."""

    def __init__(self, make_batch: Callable[[int], Any], num_steps: int,
                 mesh, **workers):
        self._num_steps = max(0, num_steps)
        self._src = int(mesh.mesh.flatten()[0])
        self._gen = BackgroundGenerator(make_batch, num_steps, **workers) \
            if is_first_rank(mesh) else None

    def close(self):
        if self._gen is not None:
            self._gen.close()

    def __iter__(self):
        made = iter(self._gen) if self._gen is not None else None
        for _ in range(self._num_steps):
            item = [None]
            if made is not None:
                try:
                    item[0] = next(made)
                except Exception as e:      # raised below on every rank
                    item[0] = e
            dist.broadcast_object_list(item, src=self._src)
            if isinstance(item[0], Exception):
                raise item[0]
            yield item[0]


def mesh_batches(make_batch: Callable[[int], Any], num_steps: int,
                 mesh=None, **workers):
    """A ``BackgroundGenerator`` of ``make_batch``, or under a ``mesh`` the
    same batches made on the mesh's first rank and broadcast to every
    rank (``close()`` either way)."""
    if mesh is None:
        return BackgroundGenerator(make_batch, num_steps, **workers)
    return _BroadcastBatches(make_batch, num_steps, mesh, **workers)
