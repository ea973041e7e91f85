"""The ('data', 'model') process mesh and the collectives of data and
pixel parallelism (``sketchyscenecolorization_tpu/parallel/mesh.py``).

JAX runs one program over a device mesh: a jitted step on a batch sharded
over 'data' computes the global batch's loss, gradients, batch-norm
moments and metrics, and XLA inserts the collectives.  Here each rank is a
process of a ``torch.distributed`` group that the caller has initialised,
and the collectives are explicit, so that a step over a sharded batch
computes what the single-process step computes on the global batch:

- a train step's losses are each rank's share of the global loss (a sum
  is summed, a mean over the batch is the shard's sum over the global
  count, ``shard_mean``; a term of the replicated weights is counted on
  the first 'data' rank only, ``count_once``), and ``reduce_gradients``
  sums the gradients over 'data' in one all-reduce before each update,
  so every rank applies the global gradient to identical parameters;
- batch-stats BN takes the global batch's moments (``ops/norm.py``,
  through ``global_sum``, whose backward sums the incoming gradients over
  'data' as the global batch's BN backward does);
- the metrics are summed over 'data' (``reduce_metrics``).
``DistributedDataParallel`` is not used: it averages gradients (the
matching loss is a sum), and a GAN step differentiates twice and updates
in several phases.

Axis 'model' shards the pixels of the mLSTM recurrences
(``ops/mlstm.py:PixelLSTM``, JAX's ``shard_map`` under ``jax.set_mesh``):
``set_mesh`` holds the mesh those functions, the norms and the losses read.

JAX's ``data_sharding`` and ``replicated_sharding`` build ``NamedSharding``
objects, which torch has not: ``shard_batch`` takes this rank's rows and
``replicate`` broadcasts a module's tensors from the mesh's first rank.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Dict, Iterable, Mapping, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

_ambient = threading.local()


def create_mesh(data: Optional[int] = None, model: int = 1,
                device_type: str = "cpu") -> DeviceMesh:
    """A ('data', 'model') mesh over every rank of the default process
    group (which the caller initialised).  ``data=None`` takes world size
    // model.  Unlike JAX, which may leave devices out, the mesh covers
    every rank.  ``device_type`` is that of the tensors the ranks
    exchange (``"cuda"`` or ``"cpu"``)."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, "
                         f"have {n}")
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} leaves ranks out of {n}: a "
                         "torch mesh covers every rank")
    if device_type == "cuda" and not torch.cuda.is_initialized():
        # before the mesh, which would take cuda:<LOCAL_RANK>: a one-card
        # host runs every rank on cuda:0
        torch.cuda.set_device(_local_cuda_index())
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def data_size(mesh: DeviceMesh) -> int:
    return mesh.size(0)


def data_index(mesh: DeviceMesh) -> int:
    """This rank's coordinate on 'data': which rows of a batch it holds."""
    return mesh.get_local_rank("data")


def is_first_rank(mesh: Optional[DeviceMesh]) -> bool:
    """True on the mesh's first rank (and without a mesh): the one that
    writes snapshots and logs."""
    return mesh is None or dist.get_rank() == int(mesh.mesh.flatten()[0])


def local_batch_size(global_batch: int, mesh: DeviceMesh) -> int:
    n_data = data_size(mesh)
    if global_batch % n_data != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data axis {n_data}")
    return global_batch // n_data


def shard_batch(batch: Mapping[str, Any], mesh: DeviceMesh) -> Dict[str, Any]:
    """This rank's rows of every array or tensor of a global batch (its
    leading axis split evenly over 'data', in order)."""
    out = {}
    for key, value in batch.items():
        size = local_batch_size(len(value), mesh)
        start = data_index(mesh) * size
        out[key] = value[start:start + size]
    return out


def _coalesced(tensors: Iterable[torch.Tensor], collective) -> None:
    """Run ``collective`` on one flat buffer of ``tensors`` (one dtype)
    and copy the result back into them."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    collective(flat)
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def replicate(obj, mesh: DeviceMesh):
    """Broadcast the parameters and buffers of a module (or the tensors of
    a mapping) from the mesh's first rank to every rank, in place, one
    broadcast per dtype; returns ``obj``.  Every rank then holds the same
    bits."""
    if isinstance(obj, torch.nn.Module):
        tensors = list(obj.parameters()) + list(obj.buffers())
    else:
        tensors = list(obj.values())
    src = int(mesh.mesh.flatten()[0])
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        _coalesced([t for t in tensors if t.dtype == dtype],
                   lambda flat: dist.broadcast(flat, src))
    return obj


def reduce_gradients(grads: Mapping[str, torch.Tensor],
                     mesh: DeviceMesh) -> Mapping[str, torch.Tensor]:
    """Sum the gradients of the leaves about to be updated over 'data', in
    place, in one all-reduce (the global batch's gradient, since each
    rank's loss is its share of the global loss); returns ``grads``.
    With several 'model' ranks, the first one's sums are then broadcast
    to the others: each 'model' rank computes the replicated parts of the
    model itself, and on CUDA some backward kernels (an embedding's
    scatter-add) sum in no fixed order, so the replicas would otherwise
    drift apart by rounding."""
    def collective(flat):
        dist.all_reduce(flat, group=mesh.get_group("data"))
        if mesh.size(1) > 1:
            group = mesh.get_group("model")
            dist.broadcast(flat, dist.get_process_group_ranks(group)[0],
                           group=group)
    _coalesced(grads.values(), collective)
    return grads


def reduce_metrics(metrics: Dict[str, torch.Tensor], keys: Iterable[str],
                   mesh: Optional[DeviceMesh]) -> Dict[str, torch.Tensor]:
    """The global value of each 0-d metric in ``keys`` (a rank's share of
    a loss), summed over 'data' in one all-reduce."""
    if mesh is None:
        return metrics
    keys = list(keys)
    flat = torch.stack([metrics[k].detach() for k in keys])
    dist.all_reduce(flat, group=mesh.get_group("data"))
    return {**metrics, **dict(zip(keys, flat.unbind()))}


@contextlib.contextmanager
def set_mesh(mesh: Optional[DeviceMesh]):
    """Make ``mesh`` the ambient mesh of this thread (``jax.set_mesh``):
    the pixel-sharded recurrences, the batch-stats norms and the losses
    read it.  ``None`` leaves the ambient mesh as it is."""
    if mesh is None:
        yield
        return
    before = getattr(_ambient, "mesh", None)
    _ambient.mesh = mesh
    try:
        yield
    finally:
        _ambient.mesh = before


def current_mesh() -> Optional[DeviceMesh]:
    return getattr(_ambient, "mesh", None)


def data_axis():
    """(group, size) of the ambient mesh's 'data' axis, or None without a
    mesh or with one 'data' rank (nothing to reduce)."""
    mesh = current_mesh()
    if mesh is None or data_size(mesh) == 1:
        return None
    return mesh.get_group("data"), data_size(mesh)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the incoming gradients over the
    same group (every rank's loss depends on the sum), through this
    function again, so that a gradient taken with ``create_graph`` (the
    GP/DRAGAN penalties) differentiates once more, as JAX's psum does."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ambient mesh's 'data' ranks, differentiably;
    ``x`` itself without a data axis."""
    axis = data_axis()
    return x if axis is None else _AllReduceSum.apply(x, axis[0])


def shard_mean(x: torch.Tensor) -> torch.Tensor:
    """This shard's share of the global batch's mean: the mean over the
    shard divided by the number of 'data' ranks (shards are equal), so the
    shares sum to the global mean; ``torch.mean(x)`` without a data
    axis."""
    axis = data_axis()
    mean = torch.mean(x)
    return mean if axis is None else mean / axis[1]


def count_once(x: torch.Tensor) -> torch.Tensor:
    """A term of the replicated parameters (weight decay), counted on the
    first 'data' rank only, so that the summed gradients and metrics hold
    it once."""
    mesh = current_mesh()
    if mesh is None or data_index(mesh) == 0:
        return x
    return torch.zeros_like(x)


def rank_device(device, mesh: Optional[DeviceMesh]) -> torch.device:
    """The device of this rank: ``cuda`` without an index becomes
    ``cuda:<local rank % devices>`` under a mesh (``LOCAL_RANK``, else the
    rank; every rank on ``cuda:0`` on a one-card host); anything else is
    kept."""
    device = torch.device(device)
    if mesh is None or device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", _local_cuda_index())


def _local_cuda_index() -> int:
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return local % torch.cuda.device_count()
