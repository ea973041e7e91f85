"""The optimizer arithmetic of the trainers, as optax computes it
(``optax.adam``, ``optax.clip_by_global_norm`` and the FG GAN's per-tensor
clip, JAX ``train/fg_gan.py:78-92``), over dicts of named tensors.

Adam's moments live in an ``AdamState`` that the train state owns and
snapshots.  The learning rate of an update is the schedule at the count
before it; optax keeps eps outside the square root.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdamState:
    mu: Tensors                   # first and second moments, keyed by
    nu: Tensors                   # parameter name
    count: int = 0                # updates applied so far

    @classmethod
    def zeros(cls, params: Mapping[str, torch.Tensor]) -> "AdamState":
        return cls(mu={n: torch.zeros_like(p) for n, p in params.items()},
                   nu={n: torch.zeros_like(p) for n, p in params.items()})

    def state_dict(self) -> Dict:
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    def load_state_dict(self, saved: Mapping) -> None:
        for ours, theirs in ((self.mu, saved["mu"]), (self.nu, saved["nu"])):
            if sorted(ours) != sorted(theirs):
                raise ValueError("snapshot holds other leaves: "
                                 f"{sorted(set(theirs) ^ set(ours))[:8]}")
            for name, value in theirs.items():
                ours[name].copy_(value)
        self.count = int(saved["count"])


def adam_update(params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                state: AdamState, lr: float, b1: float, b2: float,
                eps: float = 1e-8) -> None:
    """One ``optax.scale_by_adam`` + ``scale_by_learning_rate`` update of
    ``params`` in place; ``lr`` is the schedule's value at
    ``state.count``."""
    count = np.float32(state.count + 1)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** count)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** count)
    with torch.no_grad():
        for name, g in grads.items():
            mu, nu = state.mu[name], state.nu[name]
            mu.copy_((1.0 - b1) * g + b1 * mu)
            nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            params[name].add_(update * (-lr))
    state.count += 1


def grads_of(loss: torch.Tensor, params: Mapping[str, torch.Tensor]
             ) -> Tensors:
    """d loss / d params; a parameter the loss does not reach gets zeros,
    as ``jax.grad`` gives it."""
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), grads)}


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))


def clip_by_global_norm(grads: Mapping[str, torch.Tensor],
                        max_norm: float) -> Tensors:
    """``optax.clip_by_global_norm``: t when the global norm is below
    ``max_norm``, else t / norm * max_norm (``clip_grad_norm_`` divides by
    norm + 1e-6 instead).  No host sync."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return {n: torch.where(keep, g, g / norm * max_norm)
            for n, g in grads.items()}


def clip_by_tensor_norm(grads: Mapping[str, torch.Tensor],
                        max_norm: float) -> Tensors:
    """``tf.clip_by_norm`` per gradient tensor (``graph_single.py:199-207``;
    JAX ``_per_tensor_clip``)."""
    out = {}
    for n, g in grads.items():
        norm = torch.sqrt(torch.sum(g * g))
        out[n] = g * torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12),
                                     1.0)
    return out
