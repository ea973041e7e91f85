"""Seeded weights, made on the device in a few large calls.

The reference modules are built on the ``meta`` device through an ``Init``,
which records how each leaf is drawn (normal, uniform or constant) in the
distributions the published models initialise with.  ``materialize`` then
draws every normal leaf from one ``torch.randn`` and every uniform leaf
from one ``torch.rand`` of a device ``torch.Generator`` seeded from the
run's seed, and returns the state dict.  The same tensors are loaded into
the measured program's models and into the reference, so the two compute
with identical weights.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn


class Init:
    """Records each leaf's distribution; leaves are meta tensors until
    ``materialize``."""

    def __init__(self):
        self.specs: Dict[int, Tuple[str, float, float]] = {}

    def _leaf(self, shape, spec) -> nn.Parameter:
        p = nn.Parameter(torch.empty(tuple(shape), device="meta"))
        self.specs[id(p)] = spec
        return p

    def normal(self, shape, std: float, mean: float = 0.0) -> nn.Parameter:
        return self._leaf(shape, ("normal", std, mean))

    def uniform(self, shape, limit: float) -> nn.Parameter:
        return self._leaf(shape, ("uniform", limit, 0.0))

    def const(self, shape, value: float) -> nn.Parameter:
        return self._leaf(shape, ("const", value, 0.0))

    def glorot(self, shape) -> nn.Parameter:
        """Glorot-uniform of a dense [in, out] kernel."""
        return self.uniform(shape, (6.0 / (shape[0] + shape[1])) ** 0.5)

    def xavier_conv(self, cout: int, cin: int, k: int) -> nn.Parameter:
        limit = (6.0 / (k * k * cin + k * k * cout)) ** 0.5
        return self.uniform((cout, cin, k, k), limit)


def materialize(module: nn.Module, init: Init, seed: int,
                device="cuda", stream: int = 0) -> Dict[str, torch.Tensor]:
    """Draw every leaf of ``module`` on ``device``; returns {name: tensor}
    and binds the tensors into ``module``.  ``stream`` separates the models
    of one run: each gets its own generator seeded from (seed, stream)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 7919 + 104729 * (stream + 1)) % (1 << 63))
    named = list(module.named_parameters())
    sizes = {"normal": 0, "uniform": 0}
    for _, p in named:
        kind = init.specs[id(p)][0]
        if kind in sizes:
            sizes[kind] += p.numel()
    pools = {
        "normal": torch.randn(sizes["normal"], generator=gen, device=device),
        "uniform": torch.rand(sizes["uniform"], generator=gen,
                              device=device) * 2.0 - 1.0,
    }
    offsets = {"normal": 0, "uniform": 0}
    state: Dict[str, torch.Tensor] = {}
    for name, p in named:
        kind, a, b = init.specs[id(p)]
        if kind == "const":
            value = torch.full(p.shape, a, device=device)
        else:
            start = offsets[kind]
            offsets[kind] += p.numel()
            flat = pools[kind][start:offsets[kind]]
            value = flat * a + b if kind == "normal" else flat * a
            value = value.reshape(p.shape)
        state[name] = value
    module.load_state_dict(state, assign=True)
    for p in module.parameters():
        p.requires_grad_(False)
    return state


def load_into(program_model: nn.Module, state: Dict[str, torch.Tensor]
              ) -> None:
    """Copy ``state`` into a model of the measured program: every leaf the
    program has must be in ``state`` under the same name and shape."""
    with torch.no_grad():
        missing, unexpected = program_model.load_state_dict(state,
                                                            strict=False)
    buffers = {n for n, _ in program_model.named_buffers()}
    missing = [m for m in missing if m not in buffers]
    if missing or unexpected:
        raise ValueError(f"weights do not fit the program's model: missing "
                         f"{missing[:5]}, unexpected {unexpected[:5]}")
