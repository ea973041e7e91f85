"""Plain PyTorch and NumPy reference of the measured system (no import of
the program or of JAX).  ``build`` makes a reference model with the run's
seeded weights; the same tensors are loaded into the program."""
from __future__ import annotations

from .bg_gan import ResidualGenerator
from .fg_gan import MRUGenerator
from .init import Init, materialize
from .rmi import RMI

MODELS = {"matching": (RMI, 0), "fg_gan": (MRUGenerator, 1),
          "bg_gan": (ResidualGenerator, 2)}


def build(kind: str, sizes: dict, seed: int, device="cuda"):
    """(reference model with its weights on ``device``, state dict)."""
    cls, stream = MODELS[kind]
    init = Init()
    model = cls(sizes, init)
    state = materialize(model, init, seed, device, stream)
    return model, state


def skeleton(kind: str, sizes: dict):
    """The reference model on the meta device (shapes only)."""
    cls, _ = MODELS[kind]
    return cls(sizes, Init())

