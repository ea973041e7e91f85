"""Plain PyTorch and NumPy reference of the measured system (no import of
the program or of JAX).  ``build`` makes a reference model with the run's
seeded weights; the same tensors are loaded into the program.

A kind outside ``MODELS`` is the module ``reference/<kind>.py``, which
names its model class ``MODEL`` and its seed stream ``STREAM``; a stream
separates one model's weights from another's in a run, so it is none of
``MODELS``' streams."""
from __future__ import annotations

import importlib

from .bg_gan import ResidualGenerator
from .fg_gan import MRUGenerator
from .init import Init, materialize
from .rmi import RMI

MODELS = {"matching": (RMI, 0), "fg_gan": (MRUGenerator, 1),
          "bg_gan": (ResidualGenerator, 2)}


def model_of(kind: str):
    """(model class, seed stream) of ``kind``."""
    if kind in MODELS:
        return MODELS[kind]
    module = importlib.import_module(f"{__name__}.{kind}")
    if module.STREAM in {s for _, s in MODELS.values()}:
        raise ValueError(f"benchmark/reference/{kind}.py: STREAM "
                         f"{module.STREAM} is taken by another kind")
    return module.MODEL, module.STREAM


def build(kind: str, sizes: dict, seed: int, device="cuda"):
    """(reference model with its weights on ``device``, state dict)."""
    cls, stream = model_of(kind)
    init = Init()
    model = cls(sizes, init)
    state = materialize(model, init, seed, device, stream)
    return model, state


def skeleton(kind: str, sizes: dict):
    """The reference model on the meta device (shapes only)."""
    cls, _ = model_of(kind)
    return cls(sizes, Init())
