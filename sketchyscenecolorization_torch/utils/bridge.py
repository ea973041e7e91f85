"""Weight bridge between the JAX package's parameter trees and the port's
modules.

The port's modules name their submodules and parameters after the JAX
trees' keys: the functional dicts of ``models/deeplab.py`` and
``models/rmi.py:84-127``, and the flax ``params`` trees of ``MRUGenerator``
and the BG generators.  A leaf at ``a/b/c`` in a tree is the entry
``a.b.c`` of the module's ``state_dict``.  Every 4-D leaf is a conv kernel,
HWIO in JAX.  Here it is OIHW, unless the module that owns it names
another layout in a ``FROM_HWIO`` attribute (the transposed conv's
``[in, out, kh, kw]``).  The owner decides, not the shape: a transposed
conv with as many inputs as outputs has the same shape either way.

Trees arrive as nested mappings of NumPy arrays (``jax.tree.map(np.asarray,
tree)`` on the JAX side), so this module needs no jax.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

_HWIO_TO_OIHW = (3, 2, 0, 1)


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    """Nested mapping -> {"a/b/c": leaf}."""
    flat: Dict[str, Any] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, path + "/"))
        else:
            flat[path] = value
    return flat


def _from_hwio(module: nn.Module, key: str):
    """The permutation from a JAX kernel to the 4-D leaf ``key``."""
    owner = module.get_submodule(key.rpartition(".")[0])
    return getattr(owner, "FROM_HWIO", _HWIO_TO_OIHW)


def load_jax_tree(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a JAX parameter tree into ``module`` in place.  Raises
    ``ValueError`` on a missing or extra leaf or a shape mismatch."""
    flat = flatten_tree(tree)
    state = module.state_dict()
    want = {k.replace(".", "/"): k for k in state}
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"tree does not match {type(module).__name__}: "
                         f"missing {missing[:8]}, extra {extra[:8]} "
                         f"({len(missing)} missing, {len(extra)} extra)")
    new_state = {}
    for path, key in want.items():
        arr = np.asarray(flat[path], dtype=np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(_from_hwio(module, key))
        if tuple(arr.shape) != tuple(state[key].shape):
            raise ValueError(f"{path}: shape {arr.shape} (after layout "
                             f"change) != {tuple(state[key].shape)}")
        new_state[key] = torch.tensor(arr)
    module.load_state_dict(new_state, strict=True)
    return module


def export_jax_tree(module: nn.Module) -> Dict[str, Any]:
    """Inverse of ``load_jax_tree``: nested dict of NumPy arrays in the JAX
    package's layout."""
    tree: Dict[str, Any] = {}
    for key, value in module.state_dict().items():
        arr = value.detach().cpu().numpy()
        if arr.ndim == 4:
            arr = arr.transpose(np.argsort(_from_hwio(module, key)))
        *parents, leaf = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree
