"""Weight bridge between the JAX package's parameter trees and the port's
modules.

The port's modules name their submodules and parameters after the JAX
trees' keys: the functional dicts of ``models/deeplab.py``,
``models/backbones.py``, ``models/rmi.py:84-127`` and
``models/inception_v4.py`` (the slim scope paths; the heads' 2-D
``weights`` are ``[fan_in, n]`` on both sides), and the flax ``params``
trees of the FG generators and discriminators (MRU and the variants) and
the BG generators.  A leaf at ``a/b/c`` in a tree is the entry
``a.b.c`` of the module's ``state_dict``.  Every 4-D leaf is a conv kernel,
HWIO in JAX.  Here it is OIHW, unless the module that owns it names
another layout in a ``FROM_HWIO`` attribute (the transposed conv's
``[in, out, kh, kw]``, a depthwise conv's ``[C, 1, kh, kw]``), or lists the
leaf in ``NHWC_LEAVES`` (a learnable NHWC state, kept as it is).  The owner
decides, not the shape: a transposed conv with as many inputs as outputs
has the same shape either way.

The flax ``sn`` collection (the spectral-norm vectors of the FG
discriminator) maps 1:1 onto the module's buffers, the only buffers the
port's modules keep: ``load_jax_tree(module, params, sn=...)`` loads both,
``export_jax_tree(module, "sn")`` gives it back.

Trees arrive as nested mappings of NumPy arrays (``jax.tree.map(np.asarray,
tree)`` on the JAX side), so this module needs no jax.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Optional

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
    """The permutation from a JAX kernel to the 4-D leaf ``key``; a leaf
    that its owner lists in ``NHWC_LEAVES`` (a learnable activation, such
    as the MRU cells' initial states) keeps its layout."""
    path, _, leaf = key.rpartition(".")
    owner = module.get_submodule(path)
    if leaf in getattr(owner, "NHWC_LEAVES", ()):
        return (0, 1, 2, 3)
    return getattr(owner, "FROM_HWIO", _HWIO_TO_OIHW)


def _collection_keys(module: nn.Module, collection: str):
    buffers = {k for k, _ in module.named_buffers()}
    if collection == "sn":
        return buffers
    if collection == "params":
        return set(module.state_dict()) - buffers
    raise ValueError(f"unknown collection {collection!r}")


def _load_collection(module: nn.Module, tree: Mapping, collection: str,
                     state: Dict[str, torch.Tensor]) -> None:
    flat = flatten_tree(tree)
    want = {k.replace(".", "/"): k for k in _collection_keys(module,
                                                             collection)}
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"{collection} tree does not match "
                         f"{type(module).__name__}: missing {missing[:8]}, "
                         f"extra {extra[:8]} ({len(missing)} missing, "
                         f"{len(extra)} extra)")
    for path, key in want.items():
        arr = np.asarray(flat[path], dtype=np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(_from_hwio(module, key))
        if tuple(arr.shape) != tuple(state[key].shape):
            raise ValueError(f"{path}: shape {arr.shape} (after layout "
                             f"change) != {tuple(state[key].shape)}")
        state[key] = torch.tensor(arr)


def load_jax_tree(module: nn.Module, tree: Mapping,
                  sn: Optional[Mapping] = None) -> nn.Module:
    """Copy a JAX parameter tree (and, given ``sn``, the flax ``sn``
    collection) into ``module`` in place; without ``sn`` the module keeps
    its spectral-norm vectors.  Raises ``ValueError`` on a missing or extra
    leaf or a shape mismatch."""
    state = dict(module.state_dict())
    _load_collection(module, tree, "params", state)
    if sn is not None:
        _load_collection(module, sn, "sn", state)
    module.load_state_dict(state, strict=True)
    return module


def export_jax_tree(module: nn.Module,
                    collection: str = "params") -> Dict[str, Any]:
    """Inverse of ``load_jax_tree``: the ``params`` (or ``sn``) collection
    as a nested dict of NumPy arrays in the JAX package's layout."""
    keys = _collection_keys(module, collection)
    tree: Dict[str, Any] = {}
    for key, value in module.state_dict().items():
        if key not in keys:
            continue
        arr = value.detach().cpu().numpy()
        if arr.ndim == 4:
            arr = arr.transpose(np.argsort(_from_hwio(module, key)))
        *parents, leaf = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.array(arr, order="C")    # keeps 0-d leaves 0-d
    return tree
