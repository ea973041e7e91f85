"""Snapshots in step-named directories
(``sketchyscenecolorization_tpu/utils/checkpoint.py``, with ``torch.save``
in place of orbax).

``<root>/step_<n>/state.pt`` holds one ``torch.save``d mapping of tensors
and numbers; ``latest_checkpoint`` finds the newest step for resume.  A
step directory is written under a temporary name and renamed into place,
so a run cut short never leaves a half-written snapshot behind.
``scripts/orbax_to_torch.py`` converts the JAX package's orbax snapshots
into this layout.
"""
from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import Any, List, Optional, Tuple

import torch

_STEP_RE = re.compile(r"^step_(\d+)$")
STATE_FILE = "state.pt"


def _step_dir(root: str, step: int) -> str:
    return os.path.join(os.path.abspath(root), f"step_{step}")


def save_checkpoint(root: str, step: int, state: Any,
                    max_to_keep: Optional[int] = None) -> str:
    """Save ``state`` at <root>/step_<step>; keep the newest
    ``max_to_keep`` steps."""
    os.makedirs(root, exist_ok=True)
    path = _step_dir(root, step)
    tmp = tempfile.mkdtemp(prefix=f".step_{step}_", dir=root)
    try:
        torch.save(state, os.path.join(tmp, STATE_FILE))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if max_to_keep is not None:
        for old in list_checkpoint_steps(root)[:-max_to_keep]:
            shutil.rmtree(_step_dir(root, old), ignore_errors=True)
    return path


def list_checkpoint_steps(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_RE.match,
                                                os.listdir(root)) if m)


def latest_checkpoint(root: str) -> Optional[Tuple[int, str]]:
    """(step, path) of the newest snapshot, or None."""
    steps = list_checkpoint_steps(root)
    if not steps:
        return None
    return steps[-1], _step_dir(root, steps[-1])


def restore_checkpoint(path: str, map_location=None) -> Any:
    """The mapping saved at ``path`` (tensors and numbers only)."""
    return torch.load(os.path.join(path, STATE_FILE),
                      map_location=map_location, weights_only=True)
