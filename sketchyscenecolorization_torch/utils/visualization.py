"""Matching-mask visualization: the semantic overlay of
``sketchyscenecolorization_tpu/utils/visualization.py:17-31`` (reference
``Instance_Matching/utils/visualization_util.py``), copied so that the port
imports nothing of the JAX package.  NumPy and PIL only."""
from __future__ import annotations

import numpy as np
from PIL import Image


def semantic_overlay(image: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Add 250 to the red channel wherever the binary mask is set (the
    reference's intentionally wrapping uint8 add)."""
    out = image.copy()
    out[:, :, 0] = out[:, :, 0] + mask.astype(np.uint8) * 250
    return out.astype(np.uint8)


def visualize_sem_seg(image: np.ndarray, predicts: np.ndarray, sent: str = "",
                      save_path: str = "") -> np.ndarray:
    out = semantic_overlay(image, predicts)
    if save_path:
        Image.fromarray(out, "RGB").save(save_path, "PNG")
    return out
