"""Matching-mask visualization (reference
``Instance_Matching/utils/visualization_util.py``).  Copy of
``sketchyscenecolorization_tpu/utils/visualization.py`` (the port imports
nothing of the JAX package); NumPy and PIL only, headless: red-channel
semantic overlays, instance overlays with evenly spaced HSV colours,
dashed bounding boxes and class labels, saved straight to PNG."""
from __future__ import annotations

import colorsys
import random
from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw


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


def visualize_inst_seg(image: np.ndarray, predict_inst_seg: np.ndarray,
                       sent: str = "", save_path: str = "") -> np.ndarray:
    """[H, W, N] instance masks -> union red overlay."""
    union = np.zeros(image.shape[:2], np.int32)
    if predict_inst_seg.shape[0] != 0:
        for i in range(predict_inst_seg.shape[2]):
            union = np.logical_or(union, predict_inst_seg[:, :, i])
    return visualize_sem_seg(image, union, sent, save_path)


def generate_colors(n: int, bright: bool = True,
                    shuffle: bool = True, seed: Optional[int] = None):
    """Evenly spaced HSV hues -> RGB."""
    brightness = 1.0 if bright else 0.7
    colors = [colorsys.hsv_to_rgb(i / max(n, 1), 1, brightness)
              for i in range(n)]
    if shuffle:
        random.Random(seed).shuffle(colors)
    return colors


def _apply_mask(image: np.ndarray, mask: np.ndarray, color, alpha=1.0):
    for c in range(3):
        image[:, :, c] = np.where(
            mask == 1, image[:, :, c] * (1 - alpha) + alpha * color[c] * 255,
            image[:, :, c])
    return image


def _draw_dashed_rect(draw: ImageDraw.ImageDraw, box, color_str: str,
                      dash_gap: int = 30, dash_len: int = 20, width: int = 3):
    y1, x1, y2, x2 = (int(v) for v in box)

    def dash_line(a1, b1, a2, b2):
        length = abs(a1 - a2) + abs(b1 - b2)
        for k in range(length // dash_gap + 1):
            if a1 == a2:   # vertical
                draw.line((a1, b1 + k * dash_gap, a2,
                           min(b1 + k * dash_gap + dash_len, b2)),
                          fill=color_str, width=width)
            else:          # horizontal
                draw.line((a1 + k * dash_gap, b1,
                           min(a1 + k * dash_gap + dash_len, a2), b2),
                          fill=color_str, width=width)

    dash_line(x1, y1, x1, y2)
    dash_line(x2, y1, x2, y2)
    dash_line(x1, y1, x2, y1)
    dash_line(x1, y2, x2, y2)


def visualize_sem_inst_mask(image: np.ndarray, sem_mask: np.ndarray,
                            boxes: np.ndarray, inst_masks: np.ndarray,
                            class_ids: np.ndarray,
                            class_names: Sequence[str], sent: str = "",
                            scores: Optional[np.ndarray] = None,
                            save_path: str = "", seed: Optional[int] = 0
                            ) -> np.ndarray:
    """Side-by-side semantic overlay + instance overlay with dashed boxes
    and class labels; returns (and optionally saves) the composite image."""
    sem = semantic_overlay(image, sem_mask)

    n = boxes.shape[0]
    colors = generate_colors(n, seed=seed)
    masked = image.astype(np.uint32).copy()
    for i in range(n):
        masked = _apply_mask(masked, inst_masks[:, :, i], colors[i])
    inst_img = Image.fromarray(masked.astype(np.uint8))
    draw = ImageDraw.Draw(inst_img)
    for i in range(n):
        if not np.any(boxes[i]):
            continue
        color_str = "#" + "".join(f"{int(c * 255):02x}" for c in colors[i])
        label = class_names[int(class_ids[i])]
        caption = f"{label} {scores[i]:.3f}" if scores is not None else label
        y1, x1 = int(boxes[i][0]), int(boxes[i][1])
        draw.text((x1 + 2, y1 + 2), caption, fill="#000000")
        _draw_dashed_rect(draw, boxes[i], color_str)

    composite = np.concatenate([sem, np.array(inst_img, np.uint8)], axis=1)
    if save_path:
        Image.fromarray(composite, "RGB").save(save_path, "PNG")
    return composite
