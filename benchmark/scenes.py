"""Synthetic SketchyScene-style scenes, drawn from a seed.

A scene is a 768^2 white canvas with black strokes.  Each instance is a
closed outline (an ellipse) with a few interior strokes; its segmentation
mask is its own strokes, as SketchyScene's instance masks are, and its
inner mask is the filled outline, where the FG generator's colours are
pasted.  A ground line crosses the lower part of the canvas.  Instances
stay below the sky band (rows 5-6), which the BG sky gradient reads.

Files, in the layout the session reads (``<base>/sketches/<id>.png``,
``seg_data/<id>_datas.npz``, ``inner_masks/<id>.mat``, ``colorMapC46.mat``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import scipy.io
from PIL import Image

from .reference.compositing import SKE_ID_TO_CAT_ID

# SketchyScene's 46-category ids that the FG generator colours (road, 36,
# is left out: its instances must be two parallel lines, which these
# outlines are not), with the words a user names them by
FG_CATEGORIES = {
    7: ("bench", "benches"), 9: ("bird", "birds"), 12: ("bus", "buses"),
    13: ("butterfly", "butterflies"), 14: ("car", "cars"), 15: ("cat", "cats"),
    16: ("chair", "chairs"), 17: ("chicken", "chickens"),
    18: ("cloud", "clouds"), 19: ("cow", "cows"), 22: ("dog", "dogs"),
    23: ("duck", "ducks"), 27: ("grass", "grasses"), 28: ("horse", "horses"),
    29: ("house", "houses"), 30: ("moon", "moons"), 32: ("person", "people"),
    34: ("pig", "pigs"), 35: ("rabbit", "rabbits"), 37: ("sheep", "sheep"),
    39: ("star", "stars"), 41: ("sun", "suns"), 43: ("tree", "trees"),
    44: ("truck", "trucks"),
}
assert set(FG_CATEGORIES) <= set(SKE_ID_TO_CAT_ID)
WORD_TO_ID = {w: i for i, (w, _) in FG_CATEGORIES.items()}
TOP = 16            # instances start below this row (the sky band is 5-6)


@dataclass
class Scene:
    sketch: np.ndarray          # [S, S, 3] uint8
    inner: np.ndarray           # [S, S] uint8, 0 = background, i+1 = instance i
    masks: List[np.ndarray]     # full-size stroke masks, uint8
    boxes: np.ndarray           # [K, 4] (y1, x1, y2, x2)
    class_ids: np.ndarray       # [K] 46-category ids


def _ellipse(size, y0, x0, y1, x1):
    yy, xx = np.ogrid[:y1 + 1, :x1 + 1]
    cy, cx = (y0 + y1) / 2.0, (x0 + x1) / 2.0
    ry, rx = max((y1 - y0) / 2.0, 1.0), max((x1 - x0) / 2.0, 1.0)
    return ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2


def _segment(mask, p0, p1, width):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    ys = np.linspace(p0[0], p1[0], n).round().astype(int)
    xs = np.linspace(p0[1], p1[1], n).round().astype(int)
    for dy in range(width):
        for dx in range(width):
            mask[np.clip(ys + dy, 0, mask.shape[0] - 1),
                 np.clip(xs + dx, 0, mask.shape[1] - 1)] = 1


def draw_scene(rng: np.random.Generator, size: int, class_ids: Sequence[int],
               sides: Sequence[int]) -> Scene:
    """K instances of the given categories and box sides (pixels)."""
    k = len(class_ids)
    sketch_mask = np.zeros((size, size), np.uint8)
    inner = np.zeros((size, size), np.uint8)
    masks, boxes, taken = [], np.zeros((k, 4), np.int32), []
    width = max(1, size // 256)
    ground = int(size * (0.72 + 0.1 * rng.random()))
    sketch_mask[ground:ground + width, :] = 1
    for i, side in enumerate(sides):
        side = int(min(side, size - TOP - 4))
        h = int(side * (0.7 + 0.3 * rng.random()))
        w = side
        best = None
        for _ in range(40):                 # least overlap of 40 draws
            y0 = int(rng.integers(TOP, size - h - 2))
            x0 = int(rng.integers(2, size - w - 2))
            over = sum(max(0, min(y0 + h, b[2]) - max(y0, b[0]))
                       * max(0, min(x0 + w, b[3]) - max(x0, b[1]))
                       for b in taken)
            if best is None or over < best[0]:
                best = (over, y0, x0)
            if over == 0:
                break
        _, y0, x0 = best
        y1, x1 = y0 + h, x0 + w
        taken.append((y0, x0, y1, x1))
        win = (slice(y0, y1 + 1), slice(x0, x1 + 1))
        r = np.full((size, size), 2.0)
        r[win] = _ellipse(size, y0, x0, y1, x1)[win]
        band = 2.0 * width / max(min(h, w) / 2.0, 1.0)
        stroke = ((r <= 1.0) & (r >= (1.0 - band) ** 2)).astype(np.uint8)
        for _ in range(int(rng.integers(1, 4))):   # interior strokes
            p0 = (y0 + rng.uniform(0.25, 0.75) * h, x0 + rng.uniform(0.2, 0.8) * w)
            p1 = (y0 + rng.uniform(0.25, 0.75) * h, x0 + rng.uniform(0.2, 0.8) * w)
            _segment(stroke, p0, p1, width)
        stroke &= (r <= 1.0).astype(np.uint8)
        inner[r < 1.0] = i + 1
        sketch_mask |= stroke
        masks.append(stroke)
        ys, xs = np.nonzero(stroke)
        boxes[i] = (ys.min(), xs.min(), ys.max(), xs.max())
    sketch = np.where(sketch_mask[..., None] == 1, 0, 255).astype(np.uint8)
    sketch = np.repeat(sketch, 3, axis=2)
    return Scene(sketch, inner, masks, boxes,
                 np.asarray(class_ids, np.int32))


def color_map_names() -> List[str]:
    names = [f"category{i}" for i in range(46)]
    for i, (word, _) in FG_CATEGORIES.items():
        names[i] = word
    return names


def write_scene(base: str, name: str, scene: Scene) -> None:
    for sub in ("sketches", "seg_data", "inner_masks"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    Image.fromarray(scene.sketch).save(
        os.path.join(base, "sketches", f"{name}.png"), compress_level=1)
    small = np.empty(len(scene.masks), dtype=object)
    for i, (m, (y1, x1, y2, x2)) in enumerate(zip(scene.masks, scene.boxes)):
        small[i] = m[y1:y2 + 1, x1:x2 + 1]
    np.savez(os.path.join(base, "seg_data", f"{name}_datas.npz"),
             pred_masks=small, pred_class_ids=scene.class_ids,
             pred_boxes=scene.boxes)
    scipy.io.savemat(os.path.join(base, "inner_masks", f"{name}.mat"),
                     {"inner_masks": scene.inner}, do_compression=True)
    cmap = os.path.join(base, "colorMapC46.mat")
    if not os.path.exists(cmap):
        cm = np.empty((46, 2), dtype=object)
        for i, n in enumerate(color_map_names()):
            cm[i, 0] = np.array([n])
            cm[i, 1] = np.array([[128, 128, 128]], np.uint8)
        scipy.io.savemat(cmap, {"colorMap": cm})


def link_scene(base: str, pool_name: str, name: str) -> None:
    """Files of scene ``pool_name`` under a new image id ``name``."""
    pairs = (("sketches", ".png"), ("seg_data", "_datas.npz"),
             ("inner_masks", ".mat"))
    for sub, ext in pairs:
        os.symlink(f"{pool_name}{ext}",
                   os.path.join(base, sub, f"{name}{ext}"))

