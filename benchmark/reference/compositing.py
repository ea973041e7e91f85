"""The reference system's host compositing chain, NumPy and PIL only
(``Pipeline_utils/fg_color_utils.py``, ``obj_lib/input_pipeline.py``,
``Pipeline_utils/bg_utils.py``): an instance's GAN input (crop, white-bg
mask image, aspect-preserving resize with a margin, pad; grass thickened),
the generated instance's reverse resize (PIL bilinear) and paste through
the inner mask, the (+1, +1) stroke overlay, the FG extraction of a BG
pass and the HSV sky gradient in float64.
"""
from __future__ import annotations

import numpy as np
import scipy.ndimage
from PIL import Image

ROAD_LABEL = 36
GRASS_LABEL = 27
# 46-category ids of SketchyScene -> the FG GAN's 25 classes
SKE_ID_TO_CAT_ID = {
    7: 0, 9: 1, 12: 2, 13: 3, 14: 4, 15: 5, 16: 6, 17: 7, 18: 8, 19: 9,
    22: 10, 23: 11, 27: 12, 28: 13, 29: 14, 30: 15, 32: 16, 34: 17, 35: 18,
    36: 19, 37: 20, 39: 21, 41: 22, 43: 23, 44: 24,
}
LANCZOS = Image.LANCZOS


def resize_and_pad(image: Image.Image, new_size: int, margin: int = 10
                   ) -> np.ndarray:
    height, width = image.height + 2 * margin, image.width + 2 * margin
    scale = new_size / max(height, width)
    new_h = int(round(image.height * scale))
    new_w = int(round(image.width * scale))
    if scale != 1:
        image = image.resize((new_w, new_h), resample=LANCZOS)
    img = np.array(image, dtype=np.uint8)[:, :, 0]
    top, left = (new_size - new_h) // 2, (new_size - new_w) // 2
    img = np.pad(img, [(top, new_size - new_h - top),
                       (left, new_size - new_w - left)],
                 mode="constant", constant_values=255)
    return np.repeat(img[:, :, None], 3, axis=2)


def thicken(image: np.ndarray) -> np.ndarray:
    inv = 255 - np.array(image[:, :, 0], dtype=np.uint8)
    dil = scipy.ndimage.maximum_filter(inv, footprint=np.ones((2, 2), bool),
                                       mode="constant", origin=-1)
    return np.repeat((255 - dil)[:, :, None], 3, axis=2)


def gan_input(mask_full: np.ndarray, box, class_id46: int,
              size: int) -> np.ndarray:
    """[-1, 1] float32 [S, S, 3] GAN input of one instance."""
    y1, x1, y2, x2 = (int(b) for b in box)
    inst = mask_full[y1:y2, x1:x2]
    img = np.full((inst.shape[0], inst.shape[1], 3), 255, np.uint8)
    img[inst == 1] = 0
    pil = Image.fromarray(img, "RGB")
    if pil.width != size or pil.height != size:
        sketch = resize_and_pad(pil, size,
                                0 if class_id46 == ROAD_LABEL else 10)
    else:
        sketch = np.array(pil, dtype=np.uint8)
    if class_id46 == GRASS_LABEL:
        sketch = thicken(sketch)
    return sketch.astype(np.float32) / 255.0 * 2.0 - 1.0


def reverse_resize(gen_u8: np.ndarray, box_h: int, box_w: int,
                   margin: int = 10) -> np.ndarray:
    ori = gen_u8.shape[0]
    hm, wm = box_h + 2 * margin, box_w + 2 * margin
    if hm > wm:
        pad = int(round(ori * (hm - wm) / hm / 2.0))
        cut = gen_u8[:, pad:ori - pad]
    else:
        pad = int(round(ori * (wm - hm) / wm / 2.0))
        cut = gen_u8[pad:ori - pad, :]
    out = np.array(Image.fromarray(cut.astype(np.uint8)).resize(
        (wm, hm), resample=Image.BILINEAR), dtype=np.uint8)
    return out[margin:margin + box_h, margin:margin + box_w]


def paste(canvas: np.ndarray, gen_u8: np.ndarray, inner: np.ndarray,
          inst_idx: int, box, class_id46: int) -> None:
    y1, x1, y2, x2 = (int(b) for b in box)
    color = reverse_resize(gen_u8, y2 - y1, x2 - x1,
                           0 if class_id46 == ROAD_LABEL else 10)
    region = canvas[y1:y2, x1:x2]
    sel = inner[y1:y2, x1:x2] == inst_idx + 1
    region[sel] = color[sel]


def stroke_overlay(sketch: np.ndarray, inner: np.ndarray, class_ids):
    """(moved, region): the sketch shifted by (+1, +1) and the stroke
    pixels outside grass instances."""
    no_grass = np.zeros(inner.shape, bool)
    for i, c in enumerate(class_ids):
        if c == GRASS_LABEL:
            no_grass |= inner == i + 1
    moved = sketch.copy()
    moved[1:, 1:] = sketch[:-1, :-1]
    return moved, (moved[:, :, 0] == 0) & ~no_grass


def rgb2hsv(rgb):
    rgb = np.asarray(rgb, np.float64)
    out = np.zeros_like(rgb)
    v = rgb.max(axis=-1)
    delta = v - rgb.min(axis=-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        s = np.where(v > 0, delta / v, 0.0)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        h = np.where(v == r, (g - b) / delta,
                     np.where(v == g, 2.0 + (b - r) / delta,
                              4.0 + (r - g) / delta))
    h = np.where(delta == 0, 0.0, (h / 6.0) % 1.0)
    out[..., 0], out[..., 1], out[..., 2] = h, np.nan_to_num(s), v
    return out


def hsv2rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    out = np.zeros(hsv.shape, np.float64)
    for k, (rr, gg, bb) in enumerate([(v, t, p), (q, v, p), (p, v, t),
                                      (p, q, v), (t, p, v), (v, p, q)]):
        m = i == k
        out[..., 0][m], out[..., 1][m], out[..., 2][m] = rr[m], gg[m], bb[m]
    return out


def detect_sky(img_bg: np.ndarray, inner: np.ndarray, band_from=5, band_h=2):
    """Dominant colour of the band over non-FG pixels (ties: first seen),
    then the lowest row <= H/2 holding it."""
    band = img_bg[band_from:band_from + band_h].reshape(-1, 3)
    ok = (inner[band_from:band_from + band_h] == 0).reshape(-1)
    counts, order = {}, []
    for rgb, keep in zip(map(tuple, band.tolist()), ok.tolist()):
        if keep:
            if rgb not in counts:
                counts[rgb] = 0
                order.append(rgb)
            counts[rgb] += 1
    sky = list(order[int(np.argmax([counts[c] for c in order]))])
    target = np.array(sky, np.uint8)
    for i in range(int(img_bg.shape[0] / 2), -1, -1):
        if (img_bg[i] == target).all(axis=1).any():
            return sky, i
    return sky, -1


def color_gradient(color_image: np.ndarray, inner: np.ndarray) -> np.ndarray:
    """The HSV sky gradient of a BG result (``bg_utils.py:96-166``)."""
    img_bg = np.full(color_image.shape, 255, np.uint8)
    img_bg[inner == 0] = color_image[inner == 0]
    sky, bottom = detect_sky(img_bg, inner)
    if bottom == -1:
        raise ValueError("no sky bottom")
    start = int(bottom / 4 * 3)
    sky_hsv = rgb2hsv((np.array(sky, np.float32) / 255.0)[None, None])[0][0]
    end_s, end_v = sky_hsv[1] / 3.0, min(1.0, sky_hsv[2] * 1.5)
    hsv = rgb2hsv(img_bg / 255.0)
    if start > 0:
        rows = np.arange(start, -1, -1)
        frac = (start - rows) / start
        hsv[rows, :, 1] = (frac * end_s + (1 - frac) * sky_hsv[1])[:, None]
        hsv[rows, :, 2] = (frac * end_v + (1 - frac) * sky_hsv[2])[:, None]
    else:
        hsv[0, :, 1], hsv[0, :, 2] = sky_hsv[1], sky_hsv[2]
    out = (hsv2rgb(hsv) * 255.0).astype(np.uint8)
    out[inner != 0] = color_image[inner != 0]
    return out
