"""FG colorization paired records: npz-shard storage + host preprocessing.
The port's copy of ``sketchyscenecolorization_tpu/data/fg_records.py``.

Replaces the reference's per-category TFRecords + queue runners
(``obj_lib/input_pipeline.py:44-181``, schema :59-69) with one ``.npz``
shard per category holding {names, cartoons [N,384,384,3] u8, sketches
[N,384,384,3] u8, category_ids [N], color_texts, text_indices [N,15] u8}.

Per-sample preprocessing matches ``get_paired_input`` (:71-116): optional
EDT distance map of the binarized sketch (scipy on the host, like the
reference's ``tf.py_func``), BILINEAR image / AREA sketch resize to the
training size, min-max normalization + 1/256 dequantization noise for the
image, /255 for the sketch, then [-1, 1].  NHWC, the port's layout (the
reference transposes to NCHW for cuDNN).
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import scipy.ndimage
from PIL import Image

from .im_ops import _resize_float

RAW_SIZE = 384
TEXT_LEN = 15


def write_record_shard(path: str, names: Sequence[str],
                       cartoons: np.ndarray, sketches: np.ndarray,
                       category: str, category_ids: np.ndarray,
                       color_texts: Sequence[str],
                       text_indices: np.ndarray) -> None:
    if cartoons.shape[1:] != (RAW_SIZE, RAW_SIZE, 3):
        raise ValueError(f"cartoons {cartoons.shape}: expected "
                         f"[N, {RAW_SIZE}, {RAW_SIZE}, 3]")
    if text_indices.ndim != 2:         # [N, text_len] (reference uses 15)
        raise ValueError(f"text_indices {text_indices.shape}: expected 2-D")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path, names=np.asarray(names), cartoons=cartoons.astype(np.uint8),
        sketches=sketches.astype(np.uint8), category=category,
        category_ids=category_ids.astype(np.int32),
        color_texts=np.asarray(color_texts),
        text_indices=text_indices.astype(np.uint8))


def read_record_shard(path: str) -> Dict[str, np.ndarray]:
    z = np.load(path, allow_pickle=True)
    return {k: z[k] for k in
            ("names", "cartoons", "sketches", "category_ids",
             "color_texts", "text_indices")}


def _binarize(sketch: np.ndarray, threshold: float = 250.0) -> np.ndarray:
    return np.where(sketch < threshold, 0.0, 255.0)


def _resize(img: np.ndarray, size: int, method) -> np.ndarray:
    return _resize_float(img, size, size, method)


def preprocess_image(cartoon_u8: np.ndarray, img_size: int,
                     rng: Optional[np.random.RandomState] = None
                     ) -> np.ndarray:
    """Cartoon-only preprocessing (used alone for the D batch, whose sketch
    would be discarded)."""
    image = cartoon_u8.astype(np.float32)
    if image.shape[0] != img_size:
        image = _resize(image, img_size, Image.BILINEAR)
    lo, hi = image.min(), image.max()
    image = (image - lo) / (hi - lo + 1.0)
    if rng is not None:
        image = image + rng.uniform(0.0, 1.0 / 256, image.shape).astype(np.float32)
    return image * 2.0 - 1.0


def preprocess_pair(cartoon_u8: np.ndarray, sketch_u8: np.ndarray,
                    img_size: int, distance_map: bool = False,
                    rng: Optional[np.random.RandomState] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """One (image, sketch) pair -> float32 [-1,1] NHWC at img_size."""
    sketch = sketch_u8.astype(np.float32)
    if distance_map:
        sketch = _binarize(sketch)
        sketch = scipy.ndimage.distance_transform_edt(sketch).astype(np.float32)
        sketch = sketch / max(sketch.max(), 1e-6) * 255.0
    if sketch.shape[0] != img_size:
        sketch = _resize(sketch, img_size, Image.BOX)   # AREA == box filter
    image = preprocess_image(cartoon_u8, img_size, rng)
    sketch = sketch / 255.0
    return image, sketch * 2.0 - 1.0


class FGPairedDataset:
    """Shuffled sampler over record shards, producing train-step batches
    (replaces ``build_input_queue_paired``)."""

    def __init__(self, shard_paths: Sequence[str], batch_size: int,
                 img_size: int, distance_map: bool = False, seed: int = 0):
        self.batch_size = batch_size
        self.img_size = img_size
        self.distance_map = distance_map
        self._rng = np.random.RandomState(seed)
        self._lock = threading.Lock()     # make_batch runs on worker threads
        shards = [read_record_shard(p) for p in shard_paths]
        self.cartoons = np.concatenate([s["cartoons"] for s in shards])
        self.sketches = np.concatenate([s["sketches"] for s in shards])
        self.category_ids = np.concatenate([s["category_ids"] for s in shards])
        self.text_indices = np.concatenate(
            [s["text_indices"].astype(np.int32) for s in shards])
        self.n = len(self.cartoons)

    def make_batch(self, step: int) -> Dict[str, np.ndarray]:
        # one lock around all shared-RandomState draws: make_batch is called
        # from multiple BackgroundGenerator worker threads
        with self._lock:
            idx = self._rng.randint(0, self.n, size=self.batch_size)
            idx_d = self._rng.randint(0, self.n, size=self.batch_size)
            noise = [self._rng.randint(0, 1 << 31)
                     for _ in range(2 * self.batch_size)]
        images, sketches = [], []
        for k, i in enumerate(idx):
            img, sk = preprocess_pair(self.cartoons[i], self.sketches[i],
                                      self.img_size, self.distance_map,
                                      np.random.RandomState(noise[k]))
            images.append(img)
            sketches.append(sk)
        images_d = []
        for k, i in enumerate(idx_d):
            images_d.append(preprocess_image(
                self.cartoons[i], self.img_size,
                np.random.RandomState(noise[self.batch_size + k])))
        return {
            "images": np.stack(images).astype(np.float32),
            "sketches": np.stack(sketches).astype(np.float32),
            "images_d": np.stack(images_d).astype(np.float32),
            "class_id": self.category_ids[idx].astype(np.int32),
            "class_id_d": self.category_ids[idx_d].astype(np.int32),
            "tokens": self.text_indices[idx],
        }
