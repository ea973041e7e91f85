"""BG colorization dataset: the port's copy of
``sketchyscenecolorization_tpu/data/bg_dataset.py`` (reference
``bg_colorization_main.py:894-941`` +
``Background_Colorization/data_processing/image_processing.py``).

Split JSON entries: {fg_name, bg_name, color_text}.  Per step the reference
uniformly samples ONE entry and loads (fg composite, bg target, caption,
region mask) with PIL on the hot path; here the same sampling semantics feed
``parallel.BackgroundGenerator`` workers instead.
"""
from __future__ import annotations

import json
import os
import random
from typing import Dict

import numpy as np
from PIL import Image

from ..text import colorization_encode


def load_image(imname: str, image_size: int) -> np.ndarray:
    im = Image.open(imname).convert("RGB")
    if im.width != image_size or im.height != image_size:
        im = im.resize((image_size, image_size), resample=Image.BILINEAR)
    return np.array(im, dtype=np.uint8)[None]          # [1, H, W, 3]


def load_region_mask(seg_path: str, image_size: int,
                     is_test: bool = False) -> np.ndarray:
    """Gray PNG {0,128,255} -> labels {0(fg),1(sky),2(ground)}; zeros at
    test time (the reference's fake-backend analogue)."""
    if is_test:
        return np.zeros([1, image_size, image_size], dtype=np.int32)
    seg = np.array(Image.open(seg_path).convert("RGB"), dtype=np.uint8)[:, :, 0]
    label = np.zeros(seg.shape, dtype=np.int32)
    label[seg == 128] = 1
    label[seg == 255] = 2
    return label[None]


class BGDataset:
    """Uniform per-step sampler producing train-step batches."""

    def __init__(self, split_json_path: str, inputs_base_dir: str,
                 targets_base_dir: str, segment_base_dir: str,
                 vocab: Dict[str, int], image_size: int = 768,
                 max_len: int = 8, seed: int = 0):
        with open(split_json_path) as f:
            self.entries = json.load(f)
        self.inputs_base_dir = inputs_base_dir
        self.targets_base_dir = targets_base_dir
        self.segment_base_dir = segment_base_dir
        self.vocab = vocab
        self.image_size = image_size
        self.max_len = max_len
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.entries)

    def make_batch(self, step: int) -> Dict[str, np.ndarray]:
        e = self.entries[self._rng.randrange(len(self.entries))]
        inputs = load_image(os.path.join(self.inputs_base_dir, e["fg_name"]),
                            self.image_size)
        targets = load_image(os.path.join(self.targets_base_dir, e["bg_name"]),
                             self.image_size)
        tokens = colorization_encode(e["color_text"], self.vocab, self.max_len)
        labels = load_region_mask(
            os.path.join(self.segment_base_dir, e["fg_name"]), self.image_size)
        to_pm1 = lambda x: x.astype(np.float32) / 255.0 * 2.0 - 1.0
        return {
            "inputs": to_pm1(inputs),
            "targets": to_pm1(targets),
            "tokens": np.asarray(tokens, np.int32)[None],
            "labels": labels,
        }
