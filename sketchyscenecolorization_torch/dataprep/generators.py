"""Offline dataset generators (reference ``data_preparation`` tools).
Copy of ``sketchyscenecolorization_tpu/dataprep/generators.py`` on the
port's own ``data``, ``text`` and ``utils.visualization``.

- ``matching_data_generation``: SketchyScene GT -> sentence_instance_<split>.json
  (``Instance_Matching/data_preparation/matching_data_generation.py:25-129``);
- ``vocabulary_generation``: caption token harvest -> vocab file
  (``vocabulary_generation.py:13-69``);
- ``fg_data_preparation``: per-category caption/image dirs -> npz record
  shards (the TPU build's TFRecord replacement;
  ``Foreground_Instance_Colorization/data_preparation/data_preparation.py:35-116``);
- ``bg_data_generation``: user paints -> composited backgrounds + sky/ground
  segment maps + N color augmentations + split JSONs
  (``Background_Colorization/data_preparation/bg_data_generation.py:60-181``).
"""
from __future__ import annotations

import json
import os
import random
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from ..data.matching_dataset import load_data_gt
from ..text import colorization_encode, load_vocab
from .caption_engine import INSTANCE, SceneDescriber, init_all_items

_SPLIT_RE = re.compile(r"(\W+)")

SPLIT_IMAGE_COUNTS = {"train": 5617, "val": 535, "test": 1113}

# BG color augmentation palettes (``bg_data_generation.py:10-15``)
SKY_COLOR = ["blue", "green", "cyan", "red", "orange", "yellow", "brown",
             "purple", "pink", "black", "gray"]
GROUND_COLOR = ["yellow", "green", "black", "gray", "brown"]
BG_COLOR_MAP = {"blue": [153, 217, 234], "green": [181, 230, 29],
                "cyan": [128, 255, 215], "red": [237, 28, 36],
                "orange": [255, 127, 39], "yellow": [255, 242, 0],
                "brown": [185, 122, 87], "purple": [163, 73, 164],
                "pink": [255, 174, 201], "black": [30, 30, 30],
                "gray": [127, 127, 127]}


def matching_data_generation(data_base_dir: str, splits: Sequence[str],
                             categories46: Sequence[str],
                             save_dir: Optional[str] = None,
                             image_counts: Optional[Dict[str, int]] = None,
                             verbose: bool = False) -> Dict[str, list]:
    """For each split: load GT, skip scenes with any invalid category, run
    the caption engine, collect {key, sen_instIdx_map} entries."""
    image_counts = image_counts or SPLIT_IMAGE_COUNTS
    categories_map = {i + 1: name for i, name in enumerate(categories46)}
    results = {}
    for split in splits:
        split_dir = os.path.join(data_base_dir, split)
        summary = []
        excluded = 0
        for i in range(image_counts[split]):
            image_id = i + 1
            _, gt_class_ids, gt_bboxes, _ = load_data_gt(split_dir, image_id)
            if any(categories_map[int(c)] not in INSTANCE
                   for c in gt_class_ids):
                excluded += 1
                continue
            items = init_all_items(gt_bboxes.tolist(), gt_class_ids.tolist(),
                                   categories_map)
            caption, _, sen_map = SceneDescriber(items).get_text()
            sentences = [s.strip() for s in caption.split(".")[:-1]]
            assert len(sentences) == len(sen_map)
            sen_inst_idx_map = {}
            for sen, ids in zip(sentences, sen_map):
                assert -1 not in ids
                sen_inst_idx_map[sen] = ids
            if sen_inst_idx_map:
                summary.append({"key": image_id,
                                "sen_instIdx_map": sen_inst_idx_map})
            if verbose:
                print(f"{split} {image_id}: {len(sen_inst_idx_map)} sentences")
        results[split] = summary
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            with open(os.path.join(save_dir,
                                   f"sentence_instance_{split}.json"), "w") as f:
                json.dump(summary, f, indent=4)
        if verbose:
            print(f"{split}: excluded {excluded} scenes")
    return results


def vocabulary_generation(caption_json_paths: Sequence[str],
                          save_path: Optional[str] = None) -> List[str]:
    """Collect caption tokens in first-seen order; vocab = <pad>, <unk>,
    then words ('-' tokens dropped)."""
    vocab: List[str] = []
    seen = set()
    for path in caption_json_paths:
        with open(path) as f:
            data = json.load(f)
        for entry in data:
            for caption in entry["sen_instIdx_map"]:
                words = [w.lower() for w in _SPLIT_RE.split(caption.strip())
                         if len(w.strip()) > 0 and w != "-"]
                for w in words:
                    if w not in seen:
                        seen.add(w)
                        vocab.append(w)
    out = ["<pad>", "<unk>"] + vocab
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        with open(save_path, "w") as f:
            f.write("\n".join(out) + "\n")
    return out


def fg_data_preparation(data_base_dir: str, splits: Sequence[str],
                        text_len: int = 15, out_subdir: str = "records"
                        ) -> List[str]:
    """Per (split, category): read captions/<cat>/<split>.json + cartoon &
    edgemap PNGs, encode captions (front-padded), write one npz record shard
    per category (category_id = sorted-dir index, like the reference)."""
    from ..data.fg_records import write_record_shard

    caption_base = os.path.join(data_base_dir, "captions")
    image_base = os.path.join(data_base_dir, "images")
    categories = sorted(d for d in os.listdir(caption_base)
                        if os.path.isdir(os.path.join(caption_base, d)))
    vocab = load_vocab(os.path.join(data_base_dir, "vocab.txt"))

    written = []
    for split in splits:
        out_dir = os.path.join(data_base_dir, out_subdir, split)
        os.makedirs(out_dir, exist_ok=True)
        for category_id, category in enumerate(categories):
            with open(os.path.join(caption_base, category,
                                   f"{split}.json")) as f:
                entries = json.load(f)
            names, cartoons, sketches, texts, indices = [], [], [], [], []
            for e in entries:
                name = e["key"]
                cartoon = np.array(Image.open(os.path.join(
                    image_base, category, "cartoon", name)).convert("RGB"),
                    dtype=np.uint8)
                sketch = np.array(Image.open(os.path.join(
                    image_base, category, "edgemap", name)).convert("RGB"),
                    dtype=np.uint8)
                names.append(name)
                cartoons.append(cartoon)
                sketches.append(sketch)
                texts.append(e["color_text"])
                indices.append(colorization_encode(e["color_text"], vocab,
                                                   text_len))
            path = os.path.join(out_dir, f"{category}.npz")
            if names:
                cartoons_arr = np.stack(cartoons)
                sketches_arr = np.stack(sketches)
                indices_arr = np.asarray(indices, np.uint8)
            else:  # empty split for this category -> empty shard (like the
                   # reference's empty TFRecord)
                cartoons_arr = np.zeros((0, 384, 384, 3), np.uint8)
                sketches_arr = np.zeros((0, 384, 384, 3), np.uint8)
                indices_arr = np.zeros((0, text_len), np.uint8)
            write_record_shard(path, names, cartoons_arr, sketches_arr,
                               category,
                               np.full((len(names),), category_id, np.int32),
                               texts, indices_arr)
            written.append(path)
    return written


def _random_color_pair(former: List[Tuple[str, str]],
                       rng: random.Random) -> Tuple[str, str]:
    while True:
        sky = SKY_COLOR[rng.randint(0, len(SKY_COLOR) - 1)]
        ground = GROUND_COLOR[rng.randint(0, len(GROUND_COLOR) - 1)]
        if sky != ground and (sky, ground) not in former:
            return sky, ground


def bg_caption(sky: str, ground: str) -> str:
    return f"the sky is {sky} and the ground is {ground}"


def verify_bg_blue_green(bg_img: np.ndarray, mask: np.ndarray) -> bool:
    """Deterministic version of the reference's sampled
    ``is_bg_color_blue_and_green`` check: it fails only when a top-row bg
    sample is NOT blue while the bottom-row sample IS green (its retry
    condition, ``bg_data_generation.py:28-37``); anything else passes."""
    blue = np.array(BG_COLOR_MAP["blue"])
    green = np.array(BG_COLOR_MAP["green"])
    top = bg_img[0][mask[0] == 255]
    bottom = bg_img[-1][mask[-1] == 255]
    top_has_blue = len(top) > 0 and bool((top == blue).all(axis=1).any())
    bottom_has_green = (len(bottom) > 0
                        and bool((bottom == green).all(axis=1).any()))
    return not (not top_has_blue and bottom_has_green)


def bg_data_generation(data_base_dir: str, aug_num: int = 3,
                       splits: Sequence[str] = ("train", "test"),
                       seed: int = 0) -> Dict[str, list]:
    """Composite user paints with foregrounds, emit segment maps (sky=128
    where blue, ground=255 where green), and ``aug_num`` random
    (sky, ground) recolorings per image, plus split JSONs."""
    rng = random.Random(seed)
    results = {}
    for split in splits:
        paint_dir = os.path.join(data_base_dir, "user_paint", split)
        fg_dir = os.path.join(data_base_dir, "foreground", split)
        mask_dir = os.path.join(data_base_dir, "inner_mask", split)
        bg_out = os.path.join(data_base_dir, "background", split)
        seg_out = os.path.join(data_base_dir, "segment", split)
        cap_out = os.path.join(data_base_dir, "captions")
        for d in (bg_out, seg_out, cap_out):
            os.makedirs(d, exist_ok=True)

        summary = []
        for file_name in sorted(os.listdir(paint_dir)):
            paint = np.array(Image.open(os.path.join(paint_dir, file_name))
                             .convert("RGB"), dtype=np.uint8)
            fg = np.array(Image.open(os.path.join(fg_dir, file_name))
                          .convert("RGB"), dtype=np.uint8)
            mask = np.array(Image.open(os.path.join(mask_dir, file_name))
                            .convert("RGB"), dtype=np.uint8)[:, :, 0]

            bg_proc = paint.copy()
            bg_proc[mask == 0] = fg[mask == 0]     # remove line across the fg
            Image.fromarray(bg_proc, "RGB").save(
                os.path.join(bg_out, file_name), "PNG")
            assert verify_bg_blue_green(bg_proc, mask)

            blue = (bg_proc == np.array(BG_COLOR_MAP["blue"])).all(axis=2)
            green = (bg_proc == np.array(BG_COLOR_MAP["green"])).all(axis=2)
            is_bg = mask == 255
            segment = np.zeros(mask.shape, np.uint8)
            segment[np.logical_and(is_bg, blue)] = 128
            segment[np.logical_and(is_bg, green)] = 255
            Image.fromarray(segment, "L").save(
                os.path.join(seg_out, file_name), "PNG")

            former = [("blue", "green")]
            summary.append({"fg_name": file_name, "bg_name": file_name,
                            "color_text": bg_caption("blue", "green")})

            for aug_i in range(aug_num):
                sky, ground = _random_color_pair(former, rng)
                former.append((sky, ground))
                aug = bg_proc.copy()
                aug[np.logical_and(is_bg, blue)] = BG_COLOR_MAP[sky]
                aug[np.logical_and(is_bg, green)] = BG_COLOR_MAP[ground]
                aug_name = file_name[:-4] + f"_{aug_i + 1}.png"
                Image.fromarray(aug, "RGB").save(
                    os.path.join(bg_out, aug_name), "PNG")
                summary.append({"fg_name": file_name, "bg_name": aug_name,
                                "color_text": bg_caption(sky, ground)})

        with open(os.path.join(cap_out, f"{split}.json"), "w") as f:
            json.dump(summary, f, indent=4)
        results[split] = summary
    return results


def matching_data_visualization(data_base_dir: str, split: str,
                                caption_json_path: str, out_dir: str,
                                max_images: Optional[int] = None) -> int:
    """Render each GT (sentence -> instance set) pair as a red overlay PNG
    (reference ``matching_data_visualization.py:15-103``).  Returns the
    number of images written."""
    from ..data.matching_dataset import load_data_gt
    from ..utils.visualization import visualize_sem_seg

    with open(caption_json_path) as f:
        data = json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    written = 0
    for entry in data:
        img_idx = entry["key"]
        sketch, _, _, gt_masks = load_data_gt(
            os.path.join(data_base_dir, split), img_idx)
        sketch_u8 = sketch.astype(np.uint8)
        for s_i, (sentence, inst_indices) in enumerate(
                entry["sen_instIdx_map"].items()):
            union = np.zeros(gt_masks.shape[:2], np.int32)
            for idx in inst_indices:
                union = np.logical_or(union, gt_masks[:, :, idx])
            visualize_sem_seg(
                sketch_u8.copy(), union, sentence,
                os.path.join(out_dir, f"{img_idx}_{s_i}.png"))
            written += 1
        if max_images and written >= max_images:
            break
    return written
