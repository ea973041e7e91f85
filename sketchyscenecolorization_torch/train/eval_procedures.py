"""Validation / test / inference procedures
(``sketchyscenecolorization_tpu/train/eval_procedures.py``; reference
``obj_lib/main_procedure.py:245-621``, ``bg_colorization_main.py:834-892``,
``matching_main.py:420-488``).

The PNG-dump loops the reference uses in place of an automated test suite;
PIL writes RGB.  The FG loops give each item one noise row: by default
from a ``torch.Generator`` seeded by ``seed``; given ``noise`` [items,
noise_dim], row k goes to the k-th item, so a caller can feed the rows
that JAX draws from its ``PRNGKey`` chain (JAX
``train/eval_procedures.py:47-56,98,163-185``) and get JAX's images.  The
matching evaluation is ``train/harness.py:eval_matching``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from ..config import BGGanConfig, FGGanConfig
from ..data.fg_records import preprocess_pair, read_record_shard
from ..data.fixtures import load_sketch_image
from ..pipeline.compositing import (resize_and_padding_mask_image,
                                    thicken_drawings)
from ..text import colorization_encode
from ..utils.visualization import visualize_sem_seg


def _to_uint8(x: np.ndarray) -> np.ndarray:
    return (((x + 1.0) / 2.0) * 255.0).astype(np.uint8)


def _noise_rows(cfg: FGGanConfig, seed: int,
                noise: Optional[np.ndarray] = None):
    """The items' noise rows in order, each [1, noise_dim]: the rows of
    ``noise`` when it is given, else normal rows from one generator
    seeded by ``seed``."""
    if noise is not None:
        for row in np.array(noise, np.float32):
            yield row[None]
        raise ValueError("more items than rows of noise")
    rng = torch.Generator().manual_seed(seed)
    while True:
        yield torch.randn(1, cfg.noise_dim, generator=rng).numpy()


def _generate(gen, device, sketch: np.ndarray, tokens, class_id: int,
              noise: np.ndarray) -> np.ndarray:
    """One [-1, 1] sketch [S, S, 3] -> the generator's [S, S, 3] output."""
    with torch.no_grad():
        out = gen(torch.from_numpy(np.ascontiguousarray(
                      sketch[None], np.float32)).to(device),
                  torch.tensor(np.asarray(tokens)[None], dtype=torch.long,
                               device=device),
                  torch.tensor([class_id], dtype=torch.long, device=device),
                  torch.from_numpy(np.asarray(noise, np.float32)).to(device))
    return out[0].cpu().numpy()


def fg_validation(cfg: FGGanConfig, gen, shard_paths: Sequence[str],
                  results_dir: str, seed: int = 0,
                  max_items: Optional[int] = None, device="cuda",
                  noise: Optional[np.ndarray] = None) -> int:
    """Dump (input, output, target) PNG triplets over record shards
    (``main_procedure.validation``); ``gen`` is the FG generator,
    ``noise`` the items' rows (module docstring).  Returns the number of
    items written."""
    gen = gen.to(device).eval()
    rows = _noise_rows(cfg, seed, noise)
    out_dir = os.path.join(results_dir,
                           "with_text" if cfg.lstm_hybrid else "without_text")
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for path in shard_paths:
        rec = read_record_shard(path)
        category = os.path.splitext(os.path.basename(path))[0]
        for i in range(len(rec["cartoons"])):
            img, sk = preprocess_pair(rec["cartoons"][i], rec["sketches"][i],
                                      cfg.image_size, cfg.distance_map)
            out = _generate(gen, device, sk,
                            rec["text_indices"][i].astype(np.int64),
                            int(rec["category_ids"][i]), next(rows))
            stem = f"{category}_{str(rec['names'][i])[:-4]}"
            Image.fromarray(_to_uint8(out)).save(
                os.path.join(out_dir, stem + "_output.png"))
            Image.fromarray(_to_uint8(img)).save(
                os.path.join(out_dir, stem + "_target.png"))
            Image.fromarray(_to_uint8(sk)).save(
                os.path.join(out_dir, stem + "_input.png"))
            count += 1
            if max_items and count >= max_items:
                return count
    return count


def _load_fg_sketch(path: str, size: int, category: str) -> np.ndarray:
    """Resize+pad a wild sketch to the training size (road gets no
    margin), uint8."""
    image = Image.open(path).convert("RGB")
    if image.width != size or image.height != size:
        margin = 0 if category == "road" else 10
        return resize_and_padding_mask_image(image, size, margin_size=margin)
    return np.array(image, dtype=np.uint8)


def fg_inference(cfg: FGGanConfig, gen, sketch_path: str, category: str,
                 categories: Sequence[str], instruction: str,
                 vocab: Dict[str, int], results_dir: str, seed: int = 0,
                 device="cuda", noise: Optional[np.ndarray] = None) -> str:
    """Single wild-image colorization (``main_procedure.inference``):
    resize+pad, [-1, 1], generator forward, PNG.  An unknown category falls
    back to ``categories[2]``, as in the reference.  ``noise``: its one
    row [1, noise_dim] (JAX draws ``normal(PRNGKey(seed))``)."""
    gen = gen.to(device).eval()
    os.makedirs(results_dir, exist_ok=True)
    if category not in categories:
        category = categories[2]
    sketch = _load_fg_sketch(sketch_path, cfg.image_size, category)
    x = sketch.astype(np.float32) / 255.0 * 2.0 - 1.0
    tokens = colorization_encode(instruction, vocab, cfg.max_len)
    out = _generate(gen, device, x, tokens, categories.index(category),
                    next(_noise_rows(cfg, seed, noise)))
    out_path = os.path.join(
        results_dir, os.path.basename(sketch_path)[:-4] + "_output.png")
    Image.fromarray(_to_uint8(out)).save(out_path)
    return out_path


def bg_test(cfg: BGGanConfig, engine, dataset, results_dir: str,
            max_items: Optional[int] = None) -> int:
    """BG test loop (``bg_colorization_main.py:834-892``): per entry, run the
    generator, write input/output/target PNGs, then paste the FG back over
    the output by the inner mask (mask == 0 is FG); ``engine`` is a
    ``BGColorizeEngine``."""
    from ..data.bg_dataset import load_image
    os.makedirs(results_dir, exist_ok=True)
    count = 0
    for entry in dataset.entries:
        inputs = load_image(os.path.join(dataset.inputs_base_dir,
                                         entry["fg_name"]), cfg.image_size)[0]
        targets = load_image(os.path.join(dataset.targets_base_dir,
                                          entry["bg_name"]),
                             cfg.image_size)[0]
        out, _ = engine.colorize(inputs, entry["color_text"])
        stem = entry["bg_name"][:-4]
        Image.fromarray(inputs).save(os.path.join(results_dir,
                                                  stem + "-inputs.png"))
        Image.fromarray(targets).save(os.path.join(results_dir,
                                                   stem + "-targets.png"))
        mask_path = os.path.join(dataset.segment_base_dir, entry["fg_name"])
        if os.path.isfile(mask_path):
            inner = np.array(Image.open(mask_path).convert("RGB"),
                             dtype=np.uint8)[:, :, 0]
            out = out.copy()
            out[inner == 0] = inputs[inner == 0]
        Image.fromarray(out).save(os.path.join(results_dir,
                                               stem + "-outputs.png"))
        count += 1
        if max_items and count >= max_items:
            break
    return count


def fg_test(cfg: FGGanConfig, gen, data_base_dir: str, results_dir: str,
            vocab: Dict[str, int], seed: int = 0,
            max_items: Optional[int] = None, device="cuda",
            noise: Optional[np.ndarray] = None) -> int:
    """FG test mode (``main_procedure.test`` :361-492): per category,
    iterate ``captions/<cat>/test.json``, load
    ``images/<cat>/sketch/<key>``, resize+pad, thicken house and road
    drawings, encode the caption, forward, save the output and input;
    ``noise`` the items' rows (module docstring)."""
    gen = gen.to(device).eval()
    rows = _noise_rows(cfg, seed, noise)
    os.makedirs(results_dir, exist_ok=True)
    cap_base = os.path.join(data_base_dir, "captions")
    categories = sorted(d for d in os.listdir(cap_base)
                        if os.path.isdir(os.path.join(cap_base, d)))
    count = 0
    for class_id, cate in enumerate(categories):
        with open(os.path.join(cap_base, cate, "test.json")) as f:
            entries = json.load(f)
        for e in entries:
            sketch = _load_fg_sketch(os.path.join(
                data_base_dir, "images", cate, "sketch", e["key"]),
                cfg.image_size, cate)
            if cate in ("house", "road"):     # main_procedure.py:443-444
                sketch = thicken_drawings(sketch)
            x = sketch.astype(np.float32) / 255.0 * 2.0 - 1.0
            tokens = colorization_encode(e["color_text"], vocab, cfg.max_len)
            out = _generate(gen, device, x, tokens, class_id, next(rows))
            stem = f"{cate}_{e['key'][:-4]}"
            Image.fromarray(_to_uint8(out)).save(
                os.path.join(results_dir, stem + "_output.png"))
            Image.fromarray(_to_uint8(x)).save(
                os.path.join(results_dir, stem + "_input.png"))
            count += 1
            if max_items and count >= max_items:
                return count
    return count


def matching_inference(engine, sketch_path: str, instruction: str,
                       results_dir: str, image_size: int = 768) -> str:
    """``matching_main.inference`` (JAX ``eval_procedures.py:199-209``):
    predict the mask of ``instruction`` on the sketch and save its overlay
    as ``<results_dir>/<sketch name>_pred.png``."""
    os.makedirs(results_dir, exist_ok=True)
    sketch = load_sketch_image(sketch_path, dtype=np.uint8, size=image_size)
    predicts = engine.predict_mask(sketch, instruction)
    out_path = os.path.join(
        results_dir, os.path.basename(sketch_path)[:-4] + "_pred.png")
    visualize_sem_seg(sketch, predicts, instruction, out_path)
    return out_path
