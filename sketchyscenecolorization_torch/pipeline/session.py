"""Interactive colorization session
(``sketchyscenecolorization_tpu/pipeline/session.py``; reference
``sketchyscene_colorization_main.py:16-55``).

color (FG):  route -> RMI matching -> instance indices -> per-instance
             crop/resize/pad -> GAN forward -> un-resize -> paste via the
             inner mask -> drawing overlay -> save + record.
color (BG):  route -> merge the sky/ground text with the image's history ->
             extract the FG -> BG generator at the canvas size -> paste the
             FG back -> drawing overlay -> HSV sky gradient -> save + record.
withdraw:    delete the newest result image and truncate the record JSON.

What depends only on an image's fixtures is computed once and cached per
image (``_ImageState``): the decoded sketch, masks, prepared GAN inputs,
the shifted-drawing overlay, the matching inputs on the device and,
optionally, the backbone features.  Matching scores are cached per
instruction text.  Compositing runs on the host in NumPy/PIL (the JAX
session's ``device_compositing=False`` chain, ``session.py:813-826``).

Not ported yet: device compositing (with the BG device gradient), compact
fetch, ``colorize_stream`` and write-behind PNGs (ROADMAP A8).  Asking for
any of them raises ``NotImplementedError``.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from ..config import FrameworkConfig
from ..data.fixtures import (
    load_color_map, load_inner_mask, load_seg_data, load_sketch_image,
)
from ..data.records import fetch_records, update_records, withdraw_records
from ..text import judge_colorize_type, segment_user_input_text
from ..text.bg_text import DEFAULT_BG_TEXT, combine_bg_input_text
from . import compositing as comp
from .engines import (PIXEL_MU, BGColorizeEngine, FGColorizeEngine,
                      MatchingEngine)
from .io import write_png


def _fixture_signature(paths: Dict[str, str]) -> Tuple[int, ...]:
    return tuple(os.stat(paths[k]).st_mtime_ns
                 for k in ("sketch", "seg_data", "inner_mask"))


def _check_supported(cfg: FrameworkConfig) -> None:
    pl = cfg.pipeline
    unsupported = [name for name, on in (
        ("device_compositing", pl.device_compositing),
        ("async_png_writes", pl.async_png_writes),
        ("stage_trace", pl.stage_trace),
        ("serve_gan_data_parallel", pl.serve_gan_data_parallel > 1)) if on]
    if unsupported:
        raise NotImplementedError(
            f"pipeline options {unsupported} are not ported yet (ROADMAP "
            "A8, A13); set them off")


class _ImageState:
    """Everything about one image that does not depend on the instruction."""

    def __init__(self, paths: Dict[str, str], image_size: int, device,
                 max_instance_inputs: int = 0):
        self.max_instance_inputs = max_instance_inputs
        self.signature = _fixture_signature(paths)
        self.sketch = load_sketch_image(paths["sketch"], dtype=np.uint8,
                                        size=image_size)
        self.inner_mask = load_inner_mask(paths["inner_mask"])
        self.categories46 = load_color_map(paths["color_map"])
        self.pred_masks, self.pred_class_ids, self.pred_boxes = \
            load_seg_data(paths["seg_data"], size=image_size)
        self.grass_indices = [i for i, c in enumerate(self.pred_class_ids)
                              if c == comp.GRASS_LABEL]
        self.no_grass = comp.grass_free_inner_mask(self.inner_mask,
                                                   self.grass_indices)
        self.moved, self.drawings_region = comp.shifted_drawings(
            self.sketch, self.no_grass)

        # matching inputs, resident on the device
        image = (self.sketch.astype(np.float32) - PIXEL_MU).astype(np.float32)
        self.image_dev = torch.from_numpy(image[None]).to(device)
        self.bin_drawing_dev = torch.from_numpy(
            MatchingEngine.binarize_drawing(self.sketch).astype(np.float32)
        ).to(device)
        n = len(self.pred_class_ids)
        self.inst_masks_dev = torch.from_numpy(
            self.pred_masks.reshape(n, -1).astype(np.float32)).to(device)
        # per-instance pixel counts stay on the host (float64 division)
        self.areas_host = self.pred_masks.reshape(n, -1).sum(axis=1) \
            .astype(np.float64)
        self.visual_dev = None                  # cached backbone features
        self.match_scores: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self.instance_inputs: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self.last_result: Optional[Tuple[str, np.ndarray]] = None

    def prepared_instance(self, inst_idx: int, instance_size: int) -> np.ndarray:
        """[-1,1] float32 GAN input for one instance (crop -> white-bg mask
        image -> resize+pad -> road/grass special cases;
        ``fg_color_utils.py:282-311``), cached per instance (LRU)."""
        if inst_idx in self.instance_inputs:
            self.instance_inputs.move_to_end(inst_idx)
            return self.instance_inputs[inst_idx]
        class_id46 = int(self.pred_class_ids[inst_idx])
        y1, x1, y2, x2 = (int(b) for b in self.pred_boxes[inst_idx])
        inst_mask = self.pred_masks[inst_idx][y1:y2, x1:x2]
        mask_img = np.full((inst_mask.shape[0], inst_mask.shape[1], 3),
                           255, dtype=np.uint8)
        mask_img[inst_mask == 1] = [0, 0, 0]
        pil = Image.fromarray(mask_img, "RGB")
        if pil.width != instance_size or pil.height != instance_size:
            margin = 0 if class_id46 == comp.ROAD_LABEL else 10
            instance_sketch = comp.resize_and_padding_mask_image(
                pil, instance_size, margin_size=margin)
        else:
            instance_sketch = np.array(pil, dtype=np.uint8)

        if class_id46 == comp.ROAD_LABEL:
            if not comp.is_road_not_single_line(instance_sketch.copy()):
                raise ValueError("Road is single line")
        if class_id46 == comp.GRASS_LABEL:
            instance_sketch = comp.thicken_drawings(instance_sketch)

        x = instance_sketch.astype(np.float32) / 255.0 * 2.0 - 1.0
        self.instance_inputs[inst_idx] = x
        while 0 < self.max_instance_inputs < len(self.instance_inputs):
            self.instance_inputs.popitem(last=False)
        return x


class ColorizationSession:
    """Holds the three engines plus per-image cached state."""

    def __init__(self, cfg: FrameworkConfig, matching: MatchingEngine,
                 fg: FGColorizeEngine, bg: BGColorizeEngine):
        _check_supported(cfg)
        self.cfg = cfg
        self.matching = matching
        self.fg = fg
        self.bg = bg
        self.device = matching.device
        self._images: "OrderedDict[str, _ImageState]" = OrderedDict()
        if (cfg.pipeline.color_gradient
                and cfg.pipeline.image_size ** 2 // 2 >= comp._LUT_MIN_PIXELS):
            # the sky gradient runs at LUT scale: build the 24-bit
            # round-trip table now, off the first BG command
            comp.prewarm_roundtrip_lut()

    # ---------------------------------------------------------------- paths
    def _paths(self, image_id) -> Dict[str, str]:
        base = self.cfg.pipeline.data_base_dir
        return {
            "sketch": os.path.join(base, "sketches", f"{image_id}.png"),
            "seg_data": os.path.join(base, "seg_data", f"{image_id}_datas.npz"),
            "inner_mask": os.path.join(base, "inner_masks", f"{image_id}.mat"),
            "color_map": os.path.join(base, "colorMapC46.mat"),
        }

    def _results_dir(self, image_id) -> str:
        d = os.path.join(self.cfg.pipeline.results_base_dir, "results",
                         str(image_id))
        os.makedirs(d, exist_ok=True)
        return d

    def _state(self, image_id) -> _ImageState:
        key = str(image_id)
        paths = self._paths(image_id)
        cached = self._images.get(key)
        if cached is not None and cached.signature == _fixture_signature(paths):
            self._images.move_to_end(key)
            return cached
        last = cached.last_result if cached is not None else None
        state = _ImageState(paths, self.cfg.pipeline.image_size, self.device,
                            self.cfg.pipeline.max_cached_instance_inputs)
        state.last_result = last        # result history survives fixture edits
        self._images[key] = state
        self._images.move_to_end(key)
        max_images = self.cfg.pipeline.max_cached_images
        while 0 < max_images < len(self._images):
            self._images.popitem(last=False)
        return state

    def _load_base(self, state: _ImageState, results_dir: str,
                   last_name: str) -> np.ndarray:
        """Latest result (memory first, disk fallback), or the raw sketch."""
        if last_name == "":
            return state.sketch.copy()
        if state.last_result is not None and state.last_result[0] == last_name:
            return state.last_result[1].copy()
        return np.array(Image.open(
            os.path.join(results_dir, last_name)).convert("RGB"),
            dtype=np.uint8)

    # ----------------------------------------------------------------- API
    def colorize(self, image_id, input_text: str) -> str:
        """One 'color' command; returns the path of the new result image."""
        if not input_text:
            raise ValueError("empty instruction")
        colorization_type = judge_colorize_type(input_text)
        new_name, last_name, last_bg_text, summary = fetch_records(
            image_id, self.cfg.pipeline.results_base_dir)
        if colorization_type == "FG":
            inst_indices = self.match_instances(image_id, input_text)
            out_path = self.colorize_foreground(
                image_id, input_text, inst_indices, new_name, last_name)
            proc_bg_text = last_bg_text
        else:
            out_path, proc_bg_text = self.colorize_background(
                image_id, input_text, new_name, last_name, last_bg_text)
        update_records(image_id, input_text, self.cfg.pipeline.results_base_dir,
                       colorization_type, new_name, proc_bg_text, summary)
        return out_path

    def withdraw(self, image_id) -> None:
        withdraw_records(image_id, self.cfg.pipeline.results_base_dir)
        key = str(image_id)
        if key in self._images:
            self._images[key].last_result = None   # force a disk re-read

    # ------------------------------------------------------------- matching
    def match_instances(self, image_id, input_text: str) -> List[int]:
        """``build_instance_matching`` (``fg_matching_utils.py:14-77``)."""
        return self._match_many(self._state(image_id), [input_text])[0]

    def _match_many(self, state: _ImageState,
                    input_texts: Sequence[str]) -> List[List[int]]:
        """Matched instance indices of M instructions in one forward.  With
        ``cache_match_scores`` the per-text score vectors come from the
        image's LRU and only uncached texts run, padded to a power-of-two
        batch (pad rows repeat row 0)."""
        pl = self.cfg.pipeline
        use_cache = pl.cache_match_scores and pl.max_cached_match_texts != 0
        texts = list(input_texts)
        todo = ([t for t in dict.fromkeys(texts)
                 if t not in state.match_scores] if use_cache else texts)
        if todo:
            if pl.cache_visual_features and state.visual_dev is None:
                state.visual_dev = self.matching.extract_visual_dev(
                    state.image_dev)
            words, lens = self.matching.encode_texts(todo)
            bucket = 1
            while bucket < len(todo):
                bucket *= 2
            pad = bucket - len(todo)
            if pad:
                words = np.concatenate(
                    [words, np.repeat(words[:1], pad, axis=0)])
                lens = np.concatenate([lens, np.repeat(lens[:1], pad, axis=0)])
            scores = self.matching.score_instances(
                state.image_dev, words, lens, state.inst_masks_dev,
                state.areas_host, state.bin_drawing_dev,
                visual_dev=state.visual_dev)[:len(todo)]     # [M', N_inst]
            if not use_cache:
                keep = scores > pl.mask_occupied_threshold
                return [[int(i) for i in np.nonzero(row)[0]] for row in keep]
            for t, row in zip(todo, scores):
                state.match_scores[t] = row
            while 0 < pl.max_cached_match_texts < len(state.match_scores):
                state.match_scores.popitem(last=False)
        fresh = dict(zip(todo, scores)) if todo else {}
        out = []
        for t in texts:
            if t in state.match_scores:
                state.match_scores.move_to_end(t)
                row = state.match_scores[t]
            else:                       # evicted within this very call
                row = fresh[t]
            keep = row > pl.mask_occupied_threshold
            out.append([int(i) for i in np.nonzero(keep)[0]])
        return out

    # ------------------------------------------------------------------ FG
    def colorize_foreground(self, image_id, input_text: str,
                            inst_indices: Sequence[int], new_name: str,
                            last_name: str) -> str:
        """``build_instance_colorization`` (``fg_color_utils.py:188-363``)."""
        state = self._state(image_id)
        instance_size = self.cfg.pipeline.instance_size
        results_dir = self._results_dir(image_id)
        inst_color_text = segment_user_input_text(input_text)

        # validate and prepare every instance first: nothing is written on
        # error, as with the reference's per-instance loop
        batch, class_ids25 = [], []
        for inst_idx in inst_indices:
            class_id46 = int(state.pred_class_ids[inst_idx])
            if class_id46 not in comp.SKE_ID_TO_CAT_ID:
                raise ValueError(
                    f"Wrong matching instance: {state.categories46[class_id46]}")
            batch.append(state.prepared_instance(inst_idx, instance_size))
            class_ids25.append(comp.SKE_ID_TO_CAT_ID[class_id46])

        new_result = self._load_base(state, results_dir, last_name)
        if batch:
            generated_u8 = self.fg.colorize_batch(
                np.stack(batch), class_ids25, inst_color_text)
            for k, inst_idx in enumerate(inst_indices):
                class_id46 = int(state.pred_class_ids[inst_idx])
                bbox = state.pred_boxes[inst_idx]
                color_instance = comp.instance_result_postprocessing_u8(
                    generated_u8[k], bbox, class_id46)
                comp.paste_instance(new_result, color_instance,
                                    state.inner_mask, inst_idx, bbox)
        new_result[state.drawings_region] = state.moved[state.drawings_region]

        out_path = os.path.join(results_dir, new_name)
        write_png(out_path, new_result, self.cfg.pipeline.png_compress_level)
        state.last_result = (new_name, new_result)
        return out_path

    # ------------------------------------------------------------------ BG
    def colorize_background(self, image_id, input_text: str, new_name: str,
                            last_name: str, last_bg_text: str
                            ) -> Tuple[str, str]:
        """``build_background_colorization`` (``bg_utils.py:169-325``; JAX
        ``session.py:837-917`` with ``device_compositing=False``).  Returns
        (result path, the merged BG text the record keeps)."""
        state = self._state(image_id)
        results_dir = self._results_dir(image_id)
        if last_name == "":
            if last_bg_text != "":
                raise ValueError(f"records of image {image_id} hold a BG "
                                 "text but no result")
            last_bg_text = DEFAULT_BG_TEXT
        proc_text = combine_bg_input_text(input_text, last_bg_text)

        previous = self._load_base(state, results_dir, last_name)
        inner_mask, moved = state.inner_mask, state.moved
        drawings_region = state.drawings_region
        fg_image = comp.extract_foreground(previous, inner_mask)
        background, _ = self.bg.colorize(fg_image, proc_text,
                                         want_region=False)
        # paste the FG back, overlay the drawings (``bg_utils.py:290-310``)
        background[inner_mask != 0] = fg_image[inner_mask != 0]
        background[drawings_region] = moved[drawings_region]

        # the FG image with the overlay, saved as the reference does
        fg_image[drawings_region] = moved[drawings_region]
        level = self.cfg.pipeline.png_compress_level
        write_png(os.path.join(results_dir, f"{image_id}_fg.png"), fg_image,
                  level)

        if self.cfg.pipeline.color_gradient:
            background = comp.add_color_gradient(background, inner_mask)
            background[drawings_region] = moved[drawings_region]

        out_path = os.path.join(results_dir, new_name)
        write_png(out_path, background, level)
        state.last_result = (new_name, background)
        return out_path, proc_text
