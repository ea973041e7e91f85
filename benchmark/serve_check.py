"""The output check of the serving cells.

For a sample of scene visits drawn from the seed (with the scene of the
most instances in it), the plain reference recomputes what the timed
commands produced, from the same scene files, texts, noise rows and
weights:

- ``logits_gap``: the matcher's ``up`` logits of every FG command, widest
  gap over the largest reference logit;
- ``fg_rows_gap``: the FG generator's float rows of the matched instances,
  widest gap (values in [-1, 1]);
- ``bg_rows_gap``: the BG generator's float output, widest gap;
- ``canvas_mismatch``: pixels of the written PNGs that differ from the
  reference's compositing (PIL reverse resize, inner-mask paste, stroke
  overlay; for BG the FG paste-back, the overlay and the float64 HSV sky
  gradient) of the program's own generator outputs, quantized as the
  program quantizes them.  Compositing is exact, so its limit is 0.  It
  follows the program's generator outputs step by step: the generator
  stages are checked on their own by the two gaps above;
- ``selection_misses``: FG commands of the whole window (not only the
  sample) whose matched instances are not all of their scene's.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
from PIL import Image

from . import reference
from .reference import compositing as comp
from .reference import ops
from .reference import text as rtext

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
PIXEL_MU = np.array((104.00698793, 116.66876762, 122.67891434))


def vocab(name: str) -> Dict[str, int]:
    return rtext.load_vocab(os.path.join(BENCH_DIR, "data", name))


def sample_visits(plan, seed: int, n: int, window: int) -> List[int]:
    """Indices of ``n`` visits among the first ``window`` of the plan:
    the first visit to the scene with the most instances, and the rest
    drawn from the seed."""
    ks = [plan.pool[v.pool].k for v in plan.visits[:window]]
    first_big = int(np.argmax(ks))
    rng = np.random.default_rng([seed, 17])
    rest = [int(i) for i in rng.permutation(window) if i != first_big]
    return sorted([first_big] + rest[:n - 1])


def quantize_fg(rows: np.ndarray) -> np.ndarray:
    return (((rows + np.float32(1.0)) / np.float32(2.0))
            * np.float32(255.0)).astype(np.uint8)


def quantize_bg(out: np.ndarray) -> np.ndarray:
    x = (out + np.float32(1.0)) / np.float32(2.0) * np.float32(255.5)
    return np.clip(x, 0, 255).astype(np.uint8)


class Reference:
    """The reference models of one configuration with the run's weights."""

    def __init__(self, fw: dict, seed: int, device, kinds=("matching",
                                                           "fg_gan", "bg_gan")):
        self.fw, self.device = fw, device
        self.models = {k: reference.build(k, fw[k], seed, device)[0]
                       for k in kinds}
        self.mv, self.fv, self.bv = (vocab("match_vocab.txt"),
                                     vocab("fg_vocab.txt"),
                                     vocab("bg_vocab.txt"))

    @torch.no_grad()
    def visual(self, sketch: np.ndarray):
        image = (sketch.astype(np.float32) - PIXEL_MU).astype(np.float32)
        return self.models["matching"].visual(
            torch.from_numpy(image[None]).to(self.device))

    @torch.no_grad()
    def logits(self, visual, text: str) -> np.ndarray:
        m = self.fw["matching"]
        words, n = rtext.matching_encode(text, self.mv, m["max_len"])
        out = self.models["matching"].fuse(
            visual, torch.tensor([words], device=self.device),
            torch.tensor([n], device=self.device))
        return out.up[0, ..., 0].float().cpu().numpy()

    @torch.no_grad()
    def fg_rows(self, scene, matched, text, noise) -> np.ndarray:
        f = self.fw["fg_gan"]
        size = self.fw["pipeline"]["instance_size"]
        x = np.stack([comp.gan_input(scene.masks[i], scene.boxes[i],
                                     int(scene.class_ids[i]), size)
                      for i in matched])
        tokens = rtext.colorization_encode(rtext.fg_color_text(text),
                                           self.fv, f["max_len"])
        labels = [comp.SKE_ID_TO_CAT_ID[int(scene.class_ids[i])]
                  for i in matched]
        dev = self.device
        out = self.models["fg_gan"](
            torch.from_numpy(x).to(dev),
            torch.tensor([tokens] * len(matched), device=dev),
            torch.tensor(labels, device=dev),
            torch.from_numpy(noise).to(dev))
        return out.float().cpu().numpy()

    @torch.no_grad()
    def bg_rgb(self, base: np.ndarray, inner: np.ndarray, text: str
               ) -> np.ndarray:
        b = self.fw["bg_gan"]
        fg = np.where((inner != 0)[..., None], base, 255).astype(np.uint8)
        x = fg.astype(np.float32) / np.float32(255.0) * np.float32(2.0) \
            - np.float32(1.0)
        tokens = rtext.colorization_encode(text, self.bv, b["max_len"])
        out, _ = self.models["bg_gan"](
            torch.from_numpy(x[None]).to(self.device),
            torch.tensor([tokens], device=self.device))
        return out[0].float().cpu().numpy()


def _gap(got: np.ndarray, want: np.ndarray, relative: bool) -> float:
    gap = float(np.max(np.abs(got.astype(np.float64) - want)))
    if relative:
        gap /= max(float(np.max(np.abs(want))), 1e-30)
    return gap


def replay_visit(ref: Reference, scene, entries: List[dict], pl: dict,
                 program: Optional[list] = None, precision="float32"
                 ) -> Dict[str, float]:
    """Replay one visit's commands through the reference; returns the
    widest gaps and the PNG mismatch of the visit.  ``program`` lists, per
    entry, outputs standing in for the program's (the control); by default
    each entry's captured outputs are used.  An entry is a ``colorize``
    (one text), a ``colorize_stream`` queue (its texts, its passes chained)
    or a ``withdraw``."""
    out = {"logits_gap": 0.0, "fg_rows_gap": 0.0, "bg_rows_gap": 0.0,
           "canvas_mismatch": 0, "compared_pngs": 0, "selection_misses": 0}
    moved, region = comp.stroke_overlay(scene.sketch, scene.inner,
                                        scene.class_ids)
    masks = np.stack(scene.masks).reshape(len(scene.masks), -1)
    areas = masks.sum(axis=1)
    bin_drawing = (scene.sketch[:, :, 0] == 0).reshape(-1)
    visual = None
    stack = []            # (path, reference canvas, BG text of the record)
    for i, e in enumerate(entries):
        got = program[i] if program is not None else e
        if e["kind"] == "withdraw":
            stack.pop()
            continue
        fg_texts = [t for t in e["texts"] if rtext.is_fg(t)]
        rows_ref, matched_all = [], []
        for j, text in enumerate(fg_texts):
            if visual is None:
                with ops.precision(precision):
                    visual = ref.visual(scene.sketch)
            with ops.precision(precision):
                up = ref.logits(visual, text)
            # a matcher run that was not seen counts as the widest gap
            seen = "up" in got and len(got["up"]) > j
            out["logits_gap"] = max(out["logits_gap"], _gap(
                got["up"][j], up, True) if seen else 1.0)
            occ = (masks @ ((up.reshape(-1) >= pl["score_thresh"])
                            & bin_drawing).astype(np.float64)) \
                / np.maximum(areas, 1)
            matched = [int(m) for m in np.nonzero(
                occ > pl["mask_occupied_threshold"])[0]]
            matched_all.append(matched)
            noise = None if got.get("noise") is None else \
                _rows(got["noise"], matched_all, len(matched))
            if matched and noise is not None and len(noise) == len(matched):
                with ops.precision(precision):
                    rows_ref.append(ref.fg_rows(scene, matched, text, noise))
            elif matched:
                rows_ref = None         # the program drew other rows
                break
        if fg_texts:
            want = np.concatenate(rows_ref) if rows_ref else None
            if rows_ref is None:
                out["selection_misses"] += 1
            have = got.get("fg")
            program_matched = got.get("matched")
            if program_matched is not None:       # colorize: one text
                out["selection_misses"] += program_matched != matched_all[0]
            n_rows = 0 if have is None else len(have)
            if want is not None and n_rows != len(want):
                out["selection_misses"] += 1      # a queue: rows per pass
            elif want is not None:
                out["fg_rows_gap"] = max(out["fg_rows_gap"],
                                         _gap(have, want, False))
        u8 = None if e.get("fg") is None else quantize_fg(e["fg"])
        off = 0
        for j, text in enumerate(e["texts"]):
            path = e["paths"][j] if j < len(e.get("paths", [])) else ""
            base = stack[-1][1] if stack else scene.sketch
            bg_text = stack[-1][2] if stack else ""
            if rtext.is_fg(text):
                idx = fg_texts.index(text)
                matched = (e["matched"] if e.get("matched") is not None
                           else matched_all[idx] if idx < len(matched_all)
                           else [])
                canvas = base.copy()
                if u8 is not None:
                    for row, m in zip(u8[off:off + len(matched)], matched):
                        comp.paste(canvas, row, scene.inner, m,
                                   scene.boxes[m], int(scene.class_ids[m]))
                off += len(matched)
                canvas[region] = moved[region]
                stack.append((path, canvas, bg_text))
                continue
            merged = rtext.merge_bg_text(text,
                                         bg_text or rtext.DEFAULT_BG_TEXT)
            with ops.precision(precision):
                rgb = ref.bg_rgb(base, scene.inner, merged)
            out["bg_rows_gap"] = max(out["bg_rows_gap"],
                                     _gap(got["bg"], rgb, False)
                                     if "bg" in got else 1.0)
            canvas = base          # (the control writes no canvas)
            if e.get("bg") is not None:
                inner3 = (scene.inner != 0)[..., None]
                bg = np.where(inner3, base, quantize_bg(e["bg"]))
                bg[region] = moved[region]
                canvas = comp.color_gradient(bg, scene.inner)
                canvas[region] = moved[region]
            stack.append((path, canvas, merged))
    for path, canvas, _ in stack:
        if path and os.path.exists(path):
            png = np.array(Image.open(path).convert("RGB"), np.uint8)
            out["canvas_mismatch"] += int(np.any(png != canvas, axis=-1).sum())
            out["compared_pngs"] += 1
    return out


def _rows(noise, matched_all, k):
    """The noise rows of the latest text: the generator draws them in the
    order of the texts' matched instances."""
    start = sum(len(m) for m in matched_all[:-1])
    return noise[start:start + k]


def checks(results: List[Dict[str, float]], misses: int, limits: dict,
           kinds) -> List[dict]:
    """The compared numbers beside their limits."""
    def worst(key):
        return max((r[key] for r in results), default=0.0)
    names = (["selection_misses", "logits_gap", "fg_rows_gap"]
             if "fg" in kinds else []) + \
        (["bg_rows_gap"] if "bg" in kinds else []) + ["canvas_mismatch"]
    values = {"selection_misses": misses + sum(r["selection_misses"]
                                                for r in results),
              "canvas_mismatch": sum(r["canvas_mismatch"] for r in results)}
    out = []
    for name in names:
        value = values[name] if name in values else worst(name)
        out.append({"name": name, "value": value, "limit": limits[name]})
    return out


def passed(checks_: List[dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks_)
