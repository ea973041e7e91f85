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

Serving design, as in the JAX session:

- the three models live on the device for the whole session;
- what depends only on an image's fixtures is computed once and cached per
  image (``_ImageState``): the decoded sketch, masks, prepared GAN inputs
  (also as device rows), the shifted-drawing overlay, the matching inputs
  on the device and, optionally, the backbone features; matching scores
  are cached per instruction text;
- with ``PipelineConfig.device_compositing`` (the default) the FG
  reverse-resize, paste and overlay run on the device
  (``device_compositing.DeviceCompositor``), the BG pass composites on the
  device canvas, and the canvas stays on the device from pass to pass;
  with ``compact_fetch`` a FG pass fetches only its changed pixels and the
  host canvas is rebuilt byte-exactly (``_reconstruct``); with
  ``device_color_gradient`` at LUT scale the sky detection and the LUT
  round-trip run on the device and only the ramp rows take the host's
  float64 math;
- ``colorize_stream`` serves a queue of instructions with one matching
  forward and one generator batch per FG run (segmented by
  ``stream_segment_rows``);
- the latest result per image is kept in memory, so PNG writes can be
  write-behind (``async_png_writes``) without changing what a later read
  sees;
- with ``stage_trace`` the session's ``utils.tracing.Tracer`` records a
  root span per public call (``cmd:fg``, ``cmd:bg``, ``cmd:stream``,
  ``cmd:withdraw``) and a span per serving stage inside it, the PNG
  workers' included, with request ids and counters (``trace_events``);
- ``fused_gan_compositing`` is accepted and has no effect: in JAX it
  fuses the generator and the compositing into one device program, and
  eager PyTorch has no program boundary to remove.

Device to host copies (``_LazyFetch``) go into pinned memory with a CUDA
event recorded after them, and a reader waits on that event, never on a
half-written buffer.  Every device canvas is a new tensor: nothing writes
into a canvas a pending copy, PNG write or cached base still holds.

All of this is output-preserving: results and records match the host
chain (``device_compositing=False``) byte for byte, and a stream matches
sequential commands up to the generator's batch-size-dependent reduction
order (the JAX session's bucket caveat, ``session.py:38-51``): a stream
batches a FG run's rows into one bucket where sequential commands run one
bucket per pass (``tests/test_torch_serving.py``).

Memory is bounded: the per-image cache is an LRU
(``max_cached_images``), and each image's prepared-instance caches are
capped (``max_cached_instance_inputs``).
"""
from __future__ import annotations

import dataclasses
import os
import threading
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from ..config import FrameworkConfig
from ..data.fixtures import (
    get_pred_instance_mask, load_color_map, load_inner_mask, load_seg_data,
    load_sketch_image,
)
from ..data.records import fetch_records, update_records, withdraw_records
from ..text import judge_colorize_type, segment_user_input_text
from ..text.bg_text import DEFAULT_BG_TEXT, combine_bg_input_text
from ..utils.tracing import NO_SPAN, Span, Tracer, command, span
from . import compositing as comp
from .device_compositing import DeviceCompositor
from .engines import (PIXEL_MU, BGColorizeEngine, FGColorizeEngine,
                      MatchingEngine)
from .io import AsyncPngWriter, count_png, write_png


def _fixture_signature(paths: Dict[str, str]) -> Tuple[int, ...]:
    return tuple(os.stat(paths[k]).st_mtime_ns
                 for k in ("sketch", "seg_data", "inner_mask"))


class _LazyFetch:
    """A device tensor and its host copy (JAX ``session.py:91-123``).  On a
    CUDA tensor the copy starts at construction, into pinned memory, with
    an event recorded after it on the current stream; ``get`` waits on that
    event, so a reader (the main thread or a PNG worker) never sees a
    half-copied buffer.  The canvas is never written after it is handed
    here, so the copy holds the pass's bytes however many passes run
    before it is read.  The host array is shared: the PNG worker and the
    next pass's host read use the one copy (``__array__`` makes
    ``np.asarray`` transparent)."""
    __slots__ = ("dev", "_np", "_host", "_event", "_lock")

    def __init__(self, dev: torch.Tensor):
        self.dev = dev
        self._np: Optional[np.ndarray] = None
        self._host: Optional[torch.Tensor] = None
        self._event = None
        self._lock = threading.Lock()
        if dev.device.type == "cuda":
            self._host = torch.empty(dev.shape, dtype=dev.dtype,
                                     pin_memory=True)
            self._host.copy_(dev, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    def get(self) -> np.ndarray:
        if self._np is None:
            with self._lock:
                if self._np is None:
                    if self._event is not None:
                        self._event.synchronize()
                        self._np = self._host.numpy()
                    else:
                        self._np = self.dev.numpy()
        return self._np

    def __array__(self, dtype=None, copy=None):   # np.asarray(_LazyFetch)
        arr = self.get()
        if dtype is not None and dtype != arr.dtype:
            return arr.astype(dtype)              # astype always copies
        # the cached buffer is shared with the PNG worker and next-pass
        # host reads, so copy=True must not hand out a mutable alias
        return arr.copy() if copy else arr


class _ImageState:
    """Everything about one image that does not depend on the instruction."""

    def __init__(self, paths: Dict[str, str], image_size: int, device,
                 max_instance_inputs: int = 0):
        self.device = device
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
        self.instance_rows_dev: "OrderedDict[int, torch.Tensor]" = \
            OrderedDict()
        self.last_result: Optional[Tuple[str, Any]] = None  # (name, img)
        # device compositing: the device mirror of last_result and the
        # per-image compositor
        self.last_result_dev: Optional[Tuple[str, torch.Tensor]] = None
        self.compositor: Optional[DeviceCompositor] = None
        self._overlay_flat = None               # (flat idx, uint8 values)

    def overlay_flat(self):
        """(flat pixel indices, uint8 values) of the stroke overlay: the
        constant host half of compact-fetch reconstruction."""
        if self._overlay_flat is None:
            idx = np.flatnonzero(self.drawings_region)
            self._overlay_flat = (idx, self.moved.reshape(-1, 3)[idx])
        return self._overlay_flat

    def get_compositor(self) -> DeviceCompositor:
        if self.compositor is None:
            self.compositor = DeviceCompositor(
                self.inner_mask, self.moved, self.drawings_region,
                self.pred_boxes, self.pred_class_ids, self.device)
        return self.compositor

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

    def prepared_instance_dev(self, inst_idx: int,
                              instance_size: int) -> torch.Tensor:
        """Device mirror of ``prepared_instance`` (same values, same
        road/grass errors): a repeat pass over an instance feeds the
        generator from device memory, with no row upload."""
        if inst_idx in self.instance_rows_dev:
            self.instance_rows_dev.move_to_end(inst_idx)
            return self.instance_rows_dev[inst_idx]
        dev = torch.from_numpy(
            self.prepared_instance(inst_idx, instance_size)).to(self.device)
        self.instance_rows_dev[inst_idx] = dev
        while 0 < self.max_instance_inputs < len(self.instance_rows_dev):
            self.instance_rows_dev.popitem(last=False)
        return dev


class ColorizationSession:
    """Holds the three engines plus per-image cached state."""

    def __init__(self, cfg: FrameworkConfig, matching: MatchingEngine,
                 fg: FGColorizeEngine, bg: BGColorizeEngine):
        self.cfg = cfg
        self.matching = matching
        self.fg = fg
        self.bg = bg
        self.device = matching.device
        self._images: "OrderedDict[str, _ImageState]" = OrderedDict()
        pl = cfg.pipeline
        # the PNG workers record into the same tracer, so one timeline
        # covers both sides
        self.tracer: Optional[Tracer] = Tracer() if pl.stage_trace else None
        self._writer = AsyncPngWriter(trace=self.tracer) \
            if pl.async_png_writes else None
        if self._writer is not None:
            # a process exit must not strand queued PNGs whose records have
            # committed (the records would point at missing files); a
            # finalizer, unlike an atexit hook on the session, also lets a
            # dropped session (and the device memory it holds) go
            weakref.finalize(self, self._writer.close)
        if pl.color_gradient and pl.image_size ** 2 // 2 >= comp._LUT_MIN_PIXELS:
            # the sky gradient runs at LUT scale: build the 24-bit
            # round-trip table (and, for the device gradient, its device
            # copy) now, off the first BG command
            if pl.device_compositing and pl.device_color_gradient:
                threading.Thread(target=bg.lut_device, daemon=True).start()
            else:
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

    def _compositor(self, state: _ImageState) -> DeviceCompositor:
        """The image's device compositor; its first build (device copies of
        the masks and the overlay) is a stage of its own."""
        if state.compositor is None:
            with span(self.tracer, "compositor_build"):
                state.get_compositor()
        return state.compositor

    def _results_dir(self, image_id) -> str:
        d = os.path.join(self.cfg.pipeline.results_base_dir, "results",
                         str(image_id))
        os.makedirs(d, exist_ok=True)
        return d

    def _state(self, image_id) -> _ImageState:
        key = str(image_id)
        paths = self._paths(image_id)
        cached = self._images.get(key)
        tr = self.tracer
        if cached is not None and cached.signature == _fixture_signature(paths):
            self._images.move_to_end(key)
            if tr is not None:
                tr.count("image_hit", root=True)
            return cached
        last = cached.last_result if cached is not None else None
        with span(tr, "image_state"):
            state = _ImageState(paths, self.cfg.pipeline.image_size,
                                self.device,
                                self.cfg.pipeline.max_cached_instance_inputs)
        state.last_result = last        # result history survives fixture edits
        self._images[key] = state
        self._images.move_to_end(key)
        max_images = self.cfg.pipeline.max_cached_images
        while 0 < max_images < len(self._images):
            self._images.popitem(last=False)   # LRU-evict (device tensors too)
        return state

    def _save_result(self, path: str, image, copy: bool = True) -> None:
        """``image``: a uint8 ndarray or a ``_LazyFetch`` of a device canvas
        (with the write-behind writer, the wait for its host copy and the
        encode both run in the worker).  ``copy=False`` skips the writer's
        defensive copy for arrays the session never mutates (compact-fetch
        reconstructions)."""
        level = self.cfg.pipeline.png_compress_level
        if self._writer is not None:
            self._writer.save(path, image, level, copy=copy)
        else:
            self._write_png(path, image.get() if isinstance(image, _LazyFetch)
                            else image, level)

    def _write_png(self, path: str, image: np.ndarray, level: int) -> None:
        """A synchronous PNG write, counted on the innermost open span."""
        bands = write_png(path, image, level)
        if self.tracer is not None:
            count_png(self.tracer, bands)

    def _load_base(self, state: _ImageState, results_dir: str,
                   last_name: str) -> np.ndarray:
        """Latest result (memory first, disk fallback), or the raw sketch."""
        if last_name == "":
            return state.sketch.copy()
        if state.last_result is not None and state.last_result[0] == last_name:
            img = state.last_result[1]
            if isinstance(img, _LazyFetch):
                img = img.get()
            return img.copy()
        if self._writer is not None:
            self._writer.flush()
        return np.array(Image.open(
            os.path.join(results_dir, last_name)).convert("RGB"),
            dtype=np.uint8)

    def _canvas_dev(self, state: _ImageState, results_dir: str,
                    last_name: str) -> torch.Tensor:
        """The base canvas on the device: the cached device copy when it
        mirrors ``last_name`` (the common sequential case: no host copy, no
        upload), else the host base uploaded."""
        if state.last_result_dev is not None \
                and state.last_result_dev[0] == last_name:
            return state.last_result_dev[1]
        with span(self.tracer, "canvas_upload"):
            return torch.from_numpy(
                self._load_base(state, results_dir, last_name)).to(self.device)

    @staticmethod
    def _reconstruct(state: _ImageState, prev: np.ndarray,
                     patch_np: np.ndarray, inst_indices: Sequence[int],
                     offset: int, apply_overlay: bool = True
                     ) -> Tuple[np.ndarray, int]:
        """Rebuild one pass's canvas from the previous canvas and the
        compact changed-pixel patch (``composite_run_compact``).  Exact by
        construction: the device pass touches only the instances'
        ``inner_mask`` pixels (patched here with post-overlay values) and
        the stroke-overlay pixels (a host-known constant, applied first so
        a pixel in both sets takes the patch's value, which is the same
        overlay value).  The overlay is idempotent, so callers pass
        ``apply_overlay=False`` when ``prev`` is itself a saved result
        (every result ends with the overlay; only the raw sketch lacks
        it).  Returns (canvas, new offset)."""
        new = prev.copy()
        flat = new.reshape(-1, 3)
        if apply_overlay:
            ov_idx, ov_val = state.overlay_flat()
            flat[ov_idx] = ov_val
        compositor = state.get_compositor()
        for inst_idx in inst_indices:
            idx = compositor.host_idx(inst_idx)
            flat[idx] = patch_np[offset: offset + len(idx)]
            offset += len(idx)
        return new, offset

    # ------------------------------------------------------------- tracing
    @property
    def trace_events(self) -> List[Span]:
        """The tracer's spans in the order they ended, main thread and PNG
        workers interleaved; each unpacks as (label, t_start, t_end) on
        ``time.perf_counter``.  Empty unless ``PipelineConfig.stage_trace``."""
        return list(self.tracer.events) if self.tracer is not None else []

    def clear_trace(self) -> None:
        # drain the write-behind queue first: in-flight PNG jobs append
        # events from worker threads
        if self.tracer is not None:
            self.flush()
            self.tracer.clear()

    def flush(self) -> None:
        """Block until all write-behind PNGs are on disk."""
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        """Drain the write-behind queue; idempotent (the writer's finalizer
        also drains it when the session is dropped or the process exits)."""
        self.flush()

    def clone(self, seed: int = 0, **pipeline_overrides
              ) -> "ColorizationSession":
        """A session sharing this one's engines (models and weights) with
        its own per-image cache, PNG writer and FG noise stream
        (JAX ``session.py:402-419``).  With the build seed and unchanged
        model configs it serves exactly as ``build_session(new_cfg, seed)``.
        ``pipeline_overrides`` replace ``cfg.pipeline`` fields, except
        ``score_thresh`` and ``serve_gan_data_parallel``, which the engines
        hold from their build."""
        for fixed in ("score_thresh", "serve_gan_data_parallel"):
            if fixed in pipeline_overrides:
                raise ValueError(f"{fixed} is fixed at build_session")
        cfg = dataclasses.replace(
            self.cfg, pipeline=dataclasses.replace(self.cfg.pipeline,
                                                   **pipeline_overrides))
        return ColorizationSession(cfg, self.matching, self.fg.fork(seed),
                                   self.bg)

    # ----------------------------------------------------------------- API
    def colorize(self, image_id, input_text: str) -> str:
        """One 'color' command; returns the path of the new result image."""
        if not input_text:
            raise ValueError("empty instruction")
        colorization_type = judge_colorize_type(input_text)
        tr = self.tracer
        with command(tr, f"cmd:{colorization_type.lower()}"):
            with span(tr, "records"):
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
            with span(tr, "records"):
                update_records(image_id, input_text,
                               self.cfg.pipeline.results_base_dir,
                               colorization_type, new_name, proc_bg_text,
                               summary)
        return out_path

    def colorize_stream(self, image_id, input_texts: Sequence[str]) -> List[str]:
        """Ordered batch serving (JAX ``session.py:441-476``): M queued
        instructions with the outputs, records and error behaviour of M
        sequential ``colorize`` calls.  Consecutive FG instructions share
        one matching forward, one generator batch per segment and, with
        device compositing, one compositing run chaining every pass's
        canvas."""
        texts = list(input_texts)
        pl = self.cfg.pipeline
        with command(self.tracer, "cmd:stream"):
            if pl.cache_match_scores and pl.max_cached_match_texts != 0:
                # scores depend only on the fixtures, weights and text, so
                # every queued FG instruction is scored in one forward up
                # front; later runs (even after BG passes) take theirs from
                # the LRU
                fg_texts = [t for t in texts if judge_colorize_type(t) == "FG"]
                if fg_texts:
                    self._matched(self._state(image_id), fg_texts)
            out: List[str] = []
            i = 0
            while i < len(texts):
                if judge_colorize_type(texts[i]) == "FG":
                    j = i
                    while j < len(texts) \
                            and judge_colorize_type(texts[j]) == "FG":
                        j += 1
                    out.extend(self._colorize_fg_run(image_id, texts[i:j]))
                    i = j
                else:
                    out.append(self.colorize(image_id, texts[i]))
                    i += 1
            return out

    @staticmethod
    def _segments(pass_rows: Sequence[int], seg_rows: int
                  ) -> List[Tuple[int, int]]:
        """[start, end) pass ranges of about ``seg_rows`` instance rows
        each (one segment when ``seg_rows`` is 0)."""
        bounds, acc, start = [], 0, 0
        for m, r in enumerate(pass_rows):
            acc += r
            if seg_rows > 0 and acc >= seg_rows and m + 1 < len(pass_rows):
                bounds.append((start, m + 1))
                start, acc = m + 1, 0
        bounds.append((start, len(pass_rows)))
        return bounds

    def _colorize_fg_run(self, image_id, run_texts: Sequence[str]) -> List[str]:
        """A run of consecutive FG instructions (JAX ``session.py:478-669``).
        Every pass is validated and prepared in order first; the first
        failing pass stops the run, the passes before it commit (results
        and records, as sequential commands would), then the error
        raises."""
        state = self._state(image_id)
        pl = self.cfg.pipeline
        tr = self.tracer
        instance_size = pl.instance_size
        matched = self._matched(state, run_texts)

        device_comp = pl.device_compositing
        error: Optional[BaseException] = None
        n_ok = len(run_texts)
        rows, row_class_ids, row_tokens, plans = [], [], [], []
        with span(tr, "prep_rows"):
            for p, text in enumerate(run_texts):
                toks = self.fg.encode(segment_user_input_text(text))
                pass_rows = []
                try:
                    for inst_idx in matched[p]:
                        class_id46 = int(state.pred_class_ids[inst_idx])
                        if class_id46 not in comp.SKE_ID_TO_CAT_ID:
                            raise ValueError(
                                "Wrong matching instance: "
                                f"{state.categories46[class_id46]}")
                        pass_rows.append(
                            state.prepared_instance_dev(inst_idx,
                                                        instance_size)
                            if device_comp else
                            state.prepared_instance(inst_idx, instance_size))
                except ValueError as e:
                    error = e
                    n_ok = p
                    break
                for inst_idx, row in zip(matched[p], pass_rows):
                    rows.append(row)
                    row_class_ids.append(comp.SKE_ID_TO_CAT_ID[
                        int(state.pred_class_ids[inst_idx])])
                    row_tokens.append(toks)
                plans.append((text, matched[p]))

        results_dir = self._results_dir(image_id)
        generated_u8 = canvases = None
        final_canvas = patch_list = prev_host = None
        if device_comp and plans[:n_ok]:
            with span(tr, "records"):
                _, last0, _, _ = fetch_records(image_id, pl.results_base_dir)
            base = self._canvas_dev(state, results_dir, last0)
            compositor = self._compositor(state)
            pass_rows = [len(inst) for _, inst in plans[:n_ok]]
            s = instance_size
            if pl.compact_fetch:
                # per-pass changed-pixel fetches; the run is split into
                # segments of about stream_segment_rows instance rows, each
                # segment's host copies start as soon as it is composited
                seg_rows = pl.stream_segment_rows
                if pl.stream_small_segment_rows > 0 and sum(pass_rows) <= 96:
                    seg_rows = pl.stream_small_segment_rows
                canvas = base
                patch_list = []
                row_start = 0
                for s0, s1 in self._segments(pass_rows, seg_rows):
                    n_seg = sum(pass_rows[s0:s1])
                    seg_passes, off = [], 0
                    for m in range(s0, s1):
                        seg_passes.append((tuple(plans[m][1]), off))
                        off += pass_rows[m]
                    seg = slice(row_start, row_start + n_seg)
                    with self._gan_span(n_seg):
                        if n_seg:
                            seg_gen, _ = self.fg.colorize_rows_dev(
                                rows[seg], row_class_ids[seg],
                                np.asarray(row_tokens[seg], np.int32), tr)
                        else:
                            seg_gen = torch.zeros((1, s, s, 3),
                                                  dtype=torch.uint8,
                                                  device=self.device)
                    with span(tr, "comp_dispatch"):
                        canvas, plist = compositor.composite_run_compact(
                            canvas, seg_gen, seg_passes)
                    patch_list.extend(_LazyFetch(p) for p in plist)
                    row_start += n_seg
                final_canvas = canvas
                prev_host = self._load_base(state, results_dir, last0)
            else:
                with self._gan_span(len(rows)):
                    if rows:
                        gen_dev, _ = self.fg.colorize_rows_dev(
                            rows, row_class_ids,
                            np.asarray(row_tokens, np.int32), tr)
                    else:
                        gen_dev = torch.zeros((1, s, s, 3), dtype=torch.uint8,
                                              device=self.device)
                passes, off = [], 0
                for _, inst in plans[:n_ok]:
                    passes.append((tuple(inst), off))
                    off += len(inst)
                with span(tr, "comp_dispatch"):
                    canvases = compositor.composite_run(base, gen_dev, passes)
        elif rows:
            generated_u8 = self.fg.colorize_rows(
                np.stack(rows), row_class_ids,
                np.asarray(row_tokens, np.int32))

        out_paths: List[str] = []
        row = 0
        for m, (text, inst_indices) in enumerate(plans[:n_ok]):
            with span(tr, "records"):
                new_name, last_name, last_bg_text, summary = fetch_records(
                    image_id, pl.results_base_dir)
            if patch_list is not None:
                with span(tr, "patch_wait"):
                    patch_np = patch_list[m].get()
                with span(tr, "reconstruct"):
                    new_result, _ = self._reconstruct(
                        state, prev_host, patch_np, inst_indices, 0,
                        apply_overlay=(m == 0 and last_name == ""))
                prev_host = new_result
                if m == n_ok - 1:
                    state.last_result_dev = (new_name, final_canvas)
            elif canvases is not None:
                new_result = _LazyFetch(canvases[m])
                state.last_result_dev = (new_name, canvases[m])
            else:
                new_result = self._load_base(state, results_dir, last_name)
                for inst_idx in inst_indices:
                    class_id46 = int(state.pred_class_ids[inst_idx])
                    bbox = state.pred_boxes[inst_idx]
                    color_instance = comp.instance_result_postprocessing_u8(
                        generated_u8[row], bbox, class_id46)
                    comp.paste_instance(new_result, color_instance,
                                        state.inner_mask, inst_idx, bbox)
                    row += 1
                new_result[state.drawings_region] = \
                    state.moved[state.drawings_region]
            out_path = os.path.join(results_dir, new_name)
            with span(tr, "save+records"):
                self._save_result(out_path, new_result,
                                  copy=patch_list is None)
                state.last_result = (new_name, new_result)
                with span(tr, "records"):
                    update_records(image_id, text, pl.results_base_dir, "FG",
                                   new_name, last_bg_text, summary)
            out_paths.append(out_path)
        if error is not None:
            raise error
        return out_paths

    def withdraw(self, image_id) -> None:
        tr = self.tracer
        with command(tr, "cmd:withdraw"):
            self.flush()
            with span(tr, "records"):
                withdraw_records(image_id, self.cfg.pipeline.results_base_dir)
            key = str(image_id)
            if key in self._images:
                self._images[key].last_result = None  # force a disk re-read
                self._images[key].last_result_dev = None

    # ------------------------------------------------------------- matching
    def match_instances(self, image_id, input_text: str) -> List[int]:
        """``build_instance_matching`` (``fg_matching_utils.py:14-77``),
        with the threshold and occupancy counts on the device."""
        return self._matched(self._state(image_id), [input_text])[0]

    def _matched(self, state: _ImageState,
                 input_texts: Sequence[str]) -> List[List[int]]:
        """``_match_many`` in the ``match`` stage, which counts the
        ``texts`` asked (``_match_many`` counts those it ``scored``)."""
        with span(self.tracer, "match") as sp:
            sp.count("texts", len(input_texts))
            return self._match_many(state, input_texts)

    def _gan_span(self, rows: int):
        """The ``gan_dispatch[rows]`` stage; ``colorize_rows_dev`` counts
        its ``rows`` and ``bucket`` rows."""
        if self.tracer is None:
            return NO_SPAN
        return self.tracer.span(f"gan_dispatch[{rows}]")

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
        if self.tracer is not None:
            self.tracer.count("scored", len(todo))
        if todo:
            if pl.cache_visual_features and state.visual_dev is None:
                with span(self.tracer, "backbone_dispatch"):
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
                visual_dev=state.visual_dev,
                trace=self.tracer)[:len(todo)]               # [M', N_inst]
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

    def match_instances_host(self, image_id, input_text: str) -> List[int]:
        """The host reference path (JAX ``session.py:741-751``): the full
        mask fetched and matched by ``get_pred_instance_mask``; kept for
        parity tests."""
        paths = self._paths(image_id)
        state = self._state(image_id)
        predicts = self.matching.predict_mask(state.sketch, input_text)
        _, _, _, _, matched = get_pred_instance_mask(
            paths["seg_data"], predicts.copy(),
            self.cfg.pipeline.mask_occupied_threshold)
        return [int(i) for i in matched]

    # ------------------------------------------------------------------ FG
    def colorize_foreground(self, image_id, input_text: str,
                            inst_indices: Sequence[int], new_name: str,
                            last_name: str) -> str:
        """``build_instance_colorization`` (``fg_color_utils.py:188-363``;
        JAX ``session.py:753-834``)."""
        state = self._state(image_id)
        pl = self.cfg.pipeline
        tr = self.tracer
        instance_size = pl.instance_size
        results_dir = self._results_dir(image_id)
        inst_color_text = segment_user_input_text(input_text)

        # validate and prepare every instance first: nothing is written on
        # error, as with the reference's per-instance loop
        device_comp = pl.device_compositing
        batch, class_ids25 = [], []
        with span(tr, "prep_rows"):
            for inst_idx in inst_indices:
                class_id46 = int(state.pred_class_ids[inst_idx])
                if class_id46 not in comp.SKE_ID_TO_CAT_ID:
                    raise ValueError("Wrong matching instance: "
                                     f"{state.categories46[class_id46]}")
                batch.append(
                    state.prepared_instance_dev(inst_idx, instance_size)
                    if device_comp else
                    state.prepared_instance(inst_idx, instance_size))
                class_ids25.append(comp.SKE_ID_TO_CAT_ID[class_id46])

        if batch and device_comp:
            # the generator batch and the compositing on the device canvas,
            # which stays there for the next pass
            toks = self.fg.encode(inst_color_text)
            tokens_rows = np.broadcast_to(
                np.asarray(toks, np.int32)[None], (len(batch), len(toks)))
            canvas = self._canvas_dev(state, results_dir, last_name)
            compositor = self._compositor(state)
            with self._gan_span(len(batch)):
                gen_dev, _ = self.fg.colorize_rows_dev(
                    batch, class_ids25, tokens_rows, tr)
            if pl.compact_fetch:
                # fetch only this pass's changed pixels; rebuild on the host
                with span(tr, "comp_dispatch"):
                    canvas, patches_dev = compositor.composite_run_compact(
                        canvas, gen_dev, [(tuple(inst_indices), 0)])
                prev = self._load_base(state, results_dir, last_name)
                patch = _LazyFetch(patches_dev[0])
                with span(tr, "patch_wait"):
                    patch_np = patch.get()
                with span(tr, "reconstruct"):
                    new_result, _ = self._reconstruct(
                        state, prev, patch_np, inst_indices, 0,
                        apply_overlay=(last_name == ""))
            else:
                with span(tr, "comp_dispatch"):
                    canvas = compositor.composite(canvas, gen_dev,
                                                  list(inst_indices))
                new_result = _LazyFetch(canvas)
            state.last_result_dev = (new_name, canvas)
        else:
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
            new_result[state.drawings_region] = \
                state.moved[state.drawings_region]
            # a host-built result has no device mirror
            state.last_result_dev = None

        out_path = os.path.join(results_dir, new_name)
        with span(tr, "save+records"):
            self._save_result(
                out_path, new_result,
                copy=not (batch and device_comp and pl.compact_fetch))
            state.last_result = (new_name, new_result)
        return out_path

    # ------------------------------------------------------------------ BG
    def colorize_background(self, image_id, input_text: str, new_name: str,
                            last_name: str, last_bg_text: str
                            ) -> Tuple[str, str]:
        """``build_background_colorization`` (``bg_utils.py:169-325``; JAX
        ``session.py:837-917``).  Returns (result path, the merged BG text
        the record keeps)."""
        state = self._state(image_id)
        results_dir = self._results_dir(image_id)
        if last_name == "":
            if last_bg_text != "":
                raise ValueError(f"records of image {image_id} hold a BG "
                                 "text but no result")
            last_bg_text = DEFAULT_BG_TEXT
        proc_text = combine_bg_input_text(input_text, last_bg_text)

        pl = self.cfg.pipeline
        band = state.inner_mask[comp.SKY_SEARCH_FROM:
                                comp.SKY_SEARCH_FROM + comp.SKY_SEARCH_HEIGHT]
        # (a band fully FG takes the host path, where the reference's
        # np.argmax([]) ValueError reproduces)
        if (pl.device_compositing and pl.color_gradient
                and pl.device_color_gradient
                and pl.image_size ** 2 // 2 >= comp._LUT_MIN_PIXELS
                and bool((band == 0).any())):
            return self._colorize_background_device_grad(
                image_id, state, results_dir, proc_text, new_name, last_name)

        tr = self.tracer
        previous = self._load_base(state, results_dir, last_name)
        inner_mask, moved = state.inner_mask, state.moved
        drawings_region = state.drawings_region
        if pl.device_compositing:
            # FG extraction, generator, paste-back and overlay on the device
            # canvas (no canvas upload); one canvas fetch remains, since the
            # host gradient (or the PNG) needs it
            compositor = self._compositor(state)
            base = self._canvas_dev(state, results_dir, last_name)
            with span(tr, "bg_dispatch"):
                bg_dev = self.bg.colorize_composited(
                    base, compositor._inner, compositor._moved,
                    compositor._drawings, proc_text)
            with span(tr, "bg_canvas_fetch"):
                background = np.array(bg_dev.cpu())   # a copy, not a view
            fg_image_temp = comp.extract_foreground(previous, inner_mask)
            state.last_result_dev = None if pl.color_gradient \
                else (new_name, bg_dev)
        else:
            fg_image = comp.extract_foreground(previous, inner_mask)
            fg_image_temp = fg_image.copy()
            background, _ = self.bg.colorize(fg_image, proc_text,
                                             want_region=False)
            # paste the FG back, overlay the drawings (``bg_utils.py:290-310``)
            background[inner_mask != 0] = fg_image[inner_mask != 0]
            background[drawings_region] = moved[drawings_region]
            state.last_result_dev = None

        # the FG image with the overlay, saved as the reference does
        with span(tr, "fg_debug"):
            fg_image_temp[drawings_region] = moved[drawings_region]
            self._save_result(os.path.join(results_dir, f"{image_id}_fg.png"),
                              fg_image_temp)

        if pl.color_gradient:
            with span(tr, "bg_gradient"):
                background = comp.add_color_gradient(background, inner_mask)
                background[drawings_region] = moved[drawings_region]

        out_path = os.path.join(results_dir, new_name)
        with span(tr, "bg_save"):
            self._save_result(out_path, background)
            state.last_result = (new_name, background)
        return out_path, proc_text

    def _colorize_background_device_grad(
            self, image_id, state: _ImageState, results_dir: str,
            proc_text: str, new_name: str,
            last_name: str) -> Tuple[str, str]:
        """A BG pass with the sky gradient on the device (JAX
        ``session.py:919-1000``; ``bg_utils.py:96-166`` split for float64
        exactness): the BG pass, sky detection and whole-image LUT
        round-trip on the device; the host fetches the top rows of the
        FG-whitened image, the sky colour and bottom, and computes the exact
        float64 HSV ramp (``compositing.sky_ramp_rows``, the bytes the host
        gradient writes); the device splices the ramp over the LUT image
        and restores the FG and overlay pixels.  The finished canvas stays
        on the device and its PNG fetch can be write-behind."""
        tr = self.tracer
        compositor = self._compositor(state)
        base = self._canvas_dev(state, results_dir, last_name)
        with span(tr, "bg_dispatch"):
            bg_dev, lut_img, ramp_band_dev, sky_dev, bottom_dev = \
                self.bg.colorize_composited_gradient(
                    base, compositor._inner, compositor._moved,
                    compositor._drawings, proc_text)
            fetches = [_LazyFetch(x) for x in (ramp_band_dev, sky_dev,
                                                bottom_dev)]

        # the fg debug image goes out before the sky assert, as in the host
        # flow (on a failed assert the reference has already written it);
        # it is built in the worker from the shared previous result, so the
        # critical path never waits on a canvas read
        with span(tr, "fg_debug"):
            if last_name == "":
                prev_src = state.sketch
            elif state.last_result is not None \
                    and state.last_result[0] == last_name:
                prev_src = state.last_result[1]     # ndarray or _LazyFetch
            else:                                   # disk fallback
                prev_src = self._load_base(state, results_dir, last_name)
            inner, dr, moved = (state.inner_mask, state.drawings_region,
                                state.moved)

            def fg_debug(prev_src=prev_src, inner=inner, dr=dr, moved=moved):
                prev = prev_src.get() if isinstance(prev_src, _LazyFetch) \
                    else prev_src
                out = comp.extract_foreground(prev, inner)
                out[dr] = moved[dr]
                return out

            fg_path = os.path.join(results_dir, f"{image_id}_fg.png")
            level = self.cfg.pipeline.png_compress_level
            if self._writer is not None:
                self._writer.save(fg_path, fg_debug, level)
            else:
                self._write_png(fg_path, fg_debug(), level)

        with span(tr, "bg_band_fetch"):
            ramp_band, sky, bottom = (f.get() for f in fetches)
            sky_bottom = int(bottom)
            assert sky_bottom != -1     # reference assert (bg_utils.py:128)
            sky_color = [int(v) for v in sky]
        with span(tr, "bg_ramp_host"):
            start_height = int(sky_bottom / 4 * 3)
            ramp_pad = np.zeros_like(ramp_band)
            ramp_pad[: start_height + 1] = comp.sky_ramp_rows(
                ramp_band, sky_color, sky_bottom)
        with span(tr, "bg_finish_dispatch"):
            final_dev = self.bg.finish_gradient(
                lut_img, bg_dev, ramp_pad, start_height, compositor._inner,
                compositor._moved, compositor._drawings)

        out_path = os.path.join(results_dir, new_name)
        lazy = _LazyFetch(final_dev)
        with span(tr, "bg_save"):
            self._save_result(out_path, lazy)
            state.last_result = (new_name, lazy)
            state.last_result_dev = (new_name, final_dev)
        return out_path, proc_text
