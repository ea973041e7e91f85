"""Model engines of the interactive pipeline
(``sketchyscenecolorization_tpu/pipeline/engines.py``).

Each engine holds its model on an explicit ``device`` for the whole
session and runs it under ``torch.no_grad``.  The host entry points
(``colorize``, ``colorize_batch``, ``score_instances``) take and return
NumPy; the serving entry points (``FGColorizeEngine.colorize_rows_dev``,
``BGColorizeEngine.colorize_composited``/``colorize_composited_gradient``/
``finish_gradient``, ``sky_detect_trace``) keep their results on the
device, where the session's device compositing reads them.  Each engine
runs its model under the compute-dtype scope of its config (JAX
``engines.py:41-58,129-137,195-198,322-324,449-490``), so engines of
either dtype serve side by side; a bf16 model's outputs are cast to f32
before they are quantized.
"""
from __future__ import annotations

import copy
import threading
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..config import BGGanConfig, FGGanConfig, MatchingConfig
from ..models.rmi import RMI
from ..ops.conv import compute_dtype_scope
from ..text import colorization_encode, matching_encode
from . import compositing as comp

# BGR pixel means, matching-model preprocessing (``fg_matching_utils.py:11``)
PIXEL_MU = np.array((104.00698793, 116.66876762, 122.67891434))


class MatchingEngine:
    """RMI referring segmentation, scored per instance
    (``fg_matching_utils.py:14-77``)."""

    def __init__(self, cfg: MatchingConfig, model: RMI,
                 vocab: Dict[str, int], score_thresh: float = 1e-9,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.vocab = vocab
        self.score_thresh = score_thresh

    @staticmethod
    def binarize_drawing(sketch_image_uint8: np.ndarray) -> np.ndarray:
        """{0,1} drawing-pixel mask from the R channel
        (``fg_matching_utils.py:44-47``: 0 -> 1, 255 -> 0)."""
        bin_drawing = sketch_image_uint8[:, :, 0].copy()
        bin_drawing[bin_drawing == 0] = 1
        bin_drawing[bin_drawing == 255] = 0
        return bin_drawing

    def encode_texts(self, input_texts: Sequence[str]):
        n = len(input_texts)
        words = np.zeros((n, self.cfg.max_len), np.int32)
        lens = np.zeros((n,), np.int32)
        for i, text in enumerate(input_texts):
            words[i], lens[i] = matching_encode(text, self.vocab,
                                                self.cfg.max_len)
        return words, lens

    def predict_mask(self, sketch_image_uint8: np.ndarray,
                     input_text: str) -> np.ndarray:
        """uint8 [H, W, 3] sketch + one instruction -> {0, 1} float32 mask
        [H, W], restricted to drawing pixels."""
        return self.predict_masks(sketch_image_uint8, [input_text])[0]

    @torch.no_grad()
    def predict_masks(self, sketch_image_uint8: np.ndarray,
                      input_texts: Sequence[str]) -> np.ndarray:
        """N instructions against one sketch (JAX ``engines.py:62-86``): the
        backbone runs once and ``apply_fused`` on all N texts; every layer
        is independent of the batch row, so row i equals
        ``predict_mask(sketch, texts[i])``.  Returns host [N, H, W]."""
        image = (sketch_image_uint8.astype(np.float32) - PIXEL_MU) \
            .astype(np.float32)
        visual = self.model.extract_visual(
            torch.from_numpy(image[None]).to(self.device))
        up = self.fuse_logits(visual, *self.encode_texts(input_texts))
        predicts = (up[..., 0].cpu().numpy() >= self.score_thresh) \
            .astype(np.float32)
        return predicts * self.binarize_drawing(sketch_image_uint8)[None]

    @torch.no_grad()
    def extract_visual_dev(self, image_dev: torch.Tensor) -> torch.Tensor:
        """Backbone features of the mean-subtracted [1, H, W, 3] image."""
        return self.model.extract_visual(image_dev)

    @torch.no_grad()
    def fuse_logits(self, visual, words: np.ndarray,
                    lens: np.ndarray) -> torch.Tensor:
        """``up`` logits [M, H, W, 1] of M encoded instructions against
        the features of one sketch (JAX ``_fuse``, ``engines.py:54-58``),
        under the config's compute-dtype scope; on the device."""
        words_t = torch.from_numpy(np.asarray(words, np.int64)).to(self.device)
        lens_t = torch.from_numpy(np.asarray(lens, np.int64)).to(self.device)
        with compute_dtype_scope(self.cfg.compute_dtype):
            return self.model.apply_fused(visual, words_t, lens_t).up

    @torch.no_grad()
    def score_instances(self, image_dev, words: np.ndarray, lens: np.ndarray,
                        inst_masks_dev, areas: np.ndarray, bin_drawing_dev,
                        visual_dev=None) -> np.ndarray:
        """Occupancy scores [M, N_inst] of M instructions.  Threshold,
        drawing mask and per-instance intersection counts run on the device
        (JAX ``engines.py:119-124``); only the [M, N_inst] counts come back.
        The counts are exact in f32 ({0,1} operands, counts < 2^24); the
        division by the instance areas runs on the host in float64, like
        the reference (JAX ``engines.py:162``)."""
        if visual_dev is None:
            visual_dev = self.model.extract_visual(image_dev)
        up = self.fuse_logits(visual_dev, words, lens)
        pred = (up[..., 0] >= self.score_thresh).float() \
            * bin_drawing_dev[None]                              # [M, H, W]
        inter = pred.reshape(pred.shape[0], -1) @ inst_masks_dev.T  # [M, N]
        return inter.cpu().numpy().astype(np.float64) \
            / np.maximum(np.asarray(areas, np.float64), 1.0)[None, :]


def _indexed(device) -> torch.device:
    """``device`` with the index it stands for (``cuda`` is the current
    CUDA device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class FGColorizeEngine:
    """FG generator (MRU, Pix2Pix or Residual) over a batch of instances
    (``fg_color_utils.py:253-265``; JAX ``engines.py:170-394``).

    The noise rows come from ``noise_source(k) -> [k, noise_dim]``, by
    default the engine's own CPU ``torch.Generator`` seeded with ``seed``,
    so a session draws the same noise on any device.  The default source
    draws row by row, so k rows drawn at once equal k rows drawn in any
    split: a stream run gives every row the noise it gets from sequential
    commands, however the run is segmented.  A test replaces
    ``noise_source`` to feed the JAX engine's noise stream.

    ``serve_devices`` (serving data parallelism, JAX's serving mesh,
    ``engines.py:176-186,284-337``): a list of devices, the first of them
    ``device``; the generator is copied once to each.  The noise and the
    row stack stay on ``device``; a bucket that divides over the list is
    split into equal contiguous row shards, each run on its device (rows
    are independent under per-sample BN) and its uint8 output gathered on
    ``device``.  Smaller buckets run on ``device`` alone, as JAX's do.  A
    device may appear more than once (one card driving the split path).
    """

    MAX_GAN_ROWS = 128      # largest generator batch; larger runs chunk

    def __init__(self, cfg: FGGanConfig, model: torch.nn.Module,
                 vocab: Dict[str, int], seed: int = 0, device="cuda",
                 serve_devices: Optional[Sequence] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.serve_devices = None
        if serve_devices is not None:
            self.serve_devices = [_indexed(d) for d in serve_devices]
            if self.serve_devices[0] != _indexed(self.device):
                raise ValueError(f"serve_devices start at {device}, got "
                                 f"{self.serve_devices[0]}")
            self._replicas = {self.serve_devices[0]: self.model}
            for d in self.serve_devices:
                if d not in self._replicas:
                    self._replicas[d] = copy.deepcopy(self.model).to(d)
        self.vocab = vocab
        self._rng = torch.Generator().manual_seed(seed)
        self.noise_source: Callable[[int], np.ndarray] = self._torch_noise

    def _torch_noise(self, k: int) -> np.ndarray:
        rows = [torch.randn((1, self.cfg.noise_dim), generator=self._rng)
                for _ in range(k)]
        return torch.cat(rows).numpy() if rows \
            else np.zeros((0, self.cfg.noise_dim), np.float32)

    def fork(self, seed: int) -> "FGColorizeEngine":
        """Same model and weights, a fresh noise stream from ``seed``
        (JAX ``engines.py:201-209``): the only mutable state of the engine.
        A fork with the build seed serves exactly as a freshly built
        engine.  The default noise source is rebound to the fork's own
        generator; a replaced ``noise_source`` is the caller's to set."""
        eng = copy.copy(self)
        eng._rng = torch.Generator().manual_seed(seed)
        eng.noise_source = eng._torch_noise
        return eng

    def encode(self, text: str):
        return colorization_encode(text, self.vocab, self.cfg.max_len)

    def colorize_batch(self, instance_sketches: np.ndarray,
                       class_ids25: Sequence[int], text: str) -> np.ndarray:
        """[-1,1] float32 [K, S, S, 3] sketches + one instruction -> uint8
        [K, S, S, 3]."""
        k = len(class_ids25)
        tokens = np.asarray(self.encode(text), np.int32)
        return self.colorize_rows(
            instance_sketches, class_ids25,
            np.broadcast_to(tokens[None], (k, self.cfg.max_len)))

    @staticmethod
    def bucket_for(k: int) -> int:
        """Pad-to bucket: powers of two up to 32, then multiples of 32
        (JAX ``engines.py:344``)."""
        if k <= 32:
            bucket = 1
            while bucket < k:
                bucket *= 2
            return bucket
        return ((k + 31) // 32) * 32

    def colorize_rows(self, instance_sketches: np.ndarray,
                      class_ids25: Sequence[int],
                      tokens_rows: np.ndarray) -> np.ndarray:
        """Per-row tokens [K, T] -> host uint8 [K, S, S, 3]."""
        out, k = self.colorize_rows_dev(instance_sketches, class_ids25,
                                        tokens_rows)
        return out[:k].cpu().numpy()

    @torch.no_grad()
    def prep_fwd(self, rows, class_ids25: Sequence[int],
                 tokens_rows: np.ndarray, bucket: int) -> torch.Tensor:
        """The whole-segment body (JAX ``prep_fwd_fn``, ``engines.py:284-327``):
        k noise rows, the row stack, the pad to ``bucket`` with zero rows,
        the batched generator forward with per-sample statistics and the
        uint8 quantize.  Returns the device uint8 [bucket, S, S, 3].
        Per-sample BN keeps every row independent of the others, so pad
        rows change nothing."""
        k = len(class_ids25)
        pad = bucket - k
        dev = self.device
        x = torch.stack([torch.as_tensor(r, dtype=torch.float32).to(dev)
                         for r in rows])
        noise = torch.from_numpy(
            np.asarray(self.noise_source(k), np.float32)).to(dev)
        tok = torch.from_numpy(np.asarray(tokens_rows, np.int64)).to(dev)
        ids = torch.as_tensor(list(class_ids25), dtype=torch.int64,
                              device=dev)
        if pad:
            x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
            noise = torch.cat([noise, noise.new_zeros((pad, noise.shape[1]))])
            tok = torch.cat([tok, tok.new_zeros((pad, tok.shape[1]))])
            ids = torch.cat([ids, ids.new_zeros((pad,))])
        devices = self.serve_devices
        if devices is None or bucket % len(devices):
            return self._forward_u8(self.model, x, tok, ids, noise)
        rows = bucket // len(devices)
        shards = [self._forward_u8(
            self._replicas[d], *(t[i * rows:(i + 1) * rows].to(d)
                                 for t in (x, tok, ids, noise)))
            for i, d in enumerate(devices)]
        return torch.cat([s.to(dev) for s in shards])

    def _forward_u8(self, model, x, tok, ids, noise) -> torch.Tensor:
        with compute_dtype_scope(self.cfg.compute_dtype):
            out = model(x, tok, ids, noise, per_sample=True).float()
        return (((out + 1.0) / 2.0) * 255.0).to(torch.uint8)  # truncates,
                                                              # as astype

    def colorize_rows_dev(self, instance_sketches,
                          class_ids25: Sequence[int],
                          tokens_rows: np.ndarray):
        """Per-row tokens [K, T] -> (device uint8 [bucket, S, S, 3], K)
        (JAX ``engines.py:356-395``): a stream run batches instances of
        different instructions into one call, and device compositing reads
        the rows where they are.  ``instance_sketches`` is a stacked
        [K, S, S, 3] array or a sequence of K per-row arrays or device
        tensors (the session's instance-row cache: no upload).  Above
        ``MAX_GAN_ROWS`` the rows run in row-order chunks whose outputs are
        concatenated; the noise stream advances exactly as in one call."""
        k = len(class_ids25)
        rows = [instance_sketches[i] for i in range(k)]
        if k > self.MAX_GAN_ROWS:
            outs = []
            for start in range(0, k, self.MAX_GAN_ROWS):
                end = min(start + self.MAX_GAN_ROWS, k)
                out_c, _ = self.colorize_rows_dev(
                    rows[start:end], list(class_ids25[start:end]),
                    np.asarray(tokens_rows[start:end], np.int32))
                outs.append(out_c[: end - start])
            return torch.cat(outs), k
        return self.prep_fwd(rows, class_ids25, tokens_rows,
                             self.bucket_for(k)), k


def sky_detect_trace(img_bg: torch.Tensor, inner: torch.Tensor,
                     search_from: Optional[int] = None,
                     search_height: Optional[int] = None):
    """Device twin of the host sky detection (``compositing.detect_sky``,
    reproducing ``bg_utils.py:105-128``; JAX ``engines.py:397-431``): the
    dominant colour of the ``search_from : search_from + search_height``
    row band (defaults: ``compositing.SKY_SEARCH_FROM/HEIGHT``, rows 5:7)
    over non-FG pixels (by count, ties broken by first occurrence in
    row-major order -- the reference's dict-insertion scan), and the
    lowest row <= H/2 holding that colour (-1 if none; the caller
    asserts).  Exact integer logic.  Returns (sky colour uint8 [3], sky
    bottom int64 scalar), both on the device.

    ``torch.argmax`` returns the first index of the maximum (documented),
    which the first-occurrence tie-break rests on; it takes no bool tensor
    on CUDA, so the match matrix is cast to uint8 first."""
    f = comp.SKY_SEARCH_FROM if search_from is None else int(search_from)
    sh = comp.SKY_SEARCH_HEIGHT if search_height is None \
        else int(search_height)
    h, w = img_bg.shape[0], img_bg.shape[1]
    band = img_bg[f:f + sh].reshape(-1, 3)
    bmask = (inner[f:f + sh] == 0).reshape(-1)
    b32 = band.to(torch.int32)
    code = (b32[:, 0] << 16) | (b32[:, 1] << 8) | b32[:, 2]
    eqm = (code[:, None] == code[None, :]) & bmask[None, :]
    n = code.shape[0]
    ar = torch.arange(n, device=img_bg.device)
    counts = eqm.sum(dim=1)
    first_masked = torch.argmax(eqm.to(torch.uint8), dim=1)  # first True
    elig = bmask & (first_masked == ar)
    score = torch.where(elig, counts * (2 * n) - ar, torch.full_like(ar, -1))
    sky = band[torch.argmax(score)]
    # lowest row <= H/2 holding the sky colour (the host scans int(H/2)..0
    # and stops at the first hit; the max over matching rows is that row)
    half = h // 2
    rows_eq = (img_bg[: half + 1] == sky[None, None, :]).all(dim=-1)
    has = rows_eq.any(dim=1)
    rows = torch.arange(half + 1, device=img_bg.device)
    sky_bottom = torch.where(has, rows, torch.full_like(rows, -1)).max()
    return sky, sky_bottom


class BGColorizeEngine:
    """BG generator at the canvas size (``bg_utils.py:232-288``; JAX
    ``engines.py:434-473``): the residual generator with its region branch,
    or pix2pix (``residual_enc_g=False``), which has none."""

    def __init__(self, cfg: BGGanConfig, model: torch.nn.Module,
                 vocab: Dict[str, int], device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.vocab = vocab
        self._lut_dev: Optional[torch.Tensor] = None
        self._lut_lock = threading.Lock()
        # uint8 -> [-1, 1] f32 of the host preprocessing (bg main :101-114)
        self._unit_table = torch.from_numpy(
            np.arange(256, dtype=np.float32) / 255.0 * 2.0 - 1.0
        ).to(self.device)

    @torch.no_grad()
    def colorize(self, fg_image_uint8: np.ndarray, text: str,
                 want_region: bool = True):
        """uint8 [S, S, 3] FG composite -> (uint8 background, uint8 region
        labels [S, S], or None with ``want_region=False``)."""
        tokens = colorization_encode(text, self.vocab, self.cfg.max_len)
        # preprocess_examples (bg main :101-114), in f32 on the host
        x = fg_image_uint8[None].astype(np.float32) / 255.0 * 2.0 - 1.0
        with compute_dtype_scope(self.cfg.compute_dtype):
            result = self.model(
                torch.from_numpy(x).to(self.device),
                torch.tensor([tokens], dtype=torch.long, device=self.device))
        out = (result[0] if self.cfg.residual_enc_g else result).float()
        # deprocess (bg main :29-38): TF's convert_image_dtype scales by
        # 255.5 and saturates, then the cast truncates
        out_u8 = ((out + 1.0) / 2.0 * 255.5).clamp(0, 255).to(torch.uint8)
        labels = None
        if want_region:
            labels = (result[1].argmax(dim=-1).to(torch.uint8)[0].cpu().numpy()
                      if self.cfg.residual_enc_g else
                      np.zeros(out.shape[1:3], np.uint8))
        return out_u8[0].cpu().numpy(), labels

    # ------------------------------------------------- device compositing
    @torch.no_grad()
    def colorize_composited(self, base_u8, inner, moved_u8, drawings,
                            text: str) -> torch.Tensor:
        """The BG pass on the device canvas (JAX ``engines.py:475-519``),
        with the per-image device constants of the FG compositor: FG
        extraction (``bg_utils.py:219-226``), the generator, the FG
        paste-back and the stroke overlay (``bg_utils.py:294-310``), each a
        new tensor.  Returns the post-overlay background canvas on the
        device, byte-equal to the host chain's."""
        tokens = colorization_encode(text, self.vocab, self.cfg.max_len)
        innerb = (inner != 0)[..., None]
        fg = torch.where(innerb, base_u8, torch.full_like(base_u8, 255))
        # the host path's [-1, 1] values looked up per uint8 value, not
        # recomputed (CUDA divides by a scalar as a multiply by its
        # reciprocal, one ulp off the host's division for some values), in
        # the host path's row-major layout, so that the convolutions choose
        # the same algorithms and sum alike
        x = self._unit_table[fg.to(torch.int64)].contiguous()[None]
        with compute_dtype_scope(self.cfg.compute_dtype):
            result = self.model(
                x, torch.tensor([tokens], dtype=torch.long,
                                device=self.device))
        out = (result[0] if self.cfg.residual_enc_g else result).float()
        out_u8 = ((out + 1.0) / 2.0 * 255.5).clamp(0, 255).to(torch.uint8)[0]
        bg = torch.where(innerb, fg, out_u8)
        return torch.where(drawings[..., None], moved_u8, bg)

    # ------------------------------------------------ device sky gradient
    def lut_device(self) -> torch.Tensor:
        """The 24-bit HSV round-trip table (``compositing._rgb_roundtrip_lut``,
        exact by construction) as a [2^24, 3] uint8 tensor on the device,
        48 MiB, uploaded once per engine (JAX ``engines.py:522-530``).  The
        session starts it off the critical path at build time; the lock
        makes a command that arrives first wait for that upload."""
        with self._lut_lock:
            if self._lut_dev is None:
                self._lut_dev = torch.from_numpy(
                    comp._rgb_roundtrip_lut()).to(self.device)
            return self._lut_dev

    @torch.no_grad()
    def colorize_composited_gradient(self, base_dev, inner_dev, moved_dev,
                                     drawings_dev, text: str):
        """The first half of the device gradient (JAX ``engines.py:532-587``;
        ``bg_utils.py:96-166`` split for float64 exactness): the BG pass,
        then on the device the FG-whitened image, the sky detection and the
        whole-image LUT round-trip.  Returns ``(bg, lut_img, ramp_band, sky,
        sky_bottom)``: the post-overlay canvas and the LUT image stay on the
        device; the top ``int(H/2/4*3)+1`` rows of the whitened image, the
        sky colour and the sky bottom are for the host's exact float64 ramp
        (``compositing.sky_ramp_rows``)."""
        lut = self.lut_device()
        bg = self.colorize_composited(base_dev, inner_dev, moved_dev,
                                      drawings_dev, text)
        h, w = bg.shape[0], bg.shape[1]
        img_bg = torch.where((inner_dev != 0)[..., None],
                             torch.full_like(bg, 255), bg)
        sky, sky_bottom = sky_detect_trace(img_bg, inner_dev)
        c32 = img_bg.to(torch.int32)
        codes = (c32[..., 0] << 16) | (c32[..., 1] << 8) | c32[..., 2]
        lut_img = lut.index_select(0, codes.reshape(-1)).reshape(h, w, 3)
        max_ramp = int(h // 2 / 4 * 3) + 1
        return bg, lut_img, img_bg[:max_ramp], sky, sky_bottom

    @torch.no_grad()
    def finish_gradient(self, lut_img_dev, bg_dev, ramp_pad: np.ndarray,
                        start_height: int, inner_dev, moved_dev,
                        drawings_dev) -> torch.Tensor:
        """The second half (JAX ``engines.py:565-597``): splice the host's
        exact ramp rows [0, start_height] over the LUT image, restore the FG
        pixels from the post-overlay canvas, apply the stroke overlay.
        Returns the final canvas on the device."""
        m = ramp_pad.shape[0]
        ramp = torch.from_numpy(np.ascontiguousarray(ramp_pad)).to(self.device)
        is_ramp = (torch.arange(m, device=self.device)
                   <= start_height)[:, None, None]
        grad = torch.cat([torch.where(is_ramp, ramp, lut_img_dev[:m]),
                          lut_img_dev[m:]])
        grad = torch.where((inner_dev != 0)[..., None], bg_dev, grad)
        return torch.where(drawings_dev[..., None], moved_dev, grad)
