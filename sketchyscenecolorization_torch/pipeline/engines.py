"""Model engines of the interactive pipeline
(``sketchyscenecolorization_tpu/pipeline/engines.py``).

Each engine holds its model on an explicit ``device`` for the whole
session and runs it under ``torch.no_grad``.  Host arrays go in and come
out as NumPy; device tensors stay on the device between calls where the
session caches them.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

from ..config import BGGanConfig, FGGanConfig, MatchingConfig
from ..models.fg_gan import MRUGenerator
from ..models.rmi import RMI
from ..text import colorization_encode, matching_encode

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
        words, lens = self.encode_texts(input_texts)
        up = self.model.apply_fused(
            visual, torch.from_numpy(words.astype(np.int64)).to(self.device),
            torch.from_numpy(lens.astype(np.int64)).to(self.device)).up
        predicts = (up[..., 0].cpu().numpy() >= self.score_thresh) \
            .astype(np.float32)
        return predicts * self.binarize_drawing(sketch_image_uint8)[None]

    @torch.no_grad()
    def extract_visual_dev(self, image_dev: torch.Tensor) -> torch.Tensor:
        """Backbone features of the mean-subtracted [1, H, W, 3] image."""
        return self.model.extract_visual(image_dev)

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
        words_t = torch.from_numpy(np.asarray(words, np.int64)).to(self.device)
        lens_t = torch.from_numpy(np.asarray(lens, np.int64)).to(self.device)
        up = self.model.apply_fused(visual_dev, words_t, lens_t).up
        pred = (up[..., 0] >= self.score_thresh).float() \
            * bin_drawing_dev[None]                              # [M, H, W]
        inter = pred.reshape(pred.shape[0], -1) @ inst_masks_dev.T  # [M, N]
        return inter.cpu().numpy().astype(np.float64) \
            / np.maximum(np.asarray(areas, np.float64), 1.0)[None, :]


class FGColorizeEngine:
    """FG MRU generator over a batch of instances (``fg_color_utils.py:253-265``).

    The noise rows come from ``noise_source(k) -> [k, noise_dim]``, by
    default the engine's own CPU ``torch.Generator`` seeded with ``seed``,
    so a session draws the same noise on any device.  A test replaces
    ``noise_source`` to feed the JAX engine's noise stream.
    """

    def __init__(self, cfg: FGGanConfig, model: MRUGenerator,
                 vocab: Dict[str, int], seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.vocab = vocab
        self._rng = torch.Generator().manual_seed(seed)
        self.noise_source: Callable[[int], np.ndarray] = self._torch_noise

    def _torch_noise(self, k: int) -> np.ndarray:
        return torch.randn((k, self.cfg.noise_dim),
                           generator=self._rng).numpy()

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

    @torch.no_grad()
    def colorize_rows(self, instance_sketches: np.ndarray,
                      class_ids25: Sequence[int],
                      tokens_rows: np.ndarray) -> np.ndarray:
        """Per-row tokens [K, T] -> uint8 [K, S, S, 3].  The batch pads to
        ``bucket_for(K)`` with zero rows; per-sample BN keeps every row
        independent of the others, so pad rows change nothing."""
        k = len(class_ids25)
        noise = np.asarray(self.noise_source(k), np.float32)
        pad = self.bucket_for(k) - k

        def padded(a, dtype):
            a = np.asarray(a, dtype)
            a = np.concatenate([a, np.zeros((pad, *a.shape[1:]), dtype)])
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        out = self.model(padded(instance_sketches, np.float32),
                         padded(tokens_rows, np.int64),
                         padded(class_ids25, np.int64),
                         padded(noise, np.float32), per_sample=True)
        out_u8 = (((out + 1.0) / 2.0) * 255.0).to(torch.uint8)   # truncates,
        return out_u8[:k].cpu().numpy()                          # as astype


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

    @torch.no_grad()
    def colorize(self, fg_image_uint8: np.ndarray, text: str,
                 want_region: bool = True):
        """uint8 [S, S, 3] FG composite -> (uint8 background, uint8 region
        labels [S, S], or None with ``want_region=False``)."""
        tokens = colorization_encode(text, self.vocab, self.cfg.max_len)
        # preprocess_examples (bg main :101-114), in f32 on the host
        x = fg_image_uint8[None].astype(np.float32) / 255.0 * 2.0 - 1.0
        result = self.model(
            torch.from_numpy(x).to(self.device),
            torch.tensor([tokens], dtype=torch.long, device=self.device))
        out = result[0] if self.cfg.residual_enc_g else result
        # deprocess (bg main :29-38): TF's convert_image_dtype scales by
        # 255.5 and saturates, then the cast truncates
        out_u8 = ((out + 1.0) / 2.0 * 255.5).clamp(0, 255).to(torch.uint8)
        labels = None
        if want_region:
            labels = (result[1].argmax(dim=-1).to(torch.uint8)[0].cpu().numpy()
                      if self.cfg.residual_enc_g else
                      np.zeros(out.shape[1:3], np.uint8))
        return out_u8[0].cpu().numpy(), labels
