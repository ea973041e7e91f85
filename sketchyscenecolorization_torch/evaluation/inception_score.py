"""Inception score for generated FG instances
(``sketchyscenecolorization_tpu/evaluation/inception_score.py``).

The reference scaffolds an inception-score hook but ships it disabled
(``obj_colorization_main.py:200-201``, ``main_procedure.py:102-103,142-147``).
Completed as in JAX: IS = exp(E_x[KL(p(y|x) || p(y))]) over class
posteriors, with splits, plus two classifiers for generator outputs: the
FG discriminator's ACGAN head (25 sketch categories, the in-domain
classifier for 192x192 cartoon instances) and the full Inception-v4.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def inception_score(probs: np.ndarray, splits: int = 10
                    ) -> Tuple[float, float]:
    """probs: [N, num_classes] class posteriors.  Returns (mean, std) of the
    per-split scores, in float64 (JAX ``inception_score`` :20)."""
    probs = np.asarray(probs, dtype=np.float64)
    n = probs.shape[0]
    scores = []
    for k in range(splits):
        part = probs[k * n // splits:(k + 1) * n // splits]
        if len(part) == 0:
            continue
        marginal = part.mean(axis=0, keepdims=True)
        kl = (part * (np.log(part + 1e-12) - np.log(marginal + 1e-12))).sum(1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


@torch.no_grad()
def acgan_class_probs(disc, images: np.ndarray,
                      batch_size: int = 16) -> np.ndarray:
    """Class posteriors from the FG discriminator's ACGAN head
    (``MRUDiscriminator``, on its device) for a stack of [-1, 1] images
    [N, S, S, 3] (JAX ``acgan_class_probs`` :37).  A plain forward: it
    reads the stored spectral-norm ``u`` and commits nothing."""
    device = _device_of(disc)
    out = []
    for i in range(0, len(images), batch_size):
        chunk = torch.from_numpy(np.ascontiguousarray(
            images[i:i + batch_size], np.float32)).to(device)
        _, logits = disc(chunk, chunk)
        out.append(torch.softmax(logits, dim=-1).cpu().numpy())
    return np.concatenate(out)


@torch.no_grad()
def inception_v4_class_probs(inception, images: np.ndarray,
                             batch_size: int = 8) -> np.ndarray:
    """Class posteriors from the full Inception-v4 classifier
    (``models/inception_v4.InceptionV4`` with its Logits head, on its
    device) for a stack of [-1, 1] images [N, S, S, 3] (JAX
    ``inception_v4_class_probs`` :56): resized to 299 and kept in slim's
    [-1, 1] range.  Every batch has one shape: the last is padded with
    zeros, as JAX pads it to keep one compiled program."""
    from ..models.inception_v4 import inception_v4
    from ..ops.image import resize_bilinear_half_pixel
    device = _device_of(inception)
    out = []
    for i in range(0, len(images), batch_size):
        chunk = torch.from_numpy(np.ascontiguousarray(
            images[i:i + batch_size], np.float32)).to(device)
        pad = 0
        if len(chunk) < batch_size and out:
            pad = batch_size - len(chunk)
            chunk = torch.cat([chunk, chunk.new_zeros(
                (pad,) + tuple(chunk.shape[1:]))])
        _, eps = inception_v4(inception,
                              resize_bilinear_half_pixel(chunk, 299, 299))
        p = eps["Predictions"].cpu().numpy()
        out.append(p[:len(p) - pad] if pad else p)
    return np.concatenate(out)
