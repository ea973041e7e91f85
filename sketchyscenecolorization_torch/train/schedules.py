"""Learning-rate schedules (``sketchyscenecolorization_tpu/train/schedules.py``),
evaluated in float32 as the JAX schedules are.

- ``tf1_polynomial_decay``: TF1 ``tf.train.polynomial_decay`` (matching,
  ``RMI_model.py:356-358``; the BG GAN, ``bg_colorization_main.py:661-666``);
- ``fg_gan_lr_decay``: the FG GAN's linear decay floored at 0.2
  (``graph_single.py:139``).
"""
from __future__ import annotations

import numpy as np


def tf1_polynomial_decay(start_lr: float, end_lr: float, decay_steps: int,
                         power: float = 0.9):
    """TF1 ``tf.train.polynomial_decay`` (step clamped to ``decay_steps``),
    evaluated in float32 like the JAX schedule."""
    def schedule(step) -> float:
        s = np.minimum(np.float32(step), np.float32(decay_steps))
        frac = np.float32(1.0) - s / np.float32(decay_steps)
        return float(np.float32(start_lr - end_lr) * frac ** np.float32(power)
                     + np.float32(end_lr))
    return schedule


def fg_gan_lr_decay(step, max_iter_step: int) -> float:
    """max(0.2, 1 - step / max_iter_step * 0.9) in float32."""
    frac = np.float32(step) / np.float32(max_iter_step) * np.float32(0.9)
    return float(np.maximum(np.float32(0.2), np.float32(1.0) - frac))
