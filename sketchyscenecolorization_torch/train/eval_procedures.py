"""Evaluation procedures (``sketchyscenecolorization_tpu/train/eval_procedures.py``):
the single-instruction matching visualization so far; the evaluation
loops are ROADMAP item A11."""
from __future__ import annotations

import os

import numpy as np

from ..data.fixtures import load_sketch_image
from ..utils.visualization import visualize_sem_seg


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
