"""Evaluation of the port (``sketchyscenecolorization_tpu/evaluation``):
the matching metrics and their evaluator, and inception scores."""
from .metrics import (
    compute_bbox_iou, compute_mask_IU, compute_overlaps_masks, compute_ap,
    MAP_IOU_THRESHOLDS,
)
from .harness import EVAL_SEG_IOU_LIST, MatchingEvaluator, SegEvalResult
from .inception_score import (acgan_class_probs, inception_score,
                              inception_v4_class_probs)
