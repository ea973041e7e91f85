"""Matching evaluation harness (reference ``matching_main.py:244-417``):
cumulative IoU, precision@{0.5..0.9}, and instance mAP@[0.5:0.95].

Copy of ``sketchyscenecolorization_tpu/evaluation/harness.py`` on the
port's ``data/fixtures.py:get_pred_instance_mask``.  The model-facing side
is a callable ``predict(image_uint8, caption) -> binary mask`` (a
``MatchingEngine.predict_mask`` bound method in practice), so the harness
is model-agnostic and testable with stub predictors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..data.fixtures import get_pred_instance_mask
from .metrics import MAP_IOU_THRESHOLDS, compute_ap, compute_mask_IU

EVAL_SEG_IOU_LIST = (0.5, 0.6, 0.7, 0.8, 0.9)


@dataclasses.dataclass
class SegEvalResult:
    cum_iou: float
    precision_at: Dict[float, float]
    map_list: Optional[np.ndarray] = None    # per-threshold mAP (10 values)
    mean_ap: Optional[float] = None
    num_samples: int = 0

    def summary(self) -> str:
        lines = ["Segmentation evaluation (without DenseCRF):"]
        for t in EVAL_SEG_IOU_LIST:
            lines.append(f"precision@{t} = {self.precision_at[t]:.6f}")
        lines.append(f"overall IoU = {self.cum_iou:.6f}")
        if self.mean_ap is not None:
            lines.append(f"iou_threshold @[0.5:0.95],  mAP = {self.mean_ap}")
            lines.append(f"mAP_list = {self.map_list}")
        return "\n".join(lines)


class MatchingEvaluator:
    """Accumulates per-(image, caption) predictions into the eval metrics."""

    def __init__(self, compute_mask_ap: bool = True):
        self.compute_mask_ap = compute_mask_ap
        self.cum_i = 0
        self.cum_u = 0
        self.seg_correct = np.zeros(len(EVAL_SEG_IOU_LIST), np.int64)
        self.seg_total = 0
        self.aps: List[np.ndarray] = []

    def add(self, predicts: np.ndarray, target_mask: np.ndarray,
            caption_gt_masks: Optional[np.ndarray] = None,
            segm_data_npz_path: Optional[str] = None) -> float:
        """``predicts``: binary [H, W]; ``target_mask``: binary [H, W];
        ``caption_gt_masks``: [H, W, nGT] for the AP computation.
        Returns this sample's IoU."""
        i, u = compute_mask_IU(predicts.copy(), target_mask)
        self.cum_i += i
        self.cum_u += u
        iou = i / u if u > 0 else 0.0
        for n, t in enumerate(EVAL_SEG_IOU_LIST):
            self.seg_correct[n] += (iou >= t)
        self.seg_total += 1

        if self.compute_mask_ap and caption_gt_masks is not None:
            pred_masks, pred_scores, _, _, _ = get_pred_instance_mask(
                segm_data_npz_path, predicts.copy())
            ap_list = np.zeros([len(MAP_IOU_THRESHOLDS)], np.float32)
            if np.asarray(pred_scores).shape[0] != 0:
                for j, thr in enumerate(MAP_IOU_THRESHOLDS):
                    ap, _, _, _ = compute_ap(caption_gt_masks, pred_scores,
                                             pred_masks, iou_threshold=thr)
                    ap_list[j] = ap
            self.aps.append(ap_list)
        return iou

    def result(self) -> SegEvalResult:
        precision_at = {t: float(self.seg_correct[n] / max(self.seg_total, 1))
                        for n, t in enumerate(EVAL_SEG_IOU_LIST)}
        res = SegEvalResult(
            cum_iou=float(self.cum_i / max(self.cum_u, 1)),
            precision_at=precision_at, num_samples=self.seg_total)
        if self.compute_mask_ap and self.aps:
            aps = np.stack(self.aps)
            res.map_list = aps.mean(axis=0)
            res.mean_ap = float(aps.mean())
        return res
