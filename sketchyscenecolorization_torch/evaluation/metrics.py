"""Evaluation metrics (reference ``Instance_Matching/utils/eval_tools.py``).

Copy of ``sketchyscenecolorization_tpu/evaluation/metrics.py`` (the port
imports nothing of the JAX package); NumPy, so its numbers equal JAX's.
COCO-style AP with greedy GT matching and a VOC precision envelope; mask
I/U as plain logical sums.  The overlaps matrix is one matmul
(``compute_overlaps_masks``); the per-prediction greedy assignment keeps
its sequential semantics (it is order-dependent by design).

Provenance: the ``compute_ap``/``compute_overlaps_masks`` algorithm in the
reference (``eval_tools.py:34-113``) is itself lifted from matterport's
Mask R-CNN ``utils.py`` (MIT license); its exact numerics are the metric
spec the reference evaluates with.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

MAP_IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10, endpoint=True)


def compute_bbox_iou(bboxes, target) -> np.ndarray:
    """[xmin,ymin,xmax,ymax] inclusive boxes -> IoU against one target."""
    bboxes = np.asarray(bboxes).reshape((-1, 4))
    target = np.asarray(target).reshape((-1, 4))
    a_boxes = (bboxes[..., 2] - bboxes[..., 0] + 1) * (bboxes[..., 3] - bboxes[..., 1] + 1)
    a_target = (target[..., 2] - target[..., 0] + 1) * (target[..., 3] - target[..., 1] + 1)
    ix1 = np.maximum(bboxes[..., 0], target[..., 0])
    iy1 = np.maximum(bboxes[..., 1], target[..., 1])
    ix2 = np.minimum(bboxes[..., 2], target[..., 2])
    iy2 = np.minimum(bboxes[..., 3], target[..., 3])
    a_i = np.maximum(ix2 - ix1 + 1, 0) * np.maximum(iy2 - iy1 + 1, 0)
    return a_i / (a_boxes + a_target - a_i)


def compute_mask_IU(masks: np.ndarray, target: np.ndarray) -> Tuple[int, int]:
    assert target.shape[-2:] == masks.shape[-2:]
    i = np.sum(np.logical_and(masks, target))
    u = np.sum(np.logical_or(masks, target))
    return i, u


def compute_overlaps_masks(masks1: np.ndarray, masks2: np.ndarray) -> np.ndarray:
    """IoU overlaps between two mask sets, each [H, W, instances]."""
    m1 = np.reshape(masks1 > 0.5, (-1, masks1.shape[-1])).astype(np.float32)
    m2 = np.reshape(masks2 > 0.5, (-1, masks2.shape[-1])).astype(np.float32)
    area1 = m1.sum(axis=0)
    area2 = m2.sum(axis=0)
    inter = m1.T @ m2
    union = area1[:, None] + area2[None, :] - inter
    return inter / union


def compute_ap(gt_masks: np.ndarray, pred_scores: np.ndarray,
               pred_masks: np.ndarray, iou_threshold: float = 0.5):
    """AP at one IoU threshold; returns (AP, precisions, recalls, overlaps)."""
    indices = np.argsort(pred_scores)[::-1]
    pred_masks = pred_masks[..., indices]

    overlaps = compute_overlaps_masks(pred_masks, gt_masks)

    pred_match = np.zeros([pred_masks.shape[2]])
    gt_match = np.zeros([gt_masks.shape[2]])
    for i in range(pred_masks.shape[2]):
        for j in np.argsort(overlaps[i])[::-1]:
            if gt_match[j] == 1:
                continue
            if overlaps[i, j] < iou_threshold:
                break
            gt_match[j] = 1
            pred_match[i] = 1
            break

    precisions = np.cumsum(pred_match) / (np.arange(len(pred_match)) + 1)
    recalls = np.cumsum(pred_match).astype(np.float32) / len(gt_match)
    precisions = np.concatenate([[0], precisions, [0]])
    recalls = np.concatenate([[0], recalls, [1]])
    # VOC envelope
    for i in range(len(precisions) - 2, -1, -1):
        precisions[i] = np.maximum(precisions[i], precisions[i + 1])
    idx = np.where(recalls[:-1] != recalls[1:])[0] + 1
    ap = np.sum((recalls[idx] - recalls[idx - 1]) * precisions[idx])
    return ap, precisions, recalls, overlaps
