"""The CALD consistency metric (port of ``cald_tpu/ops/consistency.py``).

Per (image b, aug a, reference box j)::

    iou_row  = IoU(aug_box[b,a,j], det_boxes[b,a,:])   (unclamped variant)
    best     = argmax(iou_row)
    value    = | max(iou_row) + 0.5*(1-JS)*(pm_ref[b,j] + pm_det[b,a,best]) - bp |
    consistency[b, a] = min(1, min over valid j of value)   (0 if aug a has no dets)
    consistency[b]    = mean over augs   (0 if the base image has no dets)
"""

from __future__ import annotations

import torch

from plainref.ops.boxes import pairwise_iou_nocheck
from plainref.ops.divergence import js_divergence


def cald_consistency(aug_boxes, ref_scores_cls, ref_prob_max, ref_valid,
                     det_boxes, det_scores_cls, det_prob_max, det_valid,
                     base_point: float) -> torch.Tensor:
    """aug_boxes (B, A, K, 4); ref_scores_cls (B, K, C); ref_prob_max, ref_valid
    (B, K); det_boxes (B, A, Kd, 4); det_scores_cls (B, A, Kd, C); det_prob_max,
    det_valid (B, A, Kd). Returns per-image consistency (B,)."""
    iou = pairwise_iou_nocheck(aug_boxes, det_boxes[:, :, None])    # (B, A, K, Kd)
    # invalid detections must never win the argmax
    iou = torch.where(det_valid[:, :, None, :], iou, torch.full_like(iou, -1.0))
    max_iou, best = iou.max(dim=-1)                                  # first max wins
    max_iou = max_iou.clamp_min(0.0)

    c = det_scores_cls.shape[-1]
    best_cls = torch.gather(det_scores_cls, 2, best[..., None].expand(*best.shape, c))
    best_pm = torch.gather(det_prob_max, 2, best)
    ref_cls = ref_scores_cls[:, None].expand_as(best_cls)
    js = js_divergence(ref_cls, best_cls)                            # (B, A, K)

    value = (max_iou + 0.5 * (1.0 - js) * (ref_prob_max[:, None, :] + best_pm)
             - base_point).abs()
    value = torch.where(ref_valid[:, None, :], value, torch.full_like(value, float("inf")))
    per_aug = value.min(dim=-1).values.clamp_max(1.0)                # (B, A)
    per_aug = torch.where(det_valid.any(dim=-1), per_aug, torch.zeros_like(per_aug))
    consistency = per_aug.mean(dim=-1)
    return torch.where(ref_valid.any(dim=-1), consistency, torch.zeros_like(consistency))


def class_correlation(scores: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                      num_fg_classes: int) -> torch.Tensor:
    """Per-class max detection score (the reference's ``cls_corr``): for each
    foreground class c (label c+1) the max score over its detections, else 0.
    scores/labels/valid (..., K) -> (..., num_fg_classes)."""
    classes = torch.arange(1, num_fg_classes + 1, device=labels.device)
    onehot = (labels[..., None] == classes).to(scores.dtype)         # (..., K, C)
    s = torch.where(valid, scores, torch.zeros_like(scores))
    return (onehot * s[..., None]).amax(dim=-2)
