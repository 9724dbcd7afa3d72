"""Faster R-CNN box head, with the CALD extras (port of
``cald_tpu/models/roi_heads.py``).

Training: gt boxes are appended to the proposals, matched at 0.5/0.5 (no
low-quality matches) and sampled 512 @ 25% positives; the losses are cross
entropy and smooth-L1 (beta 1/9) on the matched class's regression row, both
normalized by the sample count. Inference: softmax rows expand to (proposal,
class) instances, score filter 0.05, per-class NMS 0.5, top-100.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from plainref.models.detections import Detections
from plainref.models.layers import Dense
from plainref.models.matcher import BETWEEN, Draw, balanced_sample, match_anchors
from plainref.ops.boxes import clip_boxes, decode_boxes, encode_boxes
from plainref.ops.losses import smooth_l1_loss
from plainref.ops.nms import batched_nms
from plainref.ops.roi_align import multi_scale_roi_align

ROI_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


class TwoMLPHead(nn.Module):
    """flatten -> fc6 -> relu -> fc7 -> relu. The input is flattened in the
    JAX package's (7, 7, C) order."""

    def __init__(self, in_features: int, representation_size: int = 1024,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.fc6 = Dense(in_features, representation_size, dtype=dtype)
        self.fc7 = Dense(representation_size, representation_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.fc6(x.reshape(x.shape[0], -1)))
        return F.relu(self.fc7(x))


class FastRCNNPredictor(nn.Module):
    def __init__(self, in_features: int, num_classes: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.cls_score = Dense(in_features, num_classes, dtype=dtype)
        self.bbox_pred = Dense(in_features, num_classes * 4, dtype=dtype)

    def forward(self, x: torch.Tensor):
        """Returns float32 class logits (R, C) and box regression (R, 4C)."""
        return self.cls_score(x).float(), self.bbox_pred(x).float()


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (B, N, ...) gathered along N by idx (B, K) -> (B, K, ...)."""
    return torch.gather(a, 1, idx.reshape(idx.shape + (1,) * (a.dim() - 2)).expand(
        idx.shape + a.shape[2:]))


def select_training_samples(proposals: torch.Tensor, prop_valid: torch.Tensor,
                            gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                            gt_valid: torch.Tensor, draw: Draw, *,
                            batch_size_per_image: int = 512,
                            positive_fraction: float = 0.25, fg_iou: float = 0.5,
                            bg_iou: float = 0.5, stream: int = 2):
    """Pick the fixed training sample set of each image.

    proposals (B, P, 4), prop_valid (B, P), gt (B, G, ...). The gt boxes are
    appended to the proposals before matching (torchvision
    ``add_gt_proposals``); padding slots are never sampled. The sampler's
    noise is ``draw(stream)`` / ``draw(stream + 1)``.

    Returns rois (B, S, 4), labels (B, S) int64, reg_targets (B, S, 4),
    is_pos (B, S) and valid (B, S).
    """
    all_props = torch.cat([proposals, gt_boxes], dim=1)
    all_valid = torch.cat([prop_valid, gt_valid], dim=1)
    matches = match_anchors(gt_boxes, gt_valid, all_props, high=fg_iou, low=bg_iou,
                            allow_low_quality=False)
    matches = torch.where(all_valid, matches, torch.full_like(matches, BETWEEN))
    idx, is_pos, valid = balanced_sample(matches, draw, num_samples=batch_size_per_image,
                                         positive_fraction=positive_fraction, stream=stream)
    rois = _take(all_props, idx)
    m = torch.gather(matches, 1, idx).clamp_min(0)
    labels = torch.where(is_pos, torch.gather(gt_labels.long(), 1, m),
                         torch.zeros_like(m))
    reg_targets = encode_boxes(_take(gt_boxes, m), rois, weights=ROI_REG_WEIGHTS)
    return rois, labels, reg_targets, is_pos, valid


def fastrcnn_loss(class_logits: torch.Tensor, box_regression: torch.Tensor,
                  labels: torch.Tensor, reg_targets: torch.Tensor, is_pos: torch.Tensor,
                  valid: torch.Tensor):
    """Per-image losses: cross entropy over the sampled rois and smooth-L1 over
    the positives, both divided by the sample count. class_logits (B, S, C),
    box_regression (B, S, 4C). Returns (cls_loss (B,), box_loss (B,))."""
    b, s, c = class_logits.shape
    logp = F.log_softmax(class_logits, dim=-1)
    ce = -torch.gather(logp, 2, labels[..., None])[..., 0]
    vf = valid.to(ce.dtype)
    n_sampled = vf.sum(dim=1).clamp_min(1.0)
    cls_loss = (ce * vf).sum(dim=1) / n_sampled
    br = box_regression.reshape(b, s, c, 4)
    picked = torch.gather(br, 2, labels[..., None, None].expand(b, s, 1, 4))[:, :, 0]
    l1 = smooth_l1_loss(picked, reg_targets, beta=1.0 / 9.0).sum(dim=-1)
    box_loss = (l1 * (is_pos & valid).to(l1.dtype)).sum(dim=1) / n_sampled
    return cls_loss, box_loss


def pool_box_features(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                      valid: torch.Tensor, spatial_scales: Sequence[float], *,
                      output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """Training MultiScaleRoIAlign over the NHWC levels P2..P5: (B, S, 7, 7, C)
    float32, differentiable with respect to the levels (K2 forward and K3
    backward on the card). Invalid sample slots pool to zeros; the losses
    mask them, so losses and gradients equal pooling them. The rois get no
    gradient."""
    return multi_scale_roi_align(feats, rois.detach(), spatial_scales=spatial_scales,
                                 valid=valid, output_size=output_size,
                                 sampling_ratio=sampling_ratio, out_dtype=torch.float32)


def _fg_instances(class_logits: torch.Tensor, box_regression: torch.Tensor,
                  proposals: torch.Tensor, valid_hw: torch.Tensor):
    """Softmax rows (B, N, C) and the foreground (proposal, class) instances
    in row-major order: their scores (B, N(C-1)), decoded and clipped boxes
    (B, N(C-1), 4), labels (B, N(C-1)) and proposal indices (N(C-1),)."""
    b, n, c = class_logits.shape
    scores = torch.softmax(class_logits, dim=-1)                       # (B, N, C)
    boxes = decode_boxes(box_regression.reshape(b, n, c, 4), proposals,
                         weights=ROI_REG_WEIGHTS)                      # (B, N, C, 4)
    hw = valid_hw.to(boxes.dtype)
    boxes = clip_boxes(boxes, (hw[:, 0, None, None], hw[:, 1, None, None]))
    fg_scores = scores[:, :, 1:].reshape(b, -1)
    fg_boxes = boxes[:, :, 1:].reshape(b, -1, 4)
    fg_labels = torch.arange(1, c, device=scores.device).repeat(n).expand(b, -1)
    prop_idx = torch.arange(n, device=scores.device).repeat_interleave(c - 1)
    return scores, fg_scores, fg_boxes, fg_labels, prop_idx


def _detections(scores, fg_scores, fg_boxes, fg_labels, prop_idx, proposals,
                keep_idx: torch.Tensor, mask: torch.Tensor) -> Detections:
    """The kept instances ``keep_idx`` (B, K) as Detections, zero where
    ``mask`` is False."""
    c = scores.shape[-1]
    pidx = prop_idx[keep_idx]                                          # (B, K)
    m = mask.to(scores.dtype)
    row = torch.gather(scores, 1, pidx[..., None].expand(-1, -1, c))   # (B, K, C)
    return Detections(
        boxes=torch.gather(fg_boxes, 1, keep_idx[..., None].expand(-1, -1, 4)) * m[..., None],
        scores=torch.gather(fg_scores, 1, keep_idx) * m,
        labels=torch.gather(fg_labels, 1, keep_idx).to(torch.int32) * mask,
        valid=mask,
        scores_cls=row * m[..., None],
        prob_max=row[..., 1:].amax(dim=-1) * m,
        props=torch.gather(proposals, 1, pidx[..., None].expand(-1, -1, 4)) * m[..., None],
    )


def postprocess_detections(class_logits: torch.Tensor, box_regression: torch.Tensor,
                           proposals: torch.Tensor, prop_valid: torch.Tensor,
                           valid_hw: torch.Tensor, *, score_thresh: float = 0.05,
                           nms_thresh: float = 0.5, detections_per_img: int = 100,
                           nms_pre_size: int = 2048) -> Detections:
    """class_logits (B, N, C), box_regression (B, N, 4C), proposals (B, N, 4),
    prop_valid (B, N), valid_hw (B, 2) -> fixed-slot Detections (B, K, ...).

    The reference's postprocess: score filter > 0.05, per-class NMS 0.5, a
    global top-100; ``prob_max`` is the max over foreground classes; no
    small-box filter.
    """
    c = class_logits.shape[-1]
    inst = _fg_instances(class_logits, box_regression, proposals, valid_hw)
    _, fg_scores, fg_boxes, fg_labels, _ = inst
    cand = (fg_scores > score_thresh) & prop_valid.repeat_interleave(c - 1, dim=1)
    keep_idx, mask = batched_nms(
        fg_boxes, fg_scores, fg_labels, iou_threshold=nms_thresh,
        max_outputs=detections_per_img, valid=cand,
        pre_nms_size=min(fg_boxes.shape[1], nms_pre_size))
    return _detections(*inst, proposals, keep_idx, mask)
