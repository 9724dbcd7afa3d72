"""Faster R-CNN box head at inference, with the CALD extras (port of
``cald_tpu/models/roi_heads.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cald_tpu_torch.models.detections import Detections
from cald_tpu_torch.models.layers import Dense
from cald_tpu_torch.ops.boxes import clip_boxes, decode_boxes
from cald_tpu_torch.ops.nms import batched_nms

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
    b, n, c = class_logits.shape
    scores = torch.softmax(class_logits, dim=-1)                       # (B, N, C)
    boxes = decode_boxes(box_regression.reshape(b, n, c, 4), proposals,
                         weights=ROI_REG_WEIGHTS)                      # (B, N, C, 4)
    hw = valid_hw.to(boxes.dtype)
    boxes = clip_boxes(boxes, (hw[:, 0, None, None], hw[:, 1, None, None]))

    # foreground (class >= 1) instances, (proposal, class) row-major
    fg_scores = scores[:, :, 1:].reshape(b, -1)
    fg_boxes = boxes[:, :, 1:].reshape(b, -1, 4)
    fg_labels = torch.arange(1, c, device=scores.device).repeat(n).expand(b, -1)
    prop_idx = torch.arange(n, device=scores.device).repeat_interleave(c - 1)
    cand = (fg_scores > score_thresh) & prop_valid.repeat_interleave(c - 1, dim=1)

    keep_idx, mask = batched_nms(
        fg_boxes, fg_scores, fg_labels, iou_threshold=nms_thresh,
        max_outputs=detections_per_img, valid=cand,
        pre_nms_size=min(fg_boxes.shape[1], nms_pre_size))

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
