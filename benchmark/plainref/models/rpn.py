"""Region Proposal Network (port of ``cald_tpu/models/rpn.py``): the shared
head, proposal selection into fixed slots, and the loss with 256 sampled
anchors @ 50% positives (BCE objectness + smooth-L1 box regression, beta 1/9,
normalized by the sample count)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from plainref.models.layers import Conv
from plainref.models.matcher import Draw, balanced_sample, match_anchors
from plainref.ops.boxes import clip_boxes, decode_boxes, encode_boxes
from plainref.ops.losses import bce_with_logits, smooth_l1_loss
from plainref.ops.nms import batched_nms


class RPNHead(nn.Module):
    """3x3 conv + sibling 1x1 objectness / 4A deltas convs, shared across
    levels. Outputs are float32 and ordered (y, x, anchor) per level."""

    def __init__(self, num_anchors: int, channels: int = 256,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1, dtype=dtype)
        self.objectness = Conv(channels, num_anchors, 1, dtype=dtype)
        self.deltas = Conv(channels, num_anchors * 4, 1, dtype=dtype)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: NCHW levels -> objectness (B, N) and deltas (B, N, 4)."""
        obj_all, reg_all = [], []
        for f in feats:
            t = F.relu(self.conv(f))
            b = f.shape[0]
            obj_all.append(self.objectness(t).permute(0, 2, 3, 1).reshape(b, -1).float())
            reg_all.append(self.deltas(t).permute(0, 2, 3, 1).reshape(b, -1, 4).float())
        return torch.cat(obj_all, dim=1), torch.cat(reg_all, dim=1)


def select_proposals(objectness: torch.Tensor, deltas: torch.Tensor,
                     anchors: torch.Tensor, level_counts: Sequence[int],
                     valid_hw: torch.Tensor, *, pre_nms_top_n: int,
                     post_nms_top_n: int, nms_thresh: float = 0.7,
                     min_size: float = 1e-3):
    """objectness (B, N), deltas (B, N, 4), anchors (N, 4), valid_hw (B, 2).

    Returns proposals (B, post_nms_top_n, 4), their scores and validity.
    Anchors centred on canvas padding (outside ``valid_hw``) never become
    candidates, which makes detection independent of the canvas. The
    per-level top-k is a stable descending sort, so ties go to the lower
    index as with ``jax.lax.top_k``.
    """
    neg = -1e9
    cx = (anchors[:, 0] + anchors[:, 2]) * 0.5
    cy = (anchors[:, 1] + anchors[:, 3]) * 0.5
    hw = valid_hw.to(anchors.dtype)
    inside = (cx[None] < hw[:, 1:2]) & (cy[None] < hw[:, 0:1])
    objectness = torch.where(inside, objectness, torch.full_like(objectness, neg))

    sel_obj, sel_boxes, sel_lvl = [], [], []
    offset = 0
    for lvl, cnt in enumerate(level_counts):
        k = min(pre_nms_top_n, cnt)
        top_v, top_i = torch.sort(objectness[:, offset:offset + cnt], dim=1,
                                  descending=True, stable=True)
        top_v, top_i = top_v[:, :k], top_i[:, :k] + offset
        d = torch.gather(deltas, 1, top_i[..., None].expand(-1, -1, 4))
        sel_obj.append(top_v)
        sel_boxes.append(decode_boxes(d, anchors[top_i]))
        sel_lvl.append(torch.full_like(top_i, lvl))
        offset += cnt

    scores = torch.cat(sel_obj, dim=1)
    boxes = clip_boxes(torch.cat(sel_boxes, dim=1), (hw[:, 0:1], hw[:, 1:2]))
    lvls = torch.cat(sel_lvl, dim=1)
    ws = boxes[..., 2] - boxes[..., 0]
    hs = boxes[..., 3] - boxes[..., 1]
    keepable = (ws >= min_size) & (hs >= min_size) & (scores > neg / 2)

    probs = torch.sigmoid(scores)
    keep_idx, keep_valid = batched_nms(
        boxes, probs, lvls, iou_threshold=nms_thresh, max_outputs=post_nms_top_n,
        valid=keepable, pre_nms_size=min(boxes.shape[1], 4096))
    out_boxes = torch.gather(boxes, 1, keep_idx[..., None].expand(-1, -1, 4))
    out_scores = torch.gather(probs, 1, keep_idx)
    return (out_boxes * keep_valid[..., None], out_scores * keep_valid, keep_valid)


def rpn_loss(objectness: torch.Tensor, deltas: torch.Tensor, anchors: torch.Tensor,
             gt_boxes: torch.Tensor, gt_valid: torch.Tensor, draw: Draw, *,
             batch_size_per_image: int = 256, positive_fraction: float = 0.5,
             fg_iou: float = 0.7, bg_iou: float = 0.3, stream: int = 0):
    """Per-image RPN losses (objectness (B,), box (B,)). objectness (B, N),
    deltas (B, N, 4), anchors (N, 4), gt_boxes (B, G, 4), gt_valid (B, G).
    The sampler's noise is ``draw(stream)`` / ``draw(stream + 1)``."""
    matches = match_anchors(gt_boxes, gt_valid, anchors, high=fg_iou, low=bg_iou,
                            allow_low_quality=True)
    idx, is_pos, valid = balanced_sample(matches, draw, num_samples=batch_size_per_image,
                                         positive_fraction=positive_fraction, stream=stream)
    vf = valid.to(objectness.dtype)
    n_sampled = vf.sum(dim=1).clamp_min(1.0)
    bce = bce_with_logits(torch.gather(objectness, 1, idx), is_pos.to(objectness.dtype))
    obj_loss = (bce * vf).sum(dim=1) / n_sampled

    sel = idx[..., None].expand(-1, -1, 4)
    m = torch.gather(matches, 1, idx).clamp_min(0)[..., None].expand(-1, -1, 4)
    targets = encode_boxes(torch.gather(gt_boxes, 1, m), anchors[idx])
    l1 = smooth_l1_loss(torch.gather(deltas, 1, sel), targets, beta=1.0 / 9.0).sum(dim=-1)
    box_loss = (l1 * (is_pos & valid).to(l1.dtype)).sum(dim=1) / n_sampled
    return obj_loss, box_loss
