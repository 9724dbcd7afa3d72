"""Box geometry on ``(..., 4)`` xyxy tensors (port of ``cald_tpu/ops/boxes.py``).

Same formulas as the JAX module: torchvision pairwise IoU, the CALD scoring IoU
that zeroes negative-extent intersections instead of clamping them, and the
torchvision box coder with the ``log(1000/16)`` clamp on dw/dh.
"""

from __future__ import annotations

import math

import torch

# torchvision clamps decoded dw/dh at log(1000/16) to avoid exp overflow.
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Box areas, ``(..., N)`` for input ``(..., N, 4)``."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def intersect(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """All-pairs intersection areas, clamped at zero: (..., N, 4) x
    (..., M, 4) -> (..., N, M)."""
    w = (torch.minimum(boxes1[..., :, None, 2], boxes2[..., None, :, 2])
         - torch.maximum(boxes1[..., :, None, 0], boxes2[..., None, :, 0])).clamp_min(0.0)
    h = (torch.minimum(boxes1[..., :, None, 3], boxes2[..., None, :, 3])
         - torch.maximum(boxes1[..., :, None, 1], boxes2[..., None, :, 1])).clamp_min(0.0)
    return w * h


def iou_one_vs_many(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of one box (..., 4) against (..., M, 4) -> (..., M), torchvision
    (clamped) semantics."""
    inter = intersect(box[..., None, :], boxes)[..., 0, :]
    union = area(box)[..., None] + area(boxes) - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-12),
                       torch.zeros((), dtype=inter.dtype, device=inter.device))


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU matrix (torchvision semantics): (..., N, 4) x (..., M, 4)
    -> (..., N, M)."""
    inter = intersect(boxes1, boxes2)
    union = area(boxes1)[..., :, None] + area(boxes2)[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-12),
                       torch.zeros((), dtype=inter.dtype, device=inter.device))


def pairwise_iou_nocheck(ref_box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """The CALD-scoring IoU of reference boxes ``(..., 4)`` against
    ``(..., M, 4)`` -> ``(..., M)``: the intersection extent is not clamped;
    entries with a negative width or height are zeroed afterwards."""
    rb = ref_box[..., None, :]
    width = torch.minimum(rb[..., 2], boxes[..., 2]) - torch.maximum(rb[..., 0], boxes[..., 0])
    height = torch.minimum(rb[..., 3], boxes[..., 3]) - torch.maximum(rb[..., 1], boxes[..., 1])
    inter = width * height
    denom = area(rb) + area(boxes) - inter
    iou = inter / torch.where(denom == 0, torch.ones_like(denom), denom)
    return torch.where((width < 0) | (height < 0), torch.zeros_like(iou), iou)


def clip_boxes(boxes: torch.Tensor, image_hw) -> torch.Tensor:
    """Clip boxes to ``[0, w] x [0, h]``; ``image_hw`` is (h, w), each a scalar
    or a tensor broadcastable against the leading dims of ``boxes``."""
    h, w = image_hw
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), torch.as_tensor(hi, dtype=v.dtype,
                                                                     device=v.device))

    return torch.stack([clip(boxes[..., 0], w), clip(boxes[..., 1], h),
                        clip(boxes[..., 2], w), clip(boxes[..., 3], h)], dim=-1)


def remove_small_boxes_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """Mask of the boxes with both sides >= ``min_size`` (torchvision
    ``remove_small_boxes``)."""
    return ((boxes[..., 2] - boxes[..., 0] >= min_size)
            & (boxes[..., 3] - boxes[..., 1] >= min_size))


def resize_boxes(boxes: torch.Tensor, from_hw, to_hw) -> torch.Tensor:
    """Rescale boxes from an image of size ``from_hw`` (h, w) to one of
    ``to_hw`` (the reference's frcnn_la.py:307-315)."""
    (fh, fw), (th, tw) = from_hw, to_hw
    ry, rx = th / fh, tw / fw
    return boxes * torch.stack([torch.as_tensor(v, dtype=boxes.dtype, device=boxes.device)
                                for v in (rx, ry, rx, ry)], dim=-1)


def _xyxy_to_cxcywh(boxes: torch.Tensor):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h, w, h


def encode_boxes(reference: torch.Tensor, proposals: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Encode ``reference`` boxes relative to ``proposals``
    (torchvision ``BoxCoder.encode_single``)."""
    wx, wy, ww, wh = weights
    px, py, pw, ph = _xyxy_to_cxcywh(proposals)
    gx, gy, gw, gh = _xyxy_to_cxcywh(reference)
    pw = pw.clamp_min(1e-8)
    ph = ph.clamp_min(1e-8)
    return torch.stack([wx * (gx - px) / pw, wy * (gy - py) / ph,
                        ww * torch.log(gw.clamp_min(1e-8) / pw),
                        wh * torch.log(gh.clamp_min(1e-8) / ph)], dim=-1)


def decode_boxes(deltas: torch.Tensor, proposals: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Decode regression ``deltas`` on top of ``proposals``. ``deltas`` may be
    ``(..., N, 4)`` or class-specific ``(..., N, C, 4)`` against proposals
    ``(..., N, 4)``."""
    wx, wy, ww, wh = weights
    px, py, pw, ph = _xyxy_to_cxcywh(proposals)
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp_max(BBOX_XFORM_CLIP)
    dh = (deltas[..., 3] / wh).clamp_max(BBOX_XFORM_CLIP)
    if deltas.dim() == proposals.dim() + 1:  # class-specific: (..., N, C, 4)
        px, py, pw, ph = (t[..., None] for t in (px, py, pw, ph))
    cx = dx * pw + px
    cy = dy * ph + py
    w = torch.exp(dw) * pw
    h = torch.exp(dh) * ph
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)
