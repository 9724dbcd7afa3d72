"""Geometry and detection ops on fixed-shape tensors (port of ``cald_tpu.ops``).

Variable-count box sets are padded tensors plus validity masks, as in the JAX
package, whose public names are exported here, with one difference:
``cald_tpu_torch.ops.nms`` and ``cald_tpu_torch.ops.roi_align`` stay the
submodules (the kernels' wrappers and tools import ``ops.roi_align`` as the
plain versions' module), so their functions are ``ops.nms.nms`` and
``ops.roi_align.roi_align``.
"""

from cald_tpu_torch.ops import nms, roi_align
from cald_tpu_torch.ops.boxes import (
    area,
    box_iou,
    clip_boxes,
    decode_boxes,
    encode_boxes,
    intersect,
    iou_one_vs_many,
    pairwise_iou_nocheck,
    remove_small_boxes_mask,
)
from cald_tpu_torch.ops.consistency import cald_consistency
from cald_tpu_torch.ops.divergence import js_divergence, kl_divergence
from cald_tpu_torch.ops.losses import sigmoid_focal_loss, smooth_l1_loss, softmax_cross_entropy
from cald_tpu_torch.ops.nms import batched_nms
from cald_tpu_torch.ops.roi_align import multi_scale_roi_align

__all__ = [
    "area",
    "box_iou",
    "clip_boxes",
    "decode_boxes",
    "encode_boxes",
    "intersect",
    "iou_one_vs_many",
    "pairwise_iou_nocheck",
    "remove_small_boxes_mask",
    "nms",
    "batched_nms",
    "js_divergence",
    "kl_divergence",
    "sigmoid_focal_loss",
    "smooth_l1_loss",
    "softmax_cross_entropy",
    "roi_align",
    "multi_scale_roi_align",
    "cald_consistency",
]
