"""Anchor generation (port of ``cald_tpu/models/anchors.py``, torchvision
``AnchorGenerator`` semantics): cell anchors h = s*sqrt(a), w = s/sqrt(a),
rounded, placed at every ``stride`` offset in (y, x, anchor) row-major order."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

# the reference's anchor schedules
FRCNN_SIZES = ((32,), (64,), (128,), (256,), (512,))                 # frcnn_la.py:186-190
RETINA_SIZES = tuple(tuple(x * 2 ** (i / 3) for i in range(3))
                     for x in (32, 64, 128, 256, 512))             # retinanet_cal.py:347
MOBILE_RETINA_SIZES = ((16, 32, 64, 128, 256),)                    # retinanet_cal.py:663
ASPECT_RATIOS = (0.5, 1.0, 2.0)


def cell_anchors(sizes: Sequence[float], aspect_ratios: Sequence[float]) -> np.ndarray:
    """(len(sizes)*len(aspects), 4) xyxy anchors centred at the origin."""
    out = []
    for s in sizes:
        for a in aspect_ratios:
            h = s * math.sqrt(a)
            w = s / math.sqrt(a)
            out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.round(np.asarray(out, np.float32))


def grid_anchors_for_level(feat_h: int, feat_w: int, stride: int,
                           sizes: Sequence[float],
                           aspect_ratios: Sequence[float]) -> np.ndarray:
    """All anchors of one level, (H*W*A, 4)."""
    cells = cell_anchors(sizes, aspect_ratios)
    sx, sy = np.meshgrid(np.arange(feat_w, dtype=np.float32) * stride,
                         np.arange(feat_h, dtype=np.float32) * stride)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    return (shifts + cells[None]).reshape(-1, 4)


def generate_anchors(feat_shapes: Sequence[tuple[int, int]], strides: Sequence[int],
                     sizes_per_level: Sequence[Sequence[float]],
                     aspect_ratios: Sequence[float], device=None):
    """Anchors for a whole pyramid: (sum_l H_l*W_l*A, 4) float32 tensor and
    the per-level counts. A schedule of one size tuple is shared by every
    level."""
    if len(sizes_per_level) != len(feat_shapes):
        sizes_per_level = [sizes_per_level[0]] * len(feat_shapes)
    per_level = [grid_anchors_for_level(h, w, st, sz, aspect_ratios)
                 for (h, w), st, sz in zip(feat_shapes, strides, sizes_per_level)]
    counts = [len(a) for a in per_level]
    return torch.from_numpy(np.concatenate(per_level, axis=0)).to(device), counts
