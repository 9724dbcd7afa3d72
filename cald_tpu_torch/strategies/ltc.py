"""LT/C baseline: localization tightness (port of
``cald_tpu/strategies/ltc.py``; reference lt_c_train.py:90-121).

Per detection: the legacy +1 IoU between the final box and the RPN proposal
it came from (``Detections.props``); the image's uncertainty is the minimum
over its detections of |iou + prob_max - 1|, capped at 1.0. Ascending
selection (least tight and confident first).
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from cald_tpu_torch.data.batching import images_tensor


def _legacy_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise legacy IoU of box pairs (..., 4): +1 on the intersection's
    width and height and on one side of each area (lt_c_train.py:90-101's
    conventions, asymmetric as they are)."""
    width = torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]) + 1.0
    height = torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]) + 1.0
    a_area = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1] + 1.0)
    b_area = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1] + 1.0)
    inter = width * height
    iou = inter / (a_area + b_area - inter)
    return torch.where((width <= 0) | (height <= 0), torch.zeros_like(iou), iou)


def ltc_scores(dets) -> torch.Tensor:
    """Batched uncertainty from a ``Detections``: (B,). Invalid slots count
    as +inf, so an image without detections scores 1.0."""
    u = (_legacy_iou(dets.boxes, dets.props) + dets.prob_max - 1.0).abs()
    u = torch.where(dets.valid, u, torch.full_like(u, float("inf")))
    return u.amin(dim=-1).clamp_max(1.0)


def make_ltc_score_fn(model) -> Callable:
    """Returns ``score_batch(images, valid_hw) -> uncertainty (B,)``."""
    @torch.inference_mode()
    def score_batch(images: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
        return ltc_scores(model.detect(images, valid_hw))

    return score_batch


def run_ltc(score_fn: Callable, loader: Iterable, pool_indices: Sequence[int],
            device) -> np.ndarray:
    """Score a pool; returns (N,) float64 aligned with ``pool_indices``. An
    image that no batch scored stays at +inf."""
    pos = {int(idx): i for i, idx in enumerate(pool_indices)}
    out = np.full((len(pool_indices),), np.inf)
    for batch in loader:
        images = images_tensor(batch.images, device)
        valid_hw = torch.from_numpy(np.asarray(batch.valid_hw)).to(device)
        u = score_fn(images, valid_hw).double().cpu().numpy()
        for i, idx in enumerate(batch.image_idx):
            out[pos[int(idx)]] = u[i]
    return out
