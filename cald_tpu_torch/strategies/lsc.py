"""LS/C baseline: localization stability under noise (port of
``cald_tpu/strategies/lsc.py``; reference ls_c_train.py:108-155).

Per image: a base detect; keep the top 30 detections by prob_max; U = max(1 -
prob_max); for 6 gaussian-noise levels (std 8..48) re-detect and accumulate
each reference box's best unclamped IoU against the noisy detections;
stability = sum / 6; score = sum(prob_max * stability) / sum(prob_max) - U.
Ascending selection. All noisy variants of a batch are detected in one
batched forward of B x 6 images.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from cald_tpu_torch.augment.photometric import gaussian_noise
from cald_tpu_torch.augment.suite import Draw, generator_draw
from cald_tpu_torch.ops.boxes import pairwise_iou_nocheck

NOISE_STDS = (8.0, 16.0, 24.0, 32.0, 40.0, 48.0)


def _top30(dets, k: int = 30):
    """The top-k detections by prob_max (ls_c_train.py:122-124) in fixed
    slots, invalid slots last; ties keep the lower slot first, as
    ``jax.lax.top_k`` does. Returns (boxes, prob_max, valid)."""
    pm = torch.where(dets.valid, dets.prob_max, torch.full_like(dets.prob_max, -float("inf")))
    idx = torch.sort(pm, dim=-1, descending=True, stable=True).indices[:, :min(k, pm.shape[-1])]
    boxes = torch.gather(dets.boxes, 1, idx[..., None].expand(-1, -1, 4))
    return (boxes, torch.gather(dets.prob_max, 1, idx), torch.gather(dets.valid, 1, idx))


def make_lsc_score_fn(model, stds: Sequence[float] = NOISE_STDS) -> Callable:
    """Returns ``score_batch(images, valid_hw, draw) -> scores (B,)``.
    ``draw(i, shape, kind="normal")`` supplies the standard normals of noise
    level i, one (H, W, C) draw per image (``generator_draw`` for a
    ``torch.Generator``)."""
    s = len(stds)

    @torch.inference_mode()
    def score_batch(images: torch.Tensor, valid_hw: torch.Tensor, draw: Draw):
        b = images.shape[0]
        ref_boxes, prob_max, ref_valid = _top30(model.detect(images, valid_hw))

        noisy = torch.stack([
            gaussian_noise(images, valid_hw,
                           draw(i, tuple(images.shape), kind="normal").to(images.device), std)
            for i, std in enumerate(stds)], dim=1)                 # (B, S, H, W, C)
        dets = model.detect(noisy.reshape((b * s,) + images.shape[1:]),
                            valid_hw[:, None].expand(b, s, 2).reshape(b * s, 2))
        k_det = dets.boxes.shape[1]
        det_boxes = dets.boxes.reshape(b, s, k_det, 4)
        det_valid = dets.valid.reshape(b, s, k_det)

        # per (image, noise level, reference box): the best unclamped IoU
        # over the noisy detections
        iou = pairwise_iou_nocheck(ref_boxes[:, None], det_boxes[:, :, None])  # (B, S, K, Kd)
        iou = torch.where(det_valid[:, :, None, :], iou, torch.full_like(iou, -1.0))
        best = iou.amax(dim=-1).clamp_min(0.0)                      # (B, S, K)
        # an empty noisy output contributes 0 (the reference `continue`s)
        best = torch.where(det_valid.any(dim=-1)[:, :, None], best, torch.zeros_like(best))
        stability = best.sum(dim=1) / s                             # (B, K)

        pm = torch.where(ref_valid, prob_max, torch.zeros_like(prob_max))
        num = (pm * stability).sum(dim=-1)
        den = pm.sum(dim=-1).clamp_min(1e-12)
        u_max = torch.where(ref_valid, 1.0 - prob_max,
                            torch.full_like(prob_max, -float("inf"))).amax(dim=-1)
        score = num / den - u_max
        # zero-detection images score 0.0 (ls_c_train.py:119-121)
        return torch.where(ref_valid.any(dim=-1), score, torch.zeros_like(score))

    return score_batch


def lsc_scores(score_fn: Callable, loader: Iterable, pool_indices: Sequence[int],
               generator: torch.Generator) -> np.ndarray:
    """Score a pool with the noise normals of ``generator`` (on the device
    where the batches are scored); returns (N,) float64 aligned with
    ``pool_indices``."""
    pos = {int(idx): i for i, idx in enumerate(pool_indices)}
    out = np.zeros((len(pool_indices),))
    draw = generator_draw(generator)
    for batch in loader:
        images = torch.from_numpy(np.asarray(batch.images, np.float32)).to(generator.device)
        valid_hw = torch.from_numpy(np.asarray(batch.valid_hw)).to(generator.device)
        sc = score_fn(images, valid_hw, draw).double().cpu().numpy()
        for i, idx in enumerate(batch.image_idx):
            out[pos[int(idx)]] = sc[i]
    return out
