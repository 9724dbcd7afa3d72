"""Anchor/proposal to ground-truth matching and balanced sampling, on fixed
shapes (port of ``cald_tpu/models/matcher.py``).

torchvision ``Matcher`` + ``BalancedPositiveNegativeSampler`` semantics over an
explicit batch dimension. Match codes: matched gt index >= 0, BELOW = -1,
BETWEEN = -2. Sampling is Gumbel-top-k; its noise comes in through a ``Draw``
so that tests can inject the JAX package's.
"""

from __future__ import annotations

from typing import Callable

import torch

from plainref.ops.boxes import box_iou

BELOW = -1
BETWEEN = -2

# draw(stream, shape) -> standard Gumbel noise (float32) on the caller's device
Draw = Callable[[int, tuple], torch.Tensor]


def generator_gumbel(generator: torch.Generator) -> Draw:
    """A ``Draw`` of standard Gumbel noise taken from ``generator``."""
    tiny = torch.finfo(torch.float32).tiny

    def draw(stream: int, shape: tuple) -> torch.Tensor:
        u = torch.rand(shape, generator=generator, device=generator.device)
        return -torch.log(-torch.log(u.clamp_min(tiny)))

    return draw


def match_anchors(gt_boxes: torch.Tensor, gt_valid: torch.Tensor, anchors: torch.Tensor, *,
                  high: float, low: float, allow_low_quality: bool) -> torch.Tensor:
    """Match each anchor to a gt box (torchvision ``Matcher``).

    gt_boxes (B, G, 4) padded; gt_valid (B, G); anchors (N, 4) or (B, N, 4).
    Returns (B, N) int64 match codes. With no valid gt every anchor is BELOW.
    """
    iou = box_iou(gt_boxes, anchors)                                  # (B, G, N)
    iou = torch.where(gt_valid[..., None], iou, torch.full_like(iou, -1.0))
    best_val, best_gt = iou.max(dim=1)          # first maximum, as jnp.argmax
    below = torch.full_like(best_gt, BELOW)
    between = torch.full_like(best_gt, BETWEEN)
    matches = torch.where(best_val >= high, best_gt,
                          torch.where(best_val < low, below, between))
    if allow_low_quality:
        # anchors that reach a gt's best IoU get their best match back
        gt_max = iou.amax(dim=2, keepdim=True)                        # (B, G, 1)
        is_best = (iou == gt_max) & gt_valid[..., None] & (gt_max > 0)
        matches = torch.where(is_best.any(dim=1), best_gt, matches)
    return torch.where(gt_valid.any(dim=1, keepdim=True), matches, below)


def _top_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis; ties go to the lower
    index, as with ``jax.lax.top_k``."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def balanced_sample(matches: torch.Tensor, draw: Draw, *, num_samples: int,
                    positive_fraction: float, stream: int = 0):
    """Sample positives and negatives like ``BalancedPositiveNegativeSampler``.

    matches (B, N) match codes. Up to ``num_samples * positive_fraction``
    positives uniformly at random, then random negatives (BETWEEN entries are
    never sampled); extra negatives fill in when positives are short. The
    positives' Gumbel noise is ``draw(stream, (B, N))``, the negatives'
    ``draw(stream + 1, (B, N))``.

    Returns indices (B, num_samples) int64 laid out positives first, then
    negatives, then padding, and the is_pos / valid masks.
    """
    b, n = matches.shape
    pos_mask = matches >= 0
    neg_mask = matches == BELOW
    num_pos_target = int(round(num_samples * positive_fraction))
    gp = draw(stream, (b, n)).to(matches.device).masked_fill(~pos_mask, float("-inf"))
    gn = draw(stream + 1, (b, n)).to(matches.device).masked_fill(~neg_mask, float("-inf"))

    num_pos = pos_mask.sum(dim=1, keepdim=True).clamp_max(num_pos_target)      # (B, 1)
    num_neg = torch.minimum(num_samples - num_pos, neg_mask.sum(dim=1, keepdim=True))
    pos_idx = _top_indices(gp, num_samples)
    neg_idx = _top_indices(gn, num_samples)

    ranks = torch.arange(num_samples, device=matches.device)[None]
    take_pos = ranks < num_pos
    neg_slot = (ranks - num_pos).clamp(0, num_samples - 1)
    idx = torch.where(take_pos, pos_idx, torch.gather(neg_idx, 1, neg_slot))
    return idx, take_pos, ranks < num_pos + num_neg
