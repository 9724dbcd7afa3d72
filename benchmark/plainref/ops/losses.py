"""Detection losses, per element (port of ``cald_tpu/ops/losses.py``).

torchvision's ``sigmoid_focal_loss``, ``F.smooth_l1_loss`` with ``beta`` and
the cross entropy of the Faster R-CNN heads, with no reduction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross entropy with logits, per element."""
    return logits.clamp_min(0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, *,
                       alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Per-element focal loss (torchvision); targets are {0, 1} floats of the
    logits' shape."""
    p = torch.sigmoid(logits)
    ce = bce_with_logits(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    return loss


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, *,
                   beta: float = 1.0 / 9.0) -> torch.Tensor:
    """Per-element smooth-L1 (Huber) with transition point ``beta``."""
    diff = (pred - target).abs()
    if beta <= 0.0:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example cross entropy against integer ``labels`` over the last axis."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]
