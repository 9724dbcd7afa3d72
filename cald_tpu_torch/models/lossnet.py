"""LL4AL loss-prediction module (port of ``cald_tpu/models/lossnet.py``).

Per pyramid level: global average pool -> Dense(interm_dim) -> ReLU; the
concatenated level embeddings feed a final Dense(1) predicting the task loss.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cald_tpu_torch.models.layers import Dense


class LossNet(nn.Module):
    """``in_channels`` is the levels' channel count (the FPN's 256), or one
    count per level (the CIFAR ResNet's 64/128/256/512), as Flax's Dense
    layers take the widths they are given."""

    def __init__(self, num_levels: int = 4, interm_dim: int = 128,
                 in_channels: int | Sequence[int] = 256):
        super().__init__()
        self.num_levels = num_levels
        widths = [in_channels] * num_levels if isinstance(in_channels, int) else in_channels
        for i in range(num_levels):
            self.add_module(f"fc{i}", Dense(widths[i], interm_dim))
        self.linear = Dense(num_levels * interm_dim, 1)

    def forward(self, pyramid: Sequence[torch.Tensor]) -> torch.Tensor:
        """pyramid: NCHW levels, finest first; returns (B,) predicted losses.
        The pool runs in the level's dtype (bf16 in bf16 runs, summed in
        float32 and rounded), then the Dense layers in float32, as Flax
        promotes a bf16 input to its float32 kernel."""
        embs = [F.relu(getattr(self, f"fc{i}")(f.mean(dim=(2, 3)).float()))
                for i, f in enumerate(pyramid[: self.num_levels])]
        return self.linear(torch.cat(embs, dim=-1))[:, 0]


def loss_pred_loss(pred: torch.Tensor, target: torch.Tensor,
                   margin: float = 1.0) -> torch.Tensor:
    """LL4AL margin-ranking loss (reference ll4al/main.py:64-83).

    Pairs (i, flip(i)) over the batch: hinge on whether the predicted-loss
    difference agrees in sign with the true-loss difference. With an odd
    batch the last entry is left out; the target is detached.
    """
    half = pred.shape[0] // 2
    target = target.detach()
    p = pred[: 2 * half]
    t = target[: 2 * half]
    pdiff = p[:half] - p[half:].flip(0)
    tdiff = t[:half] - t[half:].flip(0)
    sign = torch.where(tdiff > 0, 1.0, -1.0).to(pdiff.dtype)
    loss = (margin - sign * pdiff).clamp_min(0.0)
    return loss.sum() / max(half, 1)
