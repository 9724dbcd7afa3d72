"""Feature Pyramid Network with the ``pool`` extra level (port of
``cald_tpu/models/fpn.py``): 1x1 laterals, nearest top-down upsampling with
add, 3x3 output convs, and LastLevelMaxPool (stride-2 subsampling of the last
output) for the RPN-only P6. NCHW in and out."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cald_tpu_torch.models.layers import Conv


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 dtype: torch.dtype | None = None):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", Conv(c, out_channels, 1, dtype=dtype))
            self.add_module(f"output{i}", Conv(out_channels, out_channels, 3, padding=1,
                                               dtype=dtype))
        self.num_in = len(in_channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        n = self.num_in
        laterals = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        merged = [None] * n
        merged[n - 1] = laterals[n - 1]
        for i in range(n - 2, -1, -1):
            h, w = laterals[i].shape[-2:]
            # nearest with half-pixel centres, as jax.image.resize(method="nearest")
            merged[i] = laterals[i] + F.interpolate(merged[i + 1], size=(h, w),
                                                    mode="nearest-exact")
        outs = [getattr(self, f"output{i}")(m) for i, m in enumerate(merged)]
        outs.append(outs[-1][:, :, ::2, ::2])
        return outs
