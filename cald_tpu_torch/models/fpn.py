"""Feature Pyramid Network (port of ``cald_tpu/models/fpn.py``): 1x1
laterals, nearest top-down upsampling with add, 3x3 output convs, and one of
the extra blocks:

  - ``pool``: LastLevelMaxPool, stride-2 subsampling of the last output
    (Faster R-CNN's RPN-only extra level);
  - ``p6p7``: LastLevelP6P7, P6 a stride-2 3x3 conv of the last OUTPUT (P5)
    and P7 one of relu(P6) (RetinaNet);
  - ``none``.

Levels of equal size (MobileNetV3's two stride-32 maps) add without
resampling. NCHW in and out."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cald_tpu_torch.models.layers import Conv


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 dtype: torch.dtype | None = None, extra: str = "pool"):
        super().__init__()
        if extra not in ("pool", "p6p7", "none"):
            raise ValueError(f"unknown extra block {extra!r}")
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", Conv(c, out_channels, 1, dtype=dtype))
            self.add_module(f"output{i}", Conv(out_channels, out_channels, 3, padding=1,
                                               dtype=dtype))
        if extra == "p6p7":
            self.p6 = Conv(out_channels, out_channels, 3, stride=2, padding=1, dtype=dtype)
            self.p7 = Conv(out_channels, out_channels, 3, stride=2, padding=1, dtype=dtype)
        self.num_in = len(in_channels)
        self.extra = extra

    def forward(self, feats: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        n = self.num_in
        laterals = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        merged = [None] * n
        merged[n - 1] = laterals[n - 1]
        for i in range(n - 2, -1, -1):
            h, w = laterals[i].shape[-2:]
            # nearest with half-pixel centres, as jax.image.resize(method="nearest")
            up = merged[i + 1]
            if up.shape[-2:] != (h, w):
                up = F.interpolate(up, size=(h, w), mode="nearest-exact")
            merged[i] = laterals[i] + up
        outs = [getattr(self, f"output{i}")(m) for i, m in enumerate(merged)]
        if self.extra == "pool":
            outs.append(outs[-1][:, :, ::2, ::2])
        elif self.extra == "p6p7":
            p6 = self.p6(outs[-1])
            outs.extend([p6, self.p7(F.relu(p6))])
        return outs
