"""Feature Pyramid Network (port of ``cald_tpu/models/fpn.py``): 1x1
laterals, nearest top-down upsampling with add, 3x3 output convs, and one of
the extra blocks:

  - ``pool``: LastLevelMaxPool, stride-2 subsampling of the last output
    (Faster R-CNN's RPN-only extra level);
  - ``p6p7``: LastLevelP6P7, P6 a stride-2 3x3 conv of the last OUTPUT (P5)
    and P7 one of relu(P6) (RetinaNet);
  - ``none``.

Levels of equal size (MobileNetV3's two stride-32 maps) add without
resampling. NCHW in and out.

On the trunk's inference route (``layers.inference_route``: CUDA inputs
with autograd off, after a backbone of frozen norms; ``norm`` names the
backbone's) each conv runs without its bias and one K8 pass
(``ops/conv_epilogue.py``) finishes it: a lateral with its bias plus the
coarser merged level, read at half resolution where the sizes are exactly
double (no upsample and no merge add of their own; other sizes are
resampled first), each output conv and P6/P7 with their bias."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cald_tpu_torch.models import layers
from cald_tpu_torch.models.layers import Conv
from cald_tpu_torch.ops.conv_epilogue import conv_epilogue_kernel


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 dtype: torch.dtype | None = None, extra: str = "pool", norm: str = "frozen"):
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
        self.norm = norm

    def forward(self, feats: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        return self._forward(feats, layers.inference_route(feats[0], self.lateral0, self.norm))

    def forward_folded(self, feats: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """``forward`` on the inference route, whatever the inputs' device."""
        return self._forward(feats, True)

    def _forward(self, feats: Sequence[torch.Tensor], fold: bool) -> list[torch.Tensor]:
        def conv(name: str, x: torch.Tensor, r: torch.Tensor | None = None) -> torch.Tensor:
            """The conv ``name`` on x, its bias and r added: the module
            chain, or one K8 pass on the route."""
            if fold:
                return conv_epilogue_kernel(*getattr(self, name).folded(x), r)
            y = getattr(self, name)(x)
            return y if r is None else y + r

        n = self.num_in
        merged = [None] * n
        merged[n - 1] = conv(f"lateral{n - 1}", feats[n - 1])
        for i in range(n - 2, -1, -1):
            h, w = feats[i].shape[-2:]          # a 1x1 lateral keeps the size
            up = merged[i + 1]
            uh, uw = up.shape[-2:]
            # nearest with half-pixel centres, as jax.image.resize(method="nearest");
            # K8 reads a level of exactly half the size itself
            if (uh, uw) != (h, w) and not (fold and (2 * uh, 2 * uw) == (h, w)):
                up = F.interpolate(up, size=(h, w), mode="nearest-exact").contiguous(
                    memory_format=torch.channels_last)
            merged[i] = conv(f"lateral{i}", feats[i], up)
        outs = [conv(f"output{i}", m) for i, m in enumerate(merged)]
        if self.extra == "pool":
            outs.append(outs[-1][:, :, ::2, ::2])
        elif self.extra == "p6p7":
            p6 = conv("p6", outs[-1])
            outs.extend([p6, conv("p7", F.relu(p6))])
        return outs
