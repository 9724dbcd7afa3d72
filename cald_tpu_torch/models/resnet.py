"""ResNet backbone (port of ``cald_tpu/models/resnet.py``).

Tensors are NCHW; the detector passes them in ``torch.channels_last`` memory
format. Module names follow the JAX package (``layer{stage}_{block}``,
``conv1..3``, ``downsample_conv``), with the Flax auto-named norms given
torchvision's names (``bn1..3``, ``downsample_bn``). ``norm`` is "frozen"
(FrozenBatchNorm, the reference's) or "group" (Flax's GroupNorm,
``models/layers.py::make_norm``).

The fused inference configuration is opt-in and frozen-norm only, as in
the JAX package: ``forward(x, allow_fused=True)`` with
``CALD_TPU_PALLAS_BNECK`` set and ``norm="frozen"`` runs
each stage's stride-1 identity suffix with every frozen norm folded into its
conv, through ``fused_block_kernel`` (K5) once per block (``"1"`` or any
other non-empty value) or ``fused_stage_kernel`` (K6) per group of chained
blocks (``"stage"``); block 0 of each stage runs the plain path. The Hopper
kernels run for CUDA tensors and the plain versions for CPU tensors.
Documented difference: the JAX package fuses only on a TPU backend and
falls back to XLA where Mosaic finds no tiling with ``TW % 8 == 0`` (for
example a stage 4 pixels wide); the port fuses every suffix, whatever its
shape, which computes the same function.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cald_tpu_torch.models.layers import Conv, make_norm
from cald_tpu_torch.ops.bottleneck import fold_frozen
from cald_tpu_torch.ops.bottleneck_cuda import fused_block_kernel, fused_stage_kernel


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4) with a projection shortcut on a shape
    change."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dtype: torch.dtype | None = None, norm: str = "frozen"):
        super().__init__()
        out_ch = planes * 4
        make = make_norm(norm)
        self.conv1 = Conv(in_ch, planes, 1, bias=False, dtype=dtype)
        self.bn1 = make(planes)
        self.conv2 = Conv(planes, planes, 3, stride=stride, padding=1, bias=False,
                          dtype=dtype)
        self.bn2 = make(planes)
        self.conv3 = Conv(planes, out_ch, 1, bias=False, dtype=dtype)
        self.bn3 = make(out_ch)
        if in_ch != out_ch or stride != 1:
            self.downsample_conv = Conv(in_ch, out_ch, 1, stride=stride, bias=False,
                                        dtype=dtype)
            self.downsample_bn = make(out_ch)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + identity)

    def folded(self) -> tuple:
        """The folded tuple of a stride-1 identity block: (w1 (P, C), b1,
        w2 (P, P, 3, 3), b2, w3 (C, P), b3), float32, each frozen norm folded
        into its conv (``ops/bottleneck.py``)."""
        if self.downsample_conv is not None or self.conv2.stride != 1:
            raise ValueError("folded needs a stride-1 identity block")
        w1, b1 = fold_frozen(self.conv1.weight[:, :, 0, 0], *self.bn1.fold())
        w2, b2 = fold_frozen(self.conv2.weight, *self.bn2.fold())
        w3, b3 = fold_frozen(self.conv3.weight[:, :, 0, 0], *self.bn3.fold())
        return w1, b1, w2, b2, w3, b3


class ResNetBackbone(nn.Module):
    """Returns the C2..C5 maps as a dict {'c2': ..., 'c5': ...} (NCHW).

    blocks_per_stage (3, 4, 6, 3) at width 64 is ResNet-50; (1, 1, 1, 1) at
    width 16 is the ``tiny`` CPU-testable variant.
    """

    def __init__(self, blocks_per_stage: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 dtype: torch.dtype | None = None, norm: str = "frozen"):
        super().__init__()
        self.norm = norm
        self.conv1 = Conv(3, width, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.bn1 = make_norm(norm)(width)
        self.stages = []
        in_ch = width
        for stage, n_blocks in enumerate(blocks_per_stage):
            planes = width * 2 ** stage
            names = []
            for b in range(n_blocks):
                name = f"layer{stage + 1}_{b}"
                stride = 2 if (b == 0 and stage > 0) else 1
                self.add_module(name, Bottleneck(in_ch, planes, stride, dtype, norm))
                in_ch = planes * 4
                names.append(name)
            self.stages.append(names)
        self.out_channels = tuple(width * 2 ** s * 4 for s in range(len(blocks_per_stage)))

    def _fuse_gate(self) -> str:
        """``CALD_TPU_PALLAS_BNECK``: "" (the default) off, "stage" for K6,
        any other value for K5; always off under group norm, which has no
        affine form to fold."""
        if self.norm != "frozen":
            return ""
        return os.environ.get("CALD_TPU_PALLAS_BNECK", "")

    def forward(self, x: torch.Tensor, *, allow_fused: bool = False) -> dict[str, torch.Tensor]:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        fuse = self._fuse_gate() if allow_fused else ""
        feats = {}
        for stage, names in enumerate(self.stages):
            blocks = [getattr(self, name) for name in names]
            y = blocks[0](y)
            if fuse and len(blocks) > 1:
                folded = [blk.folded() for blk in blocks[1:]]
                if fuse == "stage":
                    y = fused_stage_kernel(y, folded)
                else:
                    for f in folded:
                        y = fused_block_kernel(y, f)
            else:
                for blk in blocks[1:]:
                    y = blk(y)
            feats[f"c{stage + 2}"] = y
        return feats
