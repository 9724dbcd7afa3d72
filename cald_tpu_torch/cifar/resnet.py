"""CIFAR ResNet-18 for the LL4AL demo (port of ``cald_tpu/cifar/resnet.py``;
reference ll4al/models/resnet.py, the kuangliu CIFAR variant: 3x3 stem, no
max-pool, BasicBlocks 2-2-2-2, a global pool at 4x4).

Forward takes NHWC images and returns (logits, [c1..c4]), the four stage
outputs (NCHW) that feed LossNet. The BatchNorms keep Flax's running
statistics (``FlaxBatchNorm2d``). Module names are the Flax module's, so
``convert.from_flax.module_state_dict`` maps its parameters.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cald_tpu_torch.models.layers import Conv, Dense


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm (epsilon 1e-5) updated as Flax's ``BatchNorm(momentum=0.9)``
    is: the running mean and variance keep 0.9 of their value and take 0.1
    of the batch's (torch's ``momentum=0.1``), the variance being the
    batch's biased one (``nn.BatchNorm2d`` takes the unbiased one).
    Training normalises with the batch's statistics, evaluation with the
    running ones. The training form is written out under autograd: the CPU
    ``F.batch_norm`` backward lost 1.5% of the stem's gradient in float32
    on a CIFAR batch of 8 (against float64), this form 4e-6."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
            self.num_batches_tracked += 1
        scale = self.weight * torch.rsqrt(var + self.eps)
        return x * scale[:, None, None] + (self.bias - mean * scale)[:, None, None]


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = FlaxBatchNorm2d(planes)
        self.conv2 = Conv(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FlaxBatchNorm2d(planes)
        self.shortcut = stride != 1 or in_planes != planes
        if self.shortcut:
            self.shortcut_conv = Conv(in_planes, planes, 1, stride=stride, bias=False)
            self.shortcut_bn = FlaxBatchNorm2d(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        if self.shortcut:
            x = self.shortcut_bn(self.shortcut_conv(x))
        return F.relu(y + x)


class CifarResNet18(nn.Module):
    """(B, 32, 32, 3) -> (logits (B, num_classes), [c1..c4] NCHW)."""

    def __init__(self, num_classes: int = 10, width: int = 64,
                 blocks_per_stage: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        self.conv1 = Conv(3, width, 3, padding=1, bias=False)
        self.bn1 = FlaxBatchNorm2d(width)
        self.blocks: list[list[str]] = []
        in_planes = width
        for stage, n_blocks in enumerate(blocks_per_stage):
            planes = width * 2 ** stage
            names = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                names.append(f"layer{stage + 1}_{b}")
                self.add_module(names[-1], BasicBlock(in_planes, planes, stride))
                in_planes = planes
            self.blocks.append(names)
        self.stage_channels = [width * 2 ** s for s in range(len(blocks_per_stage))]
        self.linear = Dense(in_planes, num_classes)

    def forward(self, x: torch.Tensor):
        y = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        feats = []
        for names in self.blocks:
            for name in names:
                y = getattr(self, name)(y)
            feats.append(y)
        # the reference's avg_pool2d(out4, 4) is the global pool at CIFAR sizes
        return self.linear(feats[-1].mean(dim=(2, 3))).float(), feats
