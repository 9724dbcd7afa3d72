"""Shared building blocks (port of ``cald_tpu/models/layers.py``).

``Conv`` and ``Dense`` keep float32 weights and compute in an optional
``dtype``, as Flax's ``nn.Conv(dtype=...)``/``nn.Dense(dtype=...)`` do: the
input, weight and bias are cast to ``dtype`` for the call. Weights use
PyTorch's layouts (OIHW, (out, in)); ``convert/from_flax.py`` maps Flax's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv(nn.Module):
    """2-D convolution on NCHW tensors with explicit symmetric padding."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, *, stride: int = 1,
                 padding: int = 0, bias: bool = True, dtype: torch.dtype | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.stride = stride
        self.padding = padding
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding)


class Dense(nn.Module):
    """Affine layer over the last axis."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class FrozenBatchNorm(nn.Module):
    """torchvision ``FrozenBatchNorm2d`` on NCHW tensors:
    ``y = (x - mean) * scale / sqrt(var + eps) + bias`` with every statistic a
    buffer. The affine form is folded in float32 and applied in the
    activation dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.eps = eps

    def fold(self):
        """(w, b) float32 such that norm(x) == x * w + b."""
        w = self.scale / torch.sqrt(self.var + self.eps)
        return w, self.bias - self.mean * w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.fold()
        return x * w.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]
