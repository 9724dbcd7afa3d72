"""Shared building blocks (port of ``cald_tpu/models/layers.py``).

``Conv`` and ``Dense`` keep float32 weights and compute in an optional
``dtype``, as Flax's ``nn.Conv(dtype=...)``/``nn.Dense(dtype=...)`` do: the
input, weight and bias are cast to ``dtype`` for the call. Weights use
PyTorch's layouts (OIHW, (out, in)); ``convert/from_flax.py`` maps Flax's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Conv(nn.Module):
    """2-D convolution on NCHW tensors with explicit symmetric padding;
    ``groups`` as Flax's ``feature_group_count`` (``in_ch`` for a depthwise
    convolution)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, *, stride: int = 1,
                 padding: int = 0, bias: bool = True, groups: int = 1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.stride = stride
        self.padding = padding
        self.groups = groups
        self.dtype = dtype
        self.quant = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        x, w = x.to(dt), self.weight.to(dt)
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        return F.conv2d(x, w, bias, self.stride, self.padding, 1, self.groups)


class Dense(nn.Module):
    """Affine layer over the last axis."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype
        self.quant = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        x, w = x.to(dt), self.weight.to(dt)
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        return F.linear(x, w, self.bias.to(dt))


class Product(nn.Module):
    """A matrix product of two activations (``torch.matmul``), such as
    attention's QK^T and AV, computed in an optional ``dtype`` as ``Conv``
    and ``Dense`` compute theirs. It holds no weight; its ``quant`` rounds
    both operands, as theirs does."""

    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.quant = None

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or a.dtype
        a, b = a.to(dt), b.to(dt)
        if self.quant is not None:
            a, b = self.quant(a), self.quant(b)
        return torch.matmul(a, b)


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


class GroupNorm(nn.Module):
    """Flax's ``nn.GroupNorm`` on NCHW tensors, as the JAX package builds it:
    epsilon 1e-6, the mean and the fast variance ``E[x^2] - E[x]^2``
    (clamped at 0) reduced in float32 over each group's channels and pixels,
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in float32, the
    result cast to the activation dtype. ``weight`` (Flax's ``scale``) and
    ``bias`` are trainable."""

    def __init__(self, features: int, num_groups: int, eps: float = 1e-6):
        super().__init__()
        if features % num_groups:
            raise ValueError(f"{num_groups} groups do not divide {features} channels")
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.num_groups = num_groups
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        shape = (b, self.num_groups, c // self.num_groups)
        xf = x.float()
        # per-channel means first: every channel of a group has H*W pixels,
        # and the reductions keep the channels-last layout as it is
        mean = xf.mean(dim=(2, 3)).reshape(shape).mean(dim=-1, keepdim=True)
        mean_sq = (xf * xf).mean(dim=(2, 3)).reshape(shape).mean(dim=-1, keepdim=True)
        var = (mean_sq - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps).expand(shape).reshape(b, c) * self.weight
        mean = mean.expand(shape).reshape(b, c, 1, 1)
        return ((xf - mean) * mul[:, :, None, None] + self.bias[:, None, None]).to(x.dtype)


def group_count(features: int) -> int:
    """The JAX package's group rule: 32 groups, or gcd(C, 32) where 32 does
    not divide C (MobileNetV3's 72/120/960 channels)."""
    return math.gcd(features, 32) if features % 32 else 32


def make_norm(kind: str):
    """norm factory: 'frozen' (the reference's default) or 'group'."""
    if kind == "frozen":
        return FrozenBatchNorm
    if kind == "group":
        return lambda features: GroupNorm(features, group_count(features))
    raise ValueError(f"unknown norm kind {kind!r}")
