"""MobileNetV3-Large backbone (port of ``cald_tpu/models/mobilenetv3.py``).

The torchvision ``mobilenet_v3_large`` schedule: a stride-2 stem, 15
inverted-residual blocks (expand 1x1 where the width changes, depthwise kxk,
squeeze-excite, project 1x1) with ReLU or hard-swish, and the final
960-channel 1x1 conv. Tensors are NCHW. Module names follow the JAX package
(``stem``, ``block{i}`` with ``expand``/``depthwise``/``se``/``project``,
``lastconv``); the Flax auto-named norms are ``{conv}_bn`` here.

Squeeze-excite keeps the JAX package's dtypes: its two 1x1 convs have no
compute dtype there, so Flax promotes a bf16 input to their float32 kernels;
the gate's product with the bf16 activation is then float32, and
``project`` casts it back to its compute dtype. The squeeze mean runs over
the whole canvas, padding included.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cald_tpu_torch.models.layers import Conv, make_norm


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


class BneckCfg(NamedTuple):
    in_ch: int
    kernel: int
    expand: int
    out_ch: int
    se: bool
    act: str      # 'RE' or 'HS'
    stride: int


# torchvision mobilenet_v3_large schedule (the reference's mobilenetv3.py:231-253)
LARGE_CFG: tuple[BneckCfg, ...] = (
    BneckCfg(16, 3, 16, 16, False, "RE", 1),
    BneckCfg(16, 3, 64, 24, False, "RE", 2),
    BneckCfg(24, 3, 72, 24, False, "RE", 1),
    BneckCfg(24, 5, 72, 40, True, "RE", 2),
    BneckCfg(40, 5, 120, 40, True, "RE", 1),
    BneckCfg(40, 5, 120, 40, True, "RE", 1),
    BneckCfg(40, 3, 240, 80, False, "HS", 2),
    BneckCfg(80, 3, 200, 80, False, "HS", 1),
    BneckCfg(80, 3, 184, 80, False, "HS", 1),
    BneckCfg(80, 3, 184, 80, False, "HS", 1),
    BneckCfg(80, 3, 480, 112, True, "HS", 1),
    BneckCfg(112, 3, 672, 112, True, "HS", 1),
    BneckCfg(112, 5, 672, 160, True, "HS", 2),
    BneckCfg(160, 5, 960, 160, True, "HS", 1),
    BneckCfg(160, 5, 960, 160, True, "HS", 1),
)

# each stage key's channels: c0 the stem (/2), c1..c4 the stride boundaries
# (/4../32), c5 the final conv (/32)
STAGE_CHANNELS = {"c0": 16, "c1": 24, "c2": 40, "c3": 80, "c4": 160, "c5": 960}


def _make_divisible(v: int, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class SqueezeExcite(nn.Module):
    """Global mean -> 1x1 -> ReLU -> 1x1 -> hard-sigmoid gate, in float32."""

    def __init__(self, channels: int, squeeze: int):
        super().__init__()
        self.fc1 = Conv(channels, squeeze, 1, dtype=torch.float32)
        self.fc2 = Conv(squeeze, channels, 1, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(F.relu(self.fc1(s)))
        return x * hard_sigmoid(s)


class InvertedResidual(nn.Module):
    def __init__(self, cfg: BneckCfg, norm: str = "frozen", dtype: torch.dtype | None = None):
        super().__init__()
        c = self.cfg = cfg
        make = make_norm(norm)
        if c.expand != c.in_ch:
            self.expand = Conv(c.in_ch, c.expand, 1, bias=False, dtype=dtype)
            self.expand_bn = make(c.expand)
        else:
            self.expand = None
        self.depthwise = Conv(c.expand, c.expand, c.kernel, stride=c.stride,
                              padding=(c.kernel - 1) // 2, bias=False, groups=c.expand,
                              dtype=dtype)
        self.depthwise_bn = make(c.expand)
        # torchvision squeezes a quarter of the EXPANDED channels, rounded to 8
        self.se = SqueezeExcite(c.expand, _make_divisible(c.expand // 4)) if c.se else None
        self.project = Conv(c.expand, c.out_ch, 1, bias=False, dtype=dtype)
        self.project_bn = make(c.out_ch)
        self.act = hard_swish if c.act == "HS" else F.relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if self.expand is not None:
            y = self.act(self.expand_bn(self.expand(y)))
        y = self.act(self.depthwise_bn(self.depthwise(y)))
        if self.se is not None:
            y = self.se(y)
        y = self.project_bn(self.project(y))
        if self.cfg.stride == 1 and self.cfg.in_ch == self.cfg.out_ch:
            y = y + x
        return y


class MobileNetV3Backbone(nn.Module):
    """The features trunk; ``forward`` returns the ``returned`` stage keys
    (``STAGE_CHANNELS``)."""

    def __init__(self, returned: Sequence[str] = ("c5",), norm: str = "frozen",
                 dtype: torch.dtype | None = None):
        super().__init__()
        make = make_norm(norm)
        self.returned = tuple(returned)
        self.stem = Conv(3, 16, 3, stride=2, padding=1, bias=False, dtype=dtype)
        self.stem_bn = make(16)
        for i, cfg in enumerate(LARGE_CFG):
            self.add_module(f"block{i}", InvertedResidual(cfg, norm, dtype))
        self.lastconv = Conv(LARGE_CFG[-1].out_ch, 960, 1, bias=False, dtype=dtype)
        self.lastconv_bn = make(960)
        self.out_channels = tuple(STAGE_CHANNELS[k] for k in self.returned)

    def forward(self, x: torch.Tensor, *, allow_fused: bool = False) -> dict[str, torch.Tensor]:
        """``allow_fused`` is accepted for the detector's interface: MobileNet
        has no fused path."""
        y = hard_swish(self.stem_bn(self.stem(x)))
        feats = {"c0": y}
        stage = 0
        for i, cfg in enumerate(LARGE_CFG):
            if cfg.stride == 2:
                stage += 1
            y = getattr(self, f"block{i}")(y)
            feats[f"c{stage}"] = y
        feats["c5"] = hard_swish(self.lastconv_bn(self.lastconv(y)))
        return {k: feats[k] for k in self.returned}
