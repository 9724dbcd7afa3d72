"""Seeded initialisation in the JAX package's families (``flax`` inits of
``cald_tpu/models``): truncated-normal kaiming fan-out convolutions
(``cald_tpu/models/layers.py::conv_kaiming``), ``normal(0.01)`` detection
heads (the RPN head, the box predictor and RetinaNet's ten head convs),
truncated lecun-normal Dense layers and the convs that the JAX package
leaves at Flax's default (MobileNetV3's squeeze-excite ``fc1``/``fc2`` and
RetinaNet's ``reduce``), zero biases but RetinaNet's ``cls_logits``, which
starts at the focal prior ``-log((1 - pi) / pi)``; frozen norms keep their
identity statistics, and GroupNorms get Flax's scale 1 and bias 0. The
draws come from a ``torch.Generator`` seeded with ``seed``, so they are the
port's own, not the JAX package's.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from cald_tpu_torch.models.layers import Conv, Dense, GroupNorm

# Flax's truncated normal rescales its std by the std of a unit normal cut at +-2
_TRUNC_STD = 0.87962566103423978


def _truncated_(w: torch.Tensor, std: float, g: torch.Generator) -> None:
    s = std / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, s, -2.0 * s, 2.0 * s, generator=g)


# head convs drawn from normal(0.01): the RPN head's and RetinaNet's ("head.")
_HEAD_NORMAL = ("rpn_head.", "head.")
# convs at Flax's default lecun-normal init, by the last part of their name
_LECUN_CONVS = ("fc1", "fc2", "reduce")


def random_init_(model: nn.Module, seed: int) -> None:
    """Re-initialise every ``Conv``, ``Dense`` and ``GroupNorm`` of ``model``
    in place (the GroupNorms draw nothing from the generator). A RetinaNet's
    ``cls_logits`` bias takes its ``cfg.prior_probability``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, GroupNorm):
                m.weight.fill_(1.0)
            elif isinstance(m, Conv):
                o, i, kh, kw = m.weight.shape
                if name.startswith(_HEAD_NORMAL):
                    m.weight.normal_(0.0, 0.01, generator=g)
                elif name.rsplit(".", 1)[-1] in _LECUN_CONVS:
                    _truncated_(m.weight, math.sqrt(1.0 / (i * kh * kw)), g)
                else:
                    _truncated_(m.weight, math.sqrt(2.0 / (o * kh * kw)), g)
                if name == "head.cls_logits":
                    pi = model.cfg.prior_probability
                    m.bias.fill_(-math.log((1.0 - pi) / pi))
                    continue
            elif isinstance(m, Dense):
                if name.startswith("box_predictor"):
                    m.weight.normal_(0.0, 0.01, generator=g)
                else:
                    _truncated_(m.weight, math.sqrt(1.0 / m.weight.shape[1]), g)
            else:
                continue
            if m.bias is not None:
                m.bias.zero_()


def lecun_init_(model: nn.Module, seed: int) -> None:
    """Flax's defaults for every ``Conv``, ``nn.ConvTranspose2d`` and ``Dense`` of
    ``model`` (truncated lecun-normal kernels over the fan-in, zero biases),
    GroupNorm scale 1 and bias 0: the initial distributions of the JAX
    package's ``LossNet``, ``VAAL_VAE`` and ``VAALDiscriminator``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, GroupNorm):
                m.weight.fill_(1.0)
            elif isinstance(m, (Conv, Dense)):
                fan_in = m.weight[0].numel()
                _truncated_(m.weight, math.sqrt(1.0 / fan_in), g)
            elif isinstance(m, nn.ConvTranspose2d):
                fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
                _truncated_(m.weight, math.sqrt(1.0 / fan_in), g)
            else:
                continue
            if m.bias is not None:
                m.bias.zero_()
