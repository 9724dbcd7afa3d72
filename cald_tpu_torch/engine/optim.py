"""SGD with momentum and weight decay over the trainable parameters, with
backbone freezing (port of ``cald_tpu/engine/optim.py``).

Reference recipe: SGD lr 0.0025, momentum 0.9, weight decay 1e-4 over
``requires_grad`` parameters only; torchvision's trainable_backbone_layers=3
freezes the stem and layer1. Frozen parameters get ``requires_grad=False``
and stay out of the optimizer, so they get neither an update nor weight
decay, as ``optax.set_to_zero`` gives them neither in the JAX package.
torch's SGD adds ``weight_decay * p`` to the gradient before the momentum
trace, which is the JAX package's ``add_decayed_weights`` -> ``sgd`` chain.
"""

from __future__ import annotations

import torch
from torch import nn

# torchvision trainable_backbone_layers=3: conv1 (+ its frozen norm) and
# layer1 frozen, layer2..layer4 train. The port's parameter names:
RESNET_FROZEN_L3 = ("backbone.conv1", "backbone.layer1")


def freeze(model: nn.Module, frozen_prefixes: tuple[str, ...]) -> list[nn.Parameter]:
    """Set ``requires_grad=False`` on every parameter whose name starts with
    one of ``frozen_prefixes``; returns the parameters left trainable."""
    trainable = []
    for name, p in model.named_parameters():
        if any(name.startswith(pref) for pref in frozen_prefixes):
            p.requires_grad_(False)
        elif p.requires_grad:
            trainable.append(p)
    return trainable


def make_sgd(model: nn.Module, learning_rate: float, *, momentum: float = 0.9,
             weight_decay: float = 1e-4,
             frozen_prefixes: tuple[str, ...] = ()) -> torch.optim.SGD:
    """``torch.optim.SGD`` over the model's trainable parameters after
    freezing ``frozen_prefixes``. A schedule is applied on top with
    ``engine.schedules.lr_scheduler``."""
    return torch.optim.SGD(freeze(model, frozen_prefixes), lr=learning_rate,
                           momentum=momentum, weight_decay=weight_decay, nesterov=False)
