"""Torchvision-layout ResNet backbone weights <-> the port's detector (port of
``cald_tpu/convert/torchvision_import.py`` for the ResNet backbone).

Users pass ImageNet weights as a torchvision ``resnet50`` ``state_dict``
(``--pretrained-backbone``). Names:

  torchvision                    the port (``FasterRCNN``)
  conv1.weight               ->  backbone.conv1.weight
  bn1.{weight,bias}          ->  backbone.bn1.{scale,bias}
  bn1.running_{mean,var}     ->  backbone.bn1.{mean,var}
  layerL.B.convK.weight      ->  backbone.layerL_B.convK.weight
  layerL.B.bnK.*             ->  backbone.layerL_B.bnK.*
  layerL.B.downsample.0/1.*  ->  backbone.layerL_B.downsample_conv/_bn.*

``fc.*`` and ``*.num_batches_tracked`` are not used.
"""

from __future__ import annotations

import re

import torch

_BN = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}


def _port_name(tv: str) -> str | None:
    """The port's parameter or buffer name of a torchvision backbone key."""
    m = re.fullmatch(r"(conv1|bn1)\.(\w+)", tv)
    if m:
        mod, leaf = m.groups()
        return f"backbone.{mod}.{_BN[leaf] if mod == 'bn1' else leaf}" if (
            mod == "conv1" or leaf in _BN) else None
    m = re.fullmatch(r"layer(\d)\.(\d+)\.(conv\d|bn\d|downsample\.[01])\.(\w+)", tv)
    if not m:
        return None
    stage, block, mod, leaf = m.groups()
    if mod.startswith("conv"):
        return f"backbone.layer{stage}_{block}.{mod}.{leaf}"
    if leaf not in _BN:
        return None
    if mod == "downsample.0":
        return f"backbone.layer{stage}_{block}.downsample_conv.{leaf}"
    name = "downsample_bn" if mod == "downsample.1" else mod
    return f"backbone.layer{stage}_{block}.{name}.{_BN[leaf]}"


def load_backbone_(model: torch.nn.Module, state_dict: dict) -> int:
    """Copy a torchvision ResNet ``state_dict`` into ``model``'s backbone in
    place; every backbone tensor of the model must be given, with its shape.
    Returns the number of tensors copied."""
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    need = {k for k in own if k.startswith("backbone.")}
    done = set()
    with torch.no_grad():
        for key, value in state_dict.items():
            name = _port_name(key)
            if name is None:
                continue
            if name not in own or own[name].shape != value.shape:
                raise ValueError(f"pretrained backbone: {key} {tuple(value.shape)} does not "
                                 f"fit {name}")
            own[name].copy_(value)
            done.add(name)
    if need - done:
        raise ValueError(f"pretrained backbone lacks {sorted(need - done)[:5]}")
    return len(done)


def backbone_state_dict(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The model's backbone as a torchvision-layout ``state_dict`` (CPU
    float32 copies), the inverse of ``load_backbone_``."""
    inv = {_BN[k]: k for k in _BN}
    out = {}
    for name, t in [*model.named_parameters(), *model.named_buffers()]:
        if not name.startswith("backbone."):
            continue
        parts = name[len("backbone."):].split(".")
        mod, leaf = parts[0], parts[-1]
        if mod in ("conv1", "bn1"):
            key = f"{mod}.{inv[leaf] if mod == 'bn1' else leaf}"
        else:
            layer, sub = mod, parts[1]
            stage, block = layer[len("layer"):].split("_")
            if sub == "downsample_conv":
                key = f"layer{stage}.{block}.downsample.0.{leaf}"
            elif sub == "downsample_bn":
                key = f"layer{stage}.{block}.downsample.1.{inv[leaf]}"
            elif sub.startswith("bn"):
                key = f"layer{stage}.{block}.{sub}.{inv[leaf]}"
            else:
                key = f"layer{stage}.{block}.{sub}.{leaf}"
        out[key] = t.detach().float().cpu().clone()
    return out
