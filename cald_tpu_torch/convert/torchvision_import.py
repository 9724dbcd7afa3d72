"""Torchvision-layout backbone weights <-> the port's detectors (port of
``cald_tpu/convert/torchvision_import.py`` and the ``.npz``/``.npy``
branches of ``cald_tpu/convert/pth_reader.py``).

Users pass ImageNet weights as a torchvision ``resnet50`` or
``mobilenet_v3_large`` ``state_dict`` (``--pretrained-backbone``, a file that
``torch.load`` reads, or ``.npz``/``.npy``); the loader follows the model's
backbone. ResNet names:

  torchvision                    the port (``FasterRCNN``, ``RetinaNet``)
  conv1.weight               ->  backbone.conv1.weight
  bn1.{weight,bias}          ->  backbone.bn1.{scale,bias}
  bn1.running_{mean,var}     ->  backbone.bn1.{mean,var}
  layerL.B.convK.weight      ->  backbone.layerL_B.convK.weight
  layerL.B.bnK.*             ->  backbone.layerL_B.bnK.*
  layerL.B.downsample.0/1.*  ->  backbone.layerL_B.downsample_conv/_bn.*

MobileNetV3-Large names (the reference's mobilenetv3.py:94-180):

  features.0.{0,1}                 ->  backbone.stem, backbone.stem_bn
  features.{i+1}.block.{j}.{0,1}   ->  backbone.block{i}.{conv}, {conv}_bn, the
                                       convs in order expand?, depthwise, project
  features.{i+1}.block.{j}.fc1/fc2 ->  backbone.block{i}.se.fc1/fc2 (with bias)
  features.16.{0,1}                ->  backbone.lastconv, backbone.lastconv_bn

torchvision's MobileNet norms use eps 1e-3 where FrozenBatchNorm uses 1e-5,
so the difference is folded into the stored variance, as the JAX package
does: scale / sqrt((var + 1e-3 - 1e-5) + 1e-5) == scale / sqrt(var + 1e-3).

``fc.*``, ``classifier.*`` and ``*.num_batches_tracked`` are not used.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from cald_tpu_torch.models.mobilenetv3 import LARGE_CFG, MobileNetV3Backbone

_BN = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
# torchvision's MobileNetV3 BatchNorm eps (1e-3) less FrozenBatchNorm's (1e-5)
MOBILENET_EPS_DELTA = 1e-3 - 1e-5


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


def _mobilenet_names() -> dict[str, str]:
    """torchvision ``mobilenet_v3_large`` trunk key -> the port's name."""
    names: dict[str, str] = {}

    def conv_bn(tv: str, port: str):
        names[f"{tv}.0.weight"] = f"backbone.{port}.weight"
        for leaf, mine in _BN.items():
            names[f"{tv}.1.{leaf}"] = f"backbone.{port}_bn.{mine}"

    conv_bn("features.0", "stem")
    for i, cfg in enumerate(LARGE_CFG):
        t, j = f"features.{i + 1}.block", 0
        convs = (["expand"] if cfg.expand != cfg.in_ch else []) + ["depthwise"]
        for conv in convs:
            conv_bn(f"{t}.{j}", f"block{i}.{conv}")
            j += 1
        if cfg.se:
            for fc in ("fc1", "fc2"):
                for leaf in ("weight", "bias"):
                    names[f"{t}.{j}.{fc}.{leaf}"] = f"backbone.block{i}.se.{fc}.{leaf}"
            j += 1
        conv_bn(f"{t}.{j}", f"block{i}.project")
    conv_bn(f"features.{len(LARGE_CFG) + 1}", "lastconv")
    return names


def _is_mobilenet(model: torch.nn.Module) -> bool:
    return isinstance(getattr(model, "backbone", None), MobileNetV3Backbone)


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A flat {name: tensor} mapping from ``.npz``, ``.npy`` (a pickled dict
    of arrays) or any file ``torch.load`` reads; a ``state_dict``,
    ``model`` or ``model_state_dict`` wrapper is unwrapped."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    if path.endswith(".npy"):
        obj = np.load(path, allow_pickle=True).item()
        return {k: torch.from_numpy(np.array(v)) for k, v in obj.items()}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model", "model_state_dict"):
        if isinstance(obj, dict) and isinstance(obj.get(wrapper), dict):
            obj = obj[wrapper]
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state_dict mapping, got {type(obj)}")
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def load_backbone_(model: torch.nn.Module, state_dict: dict) -> int:
    """Copy a torchvision ResNet or MobileNetV3-Large ``state_dict`` (as the
    model's backbone is) into ``model``'s backbone in place; every backbone
    tensor of the model must be given, with its shape. Returns the number of
    tensors copied."""
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    need = {k for k in own if k.startswith("backbone.")}
    mobile = _is_mobilenet(model)
    names = _mobilenet_names() if mobile else None
    done = set()
    with torch.no_grad():
        for key, value in state_dict.items():
            name = names.get(key) if mobile else _port_name(key)
            if name is None:
                continue
            if name not in own or own[name].shape != value.shape:
                raise ValueError(f"pretrained backbone: {key} {tuple(value.shape)} does not "
                                 f"fit {name}")
            own[name].copy_(value)
            if mobile and key.endswith("running_var"):
                own[name].add_(MOBILENET_EPS_DELTA)
            done.add(name)
    if need - done:
        raise ValueError(f"pretrained backbone lacks {sorted(need - done)[:5]}")
    return len(done)


def backbone_state_dict(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The model's backbone as a torchvision-layout ``state_dict`` (CPU
    float32 copies), the inverse of ``load_backbone_``."""
    if _is_mobilenet(model):
        own = dict(model.named_parameters())
        own.update(model.named_buffers())
        out = {}
        for key, name in _mobilenet_names().items():
            t = own[name].detach().float().cpu().clone()
            out[key] = t - MOBILENET_EPS_DELTA if key.endswith("running_var") else t
        return out
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
