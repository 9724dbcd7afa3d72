"""The weight bridge: the JAX package's detector variables (Faster R-CNN on
ResNet or MobileNetV3, RetinaNet) -> the port's ``state_dict``.

Input is the Flax ``{"params": ..., "frozen": ...}`` tree with numpy (or any
array-like) leaves; nothing of JAX is imported. Conv kernels go from HWIO to
OIHW, Dense kernels from (in, out) to (out, in), FrozenBN ``scale``/``bias``/
``mean``/``var`` carry across, and a GroupNorm's ``params`` ``scale`` becomes
its ``weight``. Module paths are the same in both packages except the Flax
auto-named norms (``FrozenBatchNorm_i`` or ``GroupNorm_i``), which take
torchvision's names in a ResNet and ``{conv}_bn`` in a MobileNetV3 (the
i-th norm of a ``block{j}`` follows its i-th conv of ``expand``,
``depthwise``, ``project``; the trunk's two follow ``stem`` and
``lastconv``). A depthwise kernel (k, k, 1, E) becomes (E, 1, k, k) like any
other. Every leaf is consumed exactly once; a leaf left over raises.

Any tree shaped like the params collection maps the same way with
``flax_to_state_dict({"params": tree})``: the JAX package's gradients
(``jax.grad`` of the loss) or optax's momentum trace come out keyed and laid
out like the port's parameters, which is how the tests hold the port's
training against the JAX package's.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

# Flax's auto-named norms (FrozenBatchNorm_i or GroupNorm_i) -> the port's
# names, by parent module and index i
_BACKBONE_NORMS = ("bn1",)
_BLOCK_NORMS = ("bn1", "bn2", "bn3", "downsample_bn")
_BLOCK = re.compile(r"layer\d+_\d+$")
_MOBILE_BLOCK = re.compile(r"block\d+$")
_MOBILE_CONVS = ("expand", "depthwise", "project")
_MOBILE_TRUNK_NORMS = ("stem_bn", "lastconv_bn")
_NORM = re.compile(r"(FrozenBatchNorm|GroupNorm)_(\d+)$")


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _norm_table(parent: tuple, params: Mapping) -> tuple[str, ...]:
    """The port's names of the auto-named norms under ``parent``, in Flax's
    index order."""
    node = params
    for name in parent:
        node = node.get(name, {})
    if parent and _MOBILE_BLOCK.match(parent[-1]):
        return tuple(f"{c}_bn" for c in _MOBILE_CONVS if c in node)
    if "stem" in node:
        return _MOBILE_TRUNK_NORMS
    if parent and _BLOCK.match(parent[-1]):
        return _BLOCK_NORMS
    return _BACKBONE_NORMS


def _module_path(path: tuple, params: Mapping) -> str:
    names = list(path)
    for i, name in enumerate(names):
        m = _NORM.match(name)
        if m:
            names[i] = _norm_table(tuple(path[:i]), params)[int(m.group(2))]
    return ".".join(names)


def flax_to_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """Map the Flax variables of a ``cald_tpu`` detector (``FasterRCNN``,
    ``RetinaNet``) to a state_dict for its port (float32 tensors)."""
    unknown = set(variables) - {"params", "frozen"}
    if unknown:
        raise ValueError(f"unexpected variable collections {sorted(unknown)}")
    out: dict[str, torch.Tensor] = {}
    for coll in ("params", "frozen"):
        for path, leaf in _leaves(variables.get(coll, {})):
            *mod, name = path
            a = np.array(leaf, np.float32)          # a writable copy
            if coll == "params" and name == "kernel":
                name = "weight"
                if a.ndim == 4:      # HWIO -> OIHW
                    a = a.transpose(3, 2, 0, 1)
                elif a.ndim == 2:    # (in, out) -> (out, in)
                    a = a.T
                else:
                    raise ValueError(f"kernel of rank {a.ndim} at {'/'.join(path)}")
            elif coll == "params" and name == "scale" and mod and mod[-1].startswith("GroupNorm_"):
                name = "weight"
            elif (coll, name) not in {("params", "bias"), ("frozen", "scale"),
                                      ("frozen", "bias"), ("frozen", "mean"),
                                      ("frozen", "var")}:
                raise ValueError(f"unexpected leaf {coll}/{'/'.join(path)}")
            key = f"{_module_path(tuple(mod), variables.get('params', {}))}.{name}"
            if key in out:
                raise ValueError(f"two Flax leaves map to {key}")
            out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out


# the VAE's transposed convolutions (cald_tpu/models/vae.py ``dec{i}``)
VAE_TRANSPOSED = tuple(f"dec{i}" for i in range(5))


def module_state_dict(params: Mapping, *, transposed: tuple[str, ...] = ()
                      ) -> dict[str, torch.Tensor]:
    """Map a Flax ``params`` tree of explicitly named submodules to the
    port's ``state_dict`` (float32 tensors); ``transposed`` names the
    ``nn.ConvTranspose`` modules."""
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(params):
        *mod, name = path
        a = np.array(leaf, np.float32)
        if name == "kernel":
            name = "weight"
            if a.ndim == 4 and mod[-1] in transposed:
                a = a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            elif a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
            else:
                raise ValueError(f"kernel of rank {a.ndim} at {'/'.join(path)}")
        elif name == "scale":
            name = "weight"
        elif name != "bias":
            raise ValueError(f"unexpected leaf {'/'.join(path)}")
        out[".".join((*mod, name))] = torch.from_numpy(np.ascontiguousarray(a))
    return out
