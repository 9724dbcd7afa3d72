"""The weight bridge: the JAX package's Faster R-CNN variables -> the port's
``state_dict``.

Input is the Flax ``{"params": ..., "frozen": ...}`` tree with numpy (or any
array-like) leaves; nothing of JAX is imported. Conv kernels go from HWIO to
OIHW, Dense kernels from (in, out) to (out, in), FrozenBN ``scale``/``bias``/
``mean``/``var`` carry across. Module paths are the same in both packages
except the Flax auto-named norms, which take torchvision's names. Every leaf
is consumed exactly once; a leaf left over raises.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

# Flax's auto-named FrozenBatchNorm_i -> the port's names, by parent module
_BACKBONE_NORMS = {"FrozenBatchNorm_0": "bn1"}
_BLOCK_NORMS = {"FrozenBatchNorm_0": "bn1", "FrozenBatchNorm_1": "bn2",
                "FrozenBatchNorm_2": "bn3", "FrozenBatchNorm_3": "downsample_bn"}
_BLOCK = re.compile(r"layer\d+_\d+$")


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_path(path: tuple) -> str:
    names = list(path)
    for i, name in enumerate(names):
        if name.startswith("FrozenBatchNorm_"):
            table = _BLOCK_NORMS if i and _BLOCK.match(names[i - 1]) else _BACKBONE_NORMS
            names[i] = table[name]
    return ".".join(names)


def flax_to_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """Map the Flax variables of ``cald_tpu``'s ``FasterRCNN`` to a state_dict
    for ``cald_tpu_torch.models.faster_rcnn.FasterRCNN`` (float32 tensors)."""
    unknown = set(variables) - {"params", "frozen"}
    if unknown:
        raise ValueError(f"unexpected variable collections {sorted(unknown)}")
    out: dict[str, torch.Tensor] = {}
    for coll in ("params", "frozen"):
        for path, leaf in _leaves(variables.get(coll, {})):
            *mod, name = path
            a = np.asarray(leaf, np.float32)
            if coll == "params" and name == "kernel":
                name = "weight"
                if a.ndim == 4:      # HWIO -> OIHW
                    a = a.transpose(3, 2, 0, 1)
                elif a.ndim == 2:    # (in, out) -> (out, in)
                    a = a.T
                else:
                    raise ValueError(f"kernel of rank {a.ndim} at {'/'.join(path)}")
            elif (coll, name) not in {("params", "bias"), ("frozen", "scale"),
                                      ("frozen", "bias"), ("frozen", "mean"),
                                      ("frozen", "var")}:
                raise ValueError(f"unexpected leaf {coll}/{'/'.join(path)}")
            key = f"{_module_path(tuple(mod))}.{name}"
            if key in out:
                raise ValueError(f"two Flax leaves map to {key}")
            out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out
