"""Backbones other than ResNet, each a file of its own found by name.

``backbones/<name>.py`` gives ``build(dtype, norm, **backbone_args)``, which
returns a module with

- ``out_keys``: the names of the maps ``forward`` returns, finest first, at
  strides 4, 8, 16 and 32 of the canvas (Faster R-CNN's FPN takes them all,
  RetinaNet's all but the first);
- ``out_channels``: their widths, in the same order;
- ``forward(x) -> dict``: the maps of an NCHW (channels-last) input;
- optionally ``seeded_leaves()``: the parameters that are neither a
  ``Conv`` nor a ``Dense`` weight and that the seeded weights draw, as
  (tensor, family, std) (``harness/weights.py``).

The configuration's ``detector.backbone`` names the file and its
``detector.backbone_args`` (the published widths) are ``build``'s keywords.
"""

from __future__ import annotations

import importlib
from pathlib import Path

import torch
from torch import nn

HERE = Path(__file__).resolve().parent


def build(name: str, args: dict, dtype: torch.dtype | None, norm: str) -> nn.Module:
    """The backbone ``name`` of ``backbones/<name>.py`` with ``args``."""
    path = HERE / f"{name}.py"
    if not name.isidentifier() or not path.is_file():
        raise ValueError(f"unknown backbone {name!r}: no file {path}")
    return importlib.import_module(f"{__name__}.{name}").build(dtype=dtype, norm=norm, **args)
