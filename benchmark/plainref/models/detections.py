"""Fixed-slot detection container (port of ``cald_tpu/models/detections.py``)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class Detections:
    """K fixed detection slots per image.

    boxes (..., K, 4) xyxy in the model's input coordinates; scores (..., K)
    the selected class score; labels (..., K) 1-based foreground ids; valid
    (..., K) bool; scores_cls (..., K, C) the full softmax row; prob_max
    (..., K) its max over foreground classes; props (..., K, 4) the source
    proposal.
    """

    boxes: torch.Tensor
    scores: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor
    scores_cls: torch.Tensor
    prob_max: torch.Tensor
    props: torch.Tensor

    def rescale(self, scale: torch.Tensor) -> "Detections":
        """Boxes and props divided by the per-image ``scale`` (..., ) back to
        original image coordinates (the reference's transform.postprocess)."""
        s = scale[..., None, None]
        return dataclasses.replace(self, boxes=self.boxes / s, props=self.props / s)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Detections":
        """Apply ``fn`` to every field."""
        return Detections(**{f.name: fn(getattr(self, f.name))
                             for f in dataclasses.fields(self)})
