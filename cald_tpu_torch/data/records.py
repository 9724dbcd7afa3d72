"""The common host-side image record (copy of ``cald_tpu/data/records.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ImageRecord:
    """One image's annotations, decoded lazily by the loader.

    boxes are float32 ``(N, 4)`` xyxy in original-image pixels; labels are int32
    ``(N,)`` with 0 reserved for background (so foreground classes are 1-based,
    matching the reference's target dicts). ``difficult`` marks VOC 'difficult'
    objects (excluded from training loss targets by the VOC protocol and handled
    specially by VOC eval); always all-False for COCO.
    """

    image_id: str          # dataset-native id (VOC filename stem / str(COCO id))
    image_path: str
    width: int
    height: int
    boxes: np.ndarray
    labels: np.ndarray
    difficult: np.ndarray
    area: np.ndarray | None = None
    iscrowd: np.ndarray | None = None

    @property
    def aspect_ratio(self) -> float:
        return self.width / max(self.height, 1)

    def __post_init__(self):
        n = len(self.boxes)
        if self.area is None:
            wh = self.boxes[:, 2:4] - self.boxes[:, 0:2]
            self.area = (wh[:, 0] * wh[:, 1]).astype(np.float32)
        if self.iscrowd is None:
            self.iscrowd = np.zeros((n,), dtype=np.int32)
