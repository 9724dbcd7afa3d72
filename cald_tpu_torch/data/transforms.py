"""Host-side training transforms (port of ``cald_tpu/data/transforms.py``).

The flip stays on the host, before padding, as in the JAX package; the
normalizer lives in the detector (``FasterRCNN.features``).
"""

from __future__ import annotations

import numpy as np


def random_horizontal_flip(image: np.ndarray, boxes: np.ndarray,
                           rng: np.random.Generator, p: float = 0.5):
    """Flip image (H, W, C) and xyxy boxes with probability p
    (reference transforms.py:27-45)."""
    if rng.random() < p:
        width = image.shape[1]
        image = image[:, ::-1, :]
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, [0, 2]] = width - boxes[:, [2, 0]]
    return image, boxes
