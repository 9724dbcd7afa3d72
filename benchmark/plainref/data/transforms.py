"""Host-side training transforms and the normalizer (port of
``cald_tpu/data/transforms.py``).

The flip stays on the host, before padding, as in the JAX package; the
detectors normalize on the device (``FasterRCNN.features``) with the
constants defined here.
"""

from __future__ import annotations

import numpy as np

# torchvision GeneralizedRCNNTransform defaults
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


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


# COCO person-keypoint left/right pairs (reference transforms.py:7-14)
COCO_KP_FLIP_INDS = np.asarray(
    [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15])


def flip_coco_person_keypoints(kps: np.ndarray, width: int) -> np.ndarray:
    """Horizontally flip (N, 17, 3) COCO keypoints: swap left/right joints,
    mirror x, and keep the visibility==0 → (0, 0, 0) convention
    (reference transforms.py:7-14)."""
    flipped = np.asarray(kps, np.float32)[:, COCO_KP_FLIP_INDS].copy()
    flipped[..., 0] = width - flipped[..., 0]
    flipped[flipped[..., 2] == 0] = 0
    return flipped


def random_horizontal_flip_target(image: np.ndarray, target: dict,
                                  rng: np.random.Generator, p: float = 0.5):
    """Dict-target flip covering the reference's full RandomHorizontalFlip
    (transforms.py:27-45): boxes always, plus ``masks`` (N, H, W) and
    ``keypoints`` (N, 17, 3) when present. The AL drivers use the
    boxes-only ``random_horizontal_flip``; this is for dataset-API
    completeness."""
    if rng.random() >= p:
        return image, target
    width = image.shape[1]
    target = dict(target)
    image = image[:, ::-1, :]
    boxes = target.get("boxes")
    if boxes is not None and len(boxes):
        boxes = boxes.copy()
        boxes[:, [0, 2]] = width - boxes[:, [2, 0]]
        target["boxes"] = boxes
    if "masks" in target:
        target["masks"] = np.ascontiguousarray(target["masks"][:, :, ::-1])
    if "keypoints" in target:
        target["keypoints"] = flip_coco_person_keypoints(
            target["keypoints"], width)
    return image, target


def normalize_image(image, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """(image/255 - mean) / std on NumPy arrays or tensors, any leading
    dims."""
    return (image / 255.0 - mean) / std
