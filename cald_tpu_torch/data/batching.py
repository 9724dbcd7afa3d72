"""Fixed-shape batching: resize -> canvas padding -> dense ``Batch`` (port of
``cald_tpu/data/batching.py``).

The reference's per-image min/max-side resize, its aspect-ratio grouped
batch sampler and a padded collate, as in the JAX package. ``Batch`` is a
plain dataclass of numpy arrays with the JAX ``Batch``'s fields.
``resize_image`` computes Pillow's bilinear resize of 8-bit images in
integer NumPy, so that batches equal the JAX package's (which calls Pillow)
on a machine without Pillow.
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class Batch:
    """One padded batch; every array is dense and fixed-shape.

    images:    (B, H, W, 3) float32, raw 0..255 pixels.
    valid_hw:  (B, 2) int32, the resized (pre-padding) height/width.
    scale:     (B,) float32, resized / original scale factor.
    boxes:     (B, K, 4) float32 xyxy in RESIZED coordinates.
    labels:    (B, K) int32 (0 = padding/background slot).
    box_valid: (B, K) bool.
    image_idx: (B,) int32, index into the host dataset.
    """

    images: np.ndarray
    valid_hw: np.ndarray
    scale: np.ndarray
    boxes: np.ndarray
    labels: np.ndarray
    box_valid: np.ndarray
    image_idx: np.ndarray

    @property
    def batch_size(self) -> int:
        return self.images.shape[0]


@dataclasses.dataclass(frozen=True)
class Canvas:
    height: int
    width: int

    def fits(self, h: float, w: float) -> bool:
        return h <= self.height and w <= self.width


def default_canvases(min_size: int, max_size: int, multiple: int = 64) -> tuple[Canvas, ...]:
    """Two canvases (landscape, portrait) covering every min/max-side resize,
    rounded up to ``multiple`` (FPN levels stay exact)."""
    def up(x):
        return int(-(-x // multiple) * multiple)

    short = up(min_size)
    long = up(max_size)
    return (Canvas(short, long), Canvas(long, short))


def resize_scale(h: int, w: int, min_size: int, max_size: int) -> float:
    """torchvision GeneralizedRCNNTransform scale rule."""
    min_side, max_side = min(h, w), max(h, w)
    return min(min_size / min_side, max_size / max_side)


def choose_canvas(h: int, w: int, canvases: Sequence[Canvas]) -> Canvas:
    """Smallest-area canvas that fits a resized (h, w) image."""
    fitting = [c for c in canvases if c.fits(h, w)]
    if not fitting:
        # fall back to the largest canvas; the image is further downscaled later.
        return max(canvases, key=lambda c: c.height * c.width)
    return min(fitting, key=lambda c: c.height * c.width)


_PRECISION_BITS = 32 - 8 - 2          # Pillow's fixed point for 8-bit images


def _bilinear_coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` for the bilinear filter (support 1)
    and its 8-bit fixed-point normalisation: per output pixel the first input
    pixel and the integer weights of up to ``ksize`` inputs."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax, dtype=np.float64)
        w = np.maximum(1.0 - np.abs((x + xmin - center + 0.5) / filterscale), 0.0)
        total = w.sum()
        if total != 0.0:
            w = w / total
        fixed = w * (1 << _PRECISION_BITS)
        kk[xx, :xmax] = np.where(fixed < 0, (fixed - 0.5).astype(np.int64),
                                 (fixed + 0.5).astype(np.int64))
        first[xx] = xmin
    return first, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's two-pass resample along ``axis`` of an (H, W, C)
    uint8 image: integer sums rounded at 2^21 and clipped to 0..255."""
    first, kk = _bilinear_coeffs(img.shape[axis], out_size)
    idx = np.minimum(first[:, None] + np.arange(kk.shape[1]), img.shape[axis] - 1)
    src = np.take(img, idx.reshape(-1), axis=axis).astype(np.int64)
    if axis == 0:
        src = src.reshape(out_size, kk.shape[1], *img.shape[1:])
        acc = (src * kk[:, :, None, None]).sum(axis=1)
    else:
        src = src.reshape(img.shape[0], out_size, kk.shape[1], img.shape[2])
        acc = (src * kk[None, :, :, None]).sum(axis=2)
    acc = (acc + (1 << (_PRECISION_BITS - 1))) >> _PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def resize_image(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize of an (H, W, 3) image to float32: the uint8 image
    through Pillow's ``Image.resize(..., BILINEAR)``, computed in NumPy
    (horizontal pass, then vertical, each rounded to 8 bits)."""
    if image.shape[0] == out_h and image.shape[1] == out_w:
        return image.astype(np.float32)
    img = image.astype(np.uint8)
    if img.shape[1] != out_w:
        img = _resample_axis(img, out_w, axis=1)
    if img.shape[0] != out_h:
        img = _resample_axis(img, out_h, axis=0)
    return img.astype(np.float32)


def make_padded_batch(images: Sequence[np.ndarray], records, canvas: Canvas,
                      *, min_size: int, max_size: int, max_boxes: int,
                      indices: Sequence[int],
                      boxes_override: Sequence[np.ndarray] | None = None) -> Batch:
    """Resize each image per the reference rule, paste onto the canvas, pad
    targets. ``boxes_override`` (e.g. post-flip boxes) replaces each record's
    boxes."""
    b = len(images)
    out_img = np.zeros((b, canvas.height, canvas.width, 3), np.float32)
    valid_hw = np.zeros((b, 2), np.int32)
    scales = np.zeros((b,), np.float32)
    boxes = np.zeros((b, max_boxes, 4), np.float32)
    labels = np.zeros((b, max_boxes), np.int32)
    box_valid = np.zeros((b, max_boxes), bool)

    for i, (img, rec) in enumerate(zip(images, records)):
        h, w = img.shape[:2]
        s = resize_scale(h, w, min_size, max_size)
        # shrink further if the canvas is smaller than the resize target
        s = min(s, canvas.height / h, canvas.width / w)
        rh, rw = int(round(h * s)), int(round(w * s))
        out_img[i, :rh, :rw] = resize_image(img, rh, rw)
        valid_hw[i] = (rh, rw)
        scales[i] = s
        src = boxes_override[i] if boxes_override is not None else rec.boxes
        n = min(len(src), max_boxes)
        if n:
            boxes[i, :n] = src[:n] * s
            labels[i, :n] = rec.labels[:n]
            box_valid[i, :n] = True
    return Batch(images=out_img, valid_hw=valid_hw, scale=scales, boxes=boxes,
                 labels=labels, box_valid=box_valid,
                 image_idx=np.asarray(indices, np.int32))


def create_aspect_ratio_groups(aspect_ratios: np.ndarray, k: int = 3) -> np.ndarray:
    """Quantize w/h ratios into 2k+1 log-spaced bins over [1/2, 2]
    (group_by_aspect_ratio.py:186-195). Returns a group id per image."""
    bins = (2.0 ** np.linspace(-1, 1, 2 * k + 1)).tolist() if k > 0 else [1.0]
    return np.asarray([bisect.bisect_right(bins, r) for r in aspect_ratios], np.int64)


def grouped_batch_indices(indices: Sequence[int], group_ids: np.ndarray,
                          batch_size: int, rng: np.random.Generator | None = None,
                          *, drop_incomplete: bool = False) -> list[list[int]]:
    """Batches whose members share a group id (GroupedBatchSampler): optional
    shuffle, per-group buffers, leftover partial batches padded by repeating
    indices of the same group."""
    order = list(indices)
    if rng is not None:
        order = [order[i] for i in rng.permutation(len(order))]

    buffers: dict[int, list[int]] = {}
    batches: list[list[int]] = []
    for idx in order:
        g = int(group_ids[idx])
        buf = buffers.setdefault(g, [])
        buf.append(idx)
        if len(buf) == batch_size:
            batches.append(list(buf))
            buf.clear()
    if not drop_incomplete:
        for g, buf in buffers.items():
            if buf:
                pad = list(itertools.islice(itertools.cycle(buf), batch_size - len(buf)))
                batches.append(buf + pad)
    return batches
