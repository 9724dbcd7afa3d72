"""COCO segmentation decoding — polygons / RLE → binary masks (NumPy; copy
of ``cald_tpu/data/masks.py``).

The reference's ``convert_coco_poly_to_mask`` (detection/coco_utils.py:33-47)
rasterizes through pycocotools' C RLE routines. pycocotools is not a
dependency, so this is a self-contained reimplementation:

  * compressed RLE strings use COCO's published 5-bit varint charcode
    (pycocotools ``rleFrString``) — decoded exactly;
  * uncompressed RLE dicts (``{"counts": [...], "size": [h, w]}``) follow
    COCO's column-major run order — decoded exactly;
  * polygons are filled with an even-odd scanline at pixel centers —
    semantically equivalent to pycocotools' line-upsampling rasterizer;
    border pixels may differ by ±1 px on slanted edges.

None of the AL drivers consume masks (they detect boxes only); this is
``CocoDataset.masks_for``'s decoder, for dataset-API completeness.
"""

from __future__ import annotations

import numpy as np


def decode_rle_counts(counts, h: int, w: int) -> np.ndarray:
    """Decode an RLE counts sequence (list of run lengths, column-major,
    starting with a background run) into an (h, w) bool mask."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total != h * w:
        raise ValueError(f"RLE runs sum to {total}, expected {h * w}")
    flat = np.zeros(h * w, bool)
    pos = 0
    val = False
    for run in counts:
        if val:
            flat[pos:pos + run] = True
        pos += int(run)
        val = not val
    # COCO RLE is column-major (Fortran order)
    return flat.reshape((w, h)).T


def decode_compressed_rle(s, h: int, w: int) -> np.ndarray:
    """Decode COCO's compressed RLE string (pycocotools ``rleFrString``):
    5-bit varint chunks offset by 48, continuation bit 0x20, sign-extend
    bit 0x10, and every run after the second is delta-coded against the
    run two places back."""
    if isinstance(s, str):
        s = s.encode()
    cnts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k + 5)
            k += 1
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return decode_rle_counts(cnts, h, w)


def rasterize_polygon(poly, h: int, w: int) -> np.ndarray:
    """Even-odd scanline fill of one flat [x0, y0, x1, y1, ...] polygon at
    pixel centers, vectorized over rows; returns (h, w) bool."""
    xy = np.asarray(poly, np.float64).reshape(-1, 2)
    if len(xy) < 3:
        return np.zeros((h, w), bool)
    x0, y0 = xy[:, 0], xy[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    yc = np.arange(h, dtype=np.float64)[:, None] + 0.5      # (h, 1)
    # edges crossing each scanline (half-open rule avoids double-counting
    # vertices)
    ymin = np.minimum(y0, y1)[None, :]
    ymax = np.maximum(y0, y1)[None, :]
    crosses = (yc >= ymin) & (yc < ymax)                    # (h, E)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (yc - y0[None, :]) / (y1 - y0)[None, :]
    xs = x0[None, :] + t * (x1 - x0)[None, :]               # (h, E)
    xs = np.where(crosses, xs, np.inf)
    xs.sort(axis=1)                                         # inf pads right
    mask = np.zeros((h, w), bool)
    xc = np.arange(w, dtype=np.float64) + 0.5
    # even-odd: pixel center is inside iff an odd number of crossings lie
    # to its left
    inside = (xc[None, None, :] >= xs[:, :, None]).sum(axis=1) % 2 == 1
    mask[:] = inside
    return mask


def segmentation_to_mask(seg, h: int, w: int) -> np.ndarray:
    """One annotation's ``segmentation`` field → (h, w) bool mask
    (union over its polygons, matching coco_utils.py:33-47's ``any``)."""
    if isinstance(seg, dict):
        counts = seg["counts"]
        sh, sw = seg.get("size", (h, w))
        if isinstance(counts, (bytes, str)):
            return decode_compressed_rle(counts, int(sh), int(sw))
        return decode_rle_counts(counts, int(sh), int(sw))
    mask = np.zeros((h, w), bool)
    for poly in seg:
        mask |= rasterize_polygon(poly, h, w)
    return mask


def convert_coco_poly_to_mask(segmentations, h: int, w: int) -> np.ndarray:
    """(N, h, w) uint8 masks from a list of segmentation fields
    (reference coco_utils.py:33-47; empty list → (0, h, w))."""
    if not segmentations:
        return np.zeros((0, h, w), np.uint8)
    return np.stack([segmentation_to_mask(s, h, w).astype(np.uint8)
                     for s in segmentations])
