"""Fixed-slot non-maximum suppression (port of ``cald_tpu/ops/nms.py``).

The same tiled scheme as the JAX module, over an explicit batch dimension:

  1. sort candidates by score, descending and stable (invalid ones last),
  2. walk tiles of ``TILE`` candidates in score order: survivors of earlier
     tiles kill overlapped tile members through one (K, T) IoU block, then a
     fixpoint of the greedy recurrence on the (T, T) block settles the tile,
  3. compact survivors into ``max_outputs`` slots.

Semantics are torchvision's: a box is suppressed when a surviving
higher-scoring box overlaps it with IoU strictly greater than the threshold.
The tile loop is static (K / TILE steps); the fixpoint loop stops when no image
of the batch changed, which costs one device-to-host sync per sweep. While a
profiler capture runs, each call is a span ``nms`` and each sweep's check
adds one to its counter ``nms.sweeps`` (``cald_tpu_torch.utils.spans``).
"""

from __future__ import annotations

import torch

from cald_tpu_torch.ops.boxes import box_iou
from cald_tpu_torch.utils.spans import count, span

NEG_INF = -1e30
TILE = 512


def _self_suppression(iou: torch.Tensor, alive0: torch.Tensor,
                      iou_threshold: float) -> torch.Tensor:
    """Greedy suppression within score-sorted tiles. iou (B, T, T); alive0
    (B, T). The greedy result is the unique fixpoint of
    ``a_i = alive0_i and no j < i with a_j and iou[j, i] > t``."""
    t = iou.shape[-1]
    upper = torch.ones((t, t), dtype=torch.bool, device=iou.device).triu(1)
    overlap = (iou > iou_threshold) & upper                       # row j kills col i

    def sweep(a):
        return alive0 & ~(overlap & a[:, :, None]).any(dim=1)

    a = sweep(alive0)
    for _ in range(t):
        nxt = sweep(a)
        count("nms.sweeps")
        if torch.equal(nxt, a):
            break
        a = nxt
    return a


def _tiled_suppression(sboxes: torch.Tensor, alive: torch.Tensor,
                       iou_threshold: float) -> torch.Tensor:
    """Greedy NMS over score-sorted boxes (B, K, 4), K a multiple of TILE."""
    alive = alive.clone()
    for i in range(sboxes.shape[1] // TILE):
        lo, hi = i * TILE, (i + 1) * TILE
        tile_boxes = sboxes[:, lo:hi]
        tile_alive = alive[:, lo:hi]
        if lo > 0:
            # survivors of the finalized (earlier) tiles kill tile members
            cross = box_iou(sboxes[:, :lo], tile_boxes)             # (B, lo, T)
            killed = ((cross > iou_threshold) & alive[:, :lo, None]).any(dim=1)
            tile_alive = tile_alive & ~killed
        alive[:, lo:hi] = _self_suppression(box_iou(tile_boxes, tile_boxes),
                                            tile_alive, iou_threshold)
    return alive


def nms(boxes: torch.Tensor, scores: torch.Tensor, *, iou_threshold: float,
        max_outputs: int, valid: torch.Tensor | None = None,
        pre_nms_size: int | None = None):
    """Single-class NMS over a batch.

    boxes (B, N, 4); scores (B, N); valid optional (B, N) bool. Only the
    ``pre_nms_size`` top-scored candidates compete (default N).

    Returns keep_idx (B, max_outputs) int64 indices into N, score-descending,
    and keep_valid (B, max_outputs) bool.
    """
    with span("nms"):
        b, n = scores.shape
        p = min(pre_nms_size or n, n)
        p_pad = -(-p // TILE) * TILE
        if valid is None:
            valid = torch.ones_like(scores, dtype=torch.bool)
        masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
        order = torch.sort(-masked, dim=1, stable=True).indices[:, :p]   # (B, P)
        sboxes = torch.gather(boxes, 1, order[..., None].expand(b, p, 4))
        salive = torch.gather(masked, 1, order) > NEG_INF / 2
        if p_pad != p:  # pad to the tile size with dead slots
            sboxes = torch.cat([sboxes, sboxes.new_zeros((b, p_pad - p, 4))], dim=1)
            salive = torch.cat([salive, salive.new_zeros((b, p_pad - p))], dim=1)

        kept = _tiled_suppression(sboxes, salive, iou_threshold)[:, :p]

        # compact kept entries (already score-sorted) into max_outputs slots; the
        # extra column collects everything that does not get a slot
        rank = torch.cumsum(kept.to(torch.int64), dim=1) - 1
        slot = torch.where(kept & (rank < max_outputs), rank,
                           torch.full_like(rank, max_outputs))
        keep_idx = order.new_zeros((b, max_outputs + 1)).scatter_(1, slot, order)
        keep_valid = kept.new_zeros((b, max_outputs + 1)).scatter_(
            1, slot, torch.ones_like(kept))
        return keep_idx[:, :max_outputs], keep_valid[:, :max_outputs]


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor, *,
                iou_threshold: float, max_outputs: int,
                valid: torch.Tensor | None = None, pre_nms_size: int | None = None):
    """Class-aware NMS through the coordinate-offset trick (torchvision
    ``batched_nms``): each class is shifted into its own region of the plane,
    per image. Shapes as in ``nms`` plus labels (B, N)."""
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    max_coord = torch.where(valid[..., None], boxes, torch.zeros_like(boxes)).amax(dim=(1, 2))
    offsets = labels.to(boxes.dtype) * (max_coord[:, None] + 1.0)
    return nms(boxes + offsets[..., None], scores, iou_threshold=iou_threshold,
               max_outputs=max_outputs, valid=valid, pre_nms_size=pre_nms_size)
