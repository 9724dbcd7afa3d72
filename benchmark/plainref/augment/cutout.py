"""Cutout with box-overlap rejection (port of ``cald_tpu/augment/cutout.py``).

Reference behaviour: up to ``attempts`` tries, each a rectangle of U(0.05, 0.2)
of each valid dimension at a uniform position, REJECTED when the largest
fraction of a valid box it covers is above 0.4 or below 0.1; the first
``cut_num`` accepted rectangles are filled with ``fill_val``; boxes are
unchanged.

The uniforms are an input, ``u`` (B, attempts, 4) = (size_h, size_w, top,
left), so tests can inject the JAX package's draws. The acceptance test of an
attempt does not depend on earlier attempts, so the sequential scan becomes
"the first ``cut_num`` attempts that pass", computed for all attempts at once.
"""

from __future__ import annotations

import torch


def cutout(images: torch.Tensor, boxes: torch.Tensor, box_valid: torch.Tensor,
           valid_hw: torch.Tensor, u: torch.Tensor, *, cut_num: int = 2,
           fill_val: float = 0.0, remove_thres: float = 0.4,
           min_thres: float = 0.1) -> torch.Tensor:
    """images (B, H, W, C); boxes (B, K, 4); box_valid (B, K); valid_hw (B, 2);
    u (B, attempts, 4) uniforms in [0, 1). Returns the new images."""
    h = valid_hw[:, 0:1].float()                                    # (B, 1)
    w = valid_hw[:, 1:2].float()
    ch_ = u[..., 0] * 0.15 * h + 0.05 * h                           # (B, T)
    cw_ = u[..., 1] * 0.15 * w + 0.05 * w
    top = u[..., 2] * (h - ch_)
    left = u[..., 3] * (w - cw_)
    # the reference truncates the rect to ints before intersecting/filling
    x1, y1 = torch.floor(left), torch.floor(top)
    x2, y2 = torch.floor(left + cw_), torch.floor(top + ch_)

    bx = boxes[:, None]                                             # (B, 1, K, 4)
    areas = ((bx[..., 2] - bx[..., 0]) * (bx[..., 3] - bx[..., 1])).clamp_min(1e-8)
    iw = (torch.minimum(x2[..., None], bx[..., 2])
          - torch.maximum(x1[..., None], bx[..., 0])).clamp_min(0.0)
    ih = (torch.minimum(y2[..., None], bx[..., 3])
          - torch.maximum(y1[..., None], bx[..., 1])).clamp_min(0.0)
    ratio = torch.where(box_valid[:, None], iw * ih / areas,
                        torch.full_like(areas.expand_as(iw), float("-inf")))
    rmax = ratio.amax(dim=-1)                                       # (B, T)
    ok = (rmax <= remove_thres) & (rmax >= min_thres)
    accepted = ok & (torch.cumsum(ok.to(torch.int64), dim=1) <= cut_num)

    ys = torch.arange(images.shape[1], dtype=torch.float32, device=images.device)
    xs = torch.arange(images.shape[2], dtype=torch.float32, device=images.device)
    in_y = (ys >= y1[..., None]) & (ys < y2[..., None])             # (B, T, H)
    in_x = (xs >= x1[..., None]) & (xs < x2[..., None])             # (B, T, W)
    in_y = in_y & accepted[..., None]
    # a pixel is filled when any accepted rectangle covers it
    covered = torch.einsum("bth,btw->bhw", in_y.to(torch.float32), in_x.to(torch.float32)) > 0
    return torch.where(covered[..., None],
                       torch.full((), fill_val, dtype=images.dtype, device=images.device),
                       images)
