"""Multi-scale RoIAlign, plain PyTorch (port of the ``points`` path of
``cald_tpu/ops/roi_align.py``).

torchvision ``MultiScaleRoIAlign`` semantics: ``aligned=False``,
``sampling_ratio=2``, the FPN level rule ``k = floor(4 + log2(sqrt(area)/224))``
clamped to the pyramid, and torchvision's border handling (samples with
y < -1 or y > H contribute zero, others are clamped into the level).

This is the plain version of the Hopper kernel in ``ops/roi_align_cuda.py``:
the CPU path of the detector and the yardstick the kernel is held to.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def fpn_level_assignment(rois: torch.Tensor, *, k_min: int = 2, k_max: int = 5,
                         canonical_scale: float = 224.0,
                         canonical_level: int = 4) -> torch.Tensor:
    """FPN level per roi (torchvision ``LevelMapper``): int32 in
    [0, k_max - k_min], indexing the pyramid list. rois (..., 4)."""
    ws = rois[..., 2] - rois[..., 0]
    hs = rois[..., 3] - rois[..., 1]
    s = torch.sqrt((ws * hs).clamp_min(0.0))
    lvl = torch.floor(canonical_level + torch.log2(s / canonical_scale + 1e-6))
    return (lvl.clamp(k_min, k_max) - k_min).to(torch.int32)


def roi_levels(rois: torch.Tensor, spatial_scales: Sequence[float]) -> torch.Tensor:
    """Pyramid level per roi for a pyramid with these scales (finest first);
    the mapper range follows torchvision's ``setup_scales``."""
    k_min = int(round(-math.log2(spatial_scales[0])))
    k_max = int(round(-math.log2(spatial_scales[-1])))
    lv = fpn_level_assignment(rois, k_min=k_min, k_max=k_max)
    return lv.clamp(0, len(spatial_scales) - 1)


def _axis_samples(start, extent, n_valid, out_size: int, sr: int):
    """Sample positions along one axis for every roi: (R, out_size*sr) base
    index, its neighbour, the fraction, and the border mask."""
    steps = (torch.arange(out_size * sr, dtype=torch.float32,
                          device=start.device) + 0.5) / sr
    pos = start[:, None] + steps * (extent / out_size)[:, None]
    n = n_valid[:, None]
    inside = (pos >= -1.0) & (pos <= n)
    p = torch.minimum(pos.clamp_min(0.0), n - 1.0)
    lo = torch.floor(p)
    hi = torch.minimum(lo + 1.0, n - 1.0)
    return lo.to(torch.int64), hi.to(torch.int64), p - lo, inside


def multi_scale_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor, *,
                          spatial_scales: Sequence[float],
                          valid: torch.Tensor | None = None,
                          levels: torch.Tensor | None = None,
                          output_size: int = 7, sampling_ratio: int = 2,
                          chunk_size: int = 256) -> torch.Tensor:
    """RoIAlign over an FPN pyramid with per-roi level assignment.

    feats: list of (B, H_l, W_l, C) levels, finest first; rois (B, N, 4) in
    image coordinates; valid optional (B, N) bool (invalid rois give zeros);
    levels optional (B, N) level per roi (default: ``roi_levels``).
    Returns (B, N, output_size, output_size, C) in the feature dtype. Sums
    are taken in float32.
    """
    b, n = rois.shape[:2]
    c = feats[0].shape[-1]
    dev = rois.device
    if levels is None:
        levels = roi_levels(rois, spatial_scales)
    # the pyramid flattened to one (B * P, C) row buffer; each roi gathers
    # only at its own level through a per-level row offset
    sizes = [f.shape[1] * f.shape[2] for f in feats]
    p_total = sum(sizes)
    flat = torch.cat([f.reshape(b, -1, c) for f in feats], dim=1).reshape(b * p_total, c)
    hs = torch.tensor([float(f.shape[1]) for f in feats], device=dev)
    ws = torch.tensor([float(f.shape[2]) for f in feats], device=dev)
    scales = torch.tensor(list(spatial_scales), dtype=torch.float32, device=dev)
    offs = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))], device=dev)

    rois_f = rois.reshape(-1, 4).float()
    lv = levels.reshape(-1).long()
    img = torch.arange(b, device=dev).repeat_interleave(n)
    keep = (valid.reshape(-1) if valid is not None
            else torch.ones(b * n, dtype=torch.bool, device=dev))
    s = output_size * sampling_ratio

    out = torch.zeros((b * n, output_size, output_size, c), dtype=torch.float32, device=dev)
    for start in range(0, b * n, chunk_size):
        sl = slice(start, min(start + chunk_size, b * n))
        r = rois_f[sl]
        l = lv[sl]
        scale = scales[l]
        h_l, w_l = hs[l], ws[l]
        x1 = r[:, 0] * scale
        y1 = r[:, 1] * scale
        roi_w = (r[:, 2] * scale - x1).clamp_min(1.0)
        roi_h = (r[:, 3] * scale - y1).clamp_min(1.0)
        y0, y1i, ly, in_y = _axis_samples(y1, roi_h, h_l, output_size, sampling_ratio)
        x0, x1i, lx, in_x = _axis_samples(x1, roi_w, w_l, output_size, sampling_ratio)
        base = (img[sl] * p_total + offs[l])[:, None, None]
        wi = w_l.long()[:, None, None]

        def corner(yi, xi):                                   # (R, S, S, C) f32
            rows = base + yi[:, :, None] * wi + xi[:, None, :]
            return flat[rows.reshape(-1)].reshape(-1, s, s, c).float()

        hy, hx = 1.0 - ly, 1.0 - lx
        val = ((hy[:, :, None] * hx[:, None, :])[..., None] * corner(y0, x0)
               + (hy[:, :, None] * lx[:, None, :])[..., None] * corner(y0, x1i)
               + (ly[:, :, None] * hx[:, None, :])[..., None] * corner(y1i, x0)
               + (ly[:, :, None] * lx[:, None, :])[..., None] * corner(y1i, x1i))
        inside = in_y[:, :, None] & in_x[:, None, :] & keep[sl, None, None]
        val = torch.where(inside[..., None], val, torch.zeros((), device=dev))
        out[sl] = val.reshape(-1, output_size, sampling_ratio, output_size,
                              sampling_ratio, c).mean(dim=(2, 4))
    return out.reshape(b, n, output_size, output_size, c).to(feats[0].dtype)
