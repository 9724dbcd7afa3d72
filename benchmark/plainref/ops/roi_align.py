"""Multi-scale RoIAlign, plain PyTorch (port of the ``points`` path of
``cald_tpu/ops/roi_align.py``).

torchvision ``MultiScaleRoIAlign`` semantics: ``aligned=False``,
``sampling_ratio=2``, the FPN level rule ``k = floor(4 + log2(sqrt(area)/224))``
clamped to the pyramid, and torchvision's border handling (samples with
y < -1 or y > H contribute zero, others are clamped into the level).

``multi_scale_roi_align`` is the reference of the inference forward (K1)
and, differentiated by autograd, of the training forward and backward (K2,
K3); ``_pooled_taps`` (the separable taps) serves the benchmark's count of
the bytes a RoIAlign reads.
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


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """``a / d`` as an IEEE division on every device: PyTorch's CUDA kernels
    multiply by the reciprocal of a Python-scalar divisor, which moves sample
    positions by an ulp against the CPU, the JAX reference and the kernels."""
    return a / torch.full((), float(d), dtype=a.dtype, device=a.device)


def _axis_samples(start, extent, n_valid, out_size: int, sr: int):
    """Sample positions along one axis for every roi: (R, out_size*sr) base
    index, its neighbour, the fraction, and the border mask."""
    steps = _div(torch.arange(out_size * sr, dtype=torch.float32, device=start.device) + 0.5,
                 sr)
    pos = start[:, None] + steps * _div(extent, out_size)[:, None]
    n = n_valid[:, None]
    inside = (pos >= -1.0) & (pos <= n)
    p = torch.minimum(pos.clamp_min(0.0), n - 1.0)
    lo = torch.floor(p)
    hi = torch.minimum(lo + 1.0, n - 1.0)
    # samples outside (a non-finite roi's too) read pixel 0 with weight 0
    zero = torch.zeros((), dtype=torch.int64, device=pos.device)
    return (torch.where(inside, lo.to(torch.int64), zero),
            torch.where(inside, hi.to(torch.int64), zero), p - lo, inside)


class _Pyramid:
    """The levels flattened to one (B * P, C) row buffer: each roi reads only
    at its own level through a per-level row offset."""

    def __init__(self, level_shapes: Sequence[tuple], spatial_scales: Sequence[float],
                 device):
        sizes = [s[1] * s[2] for s in level_shapes]
        self.p_total = sum(sizes)
        self.hs = torch.tensor([float(s[1]) for s in level_shapes], device=device)
        self.ws = torch.tensor([float(s[2]) for s in level_shapes], device=device)
        self.scales = torch.tensor(list(spatial_scales), dtype=torch.float32, device=device)
        self.offs = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))], device=device)


def _chunks(pyr: _Pyramid, rois: torch.Tensor, valid, levels, output_size: int,
            sampling_ratio: int, chunk_size: int):
    """Per chunk of rois: its slice of the (B * N) rois and the four bilinear
    corners of every sample as (row index into the flat pyramid (R, S, S),
    weight (R, S, S)). Samples outside the level (torchvision's border rule)
    and invalid rois carry weight 0."""
    b, n = rois.shape[:2]
    dev = rois.device
    rois_f = rois.reshape(-1, 4).float()
    lv = levels.reshape(-1).long()
    img = torch.arange(b, device=dev).repeat_interleave(n)
    keep = (valid.reshape(-1) if valid is not None
            else torch.ones(b * n, dtype=torch.bool, device=dev))
    for start in range(0, b * n, chunk_size):
        sl = slice(start, min(start + chunk_size, b * n))
        r = rois_f[sl]
        l = lv[sl]
        scale = pyr.scales[l]
        h_l, w_l = pyr.hs[l], pyr.ws[l]
        x1 = r[:, 0] * scale
        y1 = r[:, 1] * scale
        roi_w = (r[:, 2] * scale - x1).clamp_min(1.0)
        roi_h = (r[:, 3] * scale - y1).clamp_min(1.0)
        y0, y1i, ly, in_y = _axis_samples(y1, roi_h, h_l, output_size, sampling_ratio)
        x0, x1i, lx, in_x = _axis_samples(x1, roi_w, w_l, output_size, sampling_ratio)
        base = (img[sl] * pyr.p_total + pyr.offs[l])[:, None, None]
        wi = w_l.long()[:, None, None]
        inside = in_y[:, :, None] & in_x[:, None, :] & keep[sl, None, None]
        hy, hx = 1.0 - ly, 1.0 - lx
        zero = torch.zeros((), device=dev)
        corners = [(base + yi[:, :, None] * wi + xi[:, None, :],
                    torch.where(inside, wy[:, :, None] * wx[:, None, :], zero))
                   for yi, wy in ((y0, hy), (y1i, ly)) for xi, wx in ((x0, hx), (x1i, lx))]
        yield sl, corners


def multi_scale_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor, *,
                          spatial_scales: Sequence[float],
                          valid: torch.Tensor | None = None,
                          levels: torch.Tensor | None = None,
                          output_size: int = 7, sampling_ratio: int = 2,
                          chunk_size: int = 256,
                          out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """RoIAlign over an FPN pyramid with per-roi level assignment.

    feats: list of (B, H_l, W_l, C) levels, finest first; rois (B, N, 4) in
    image coordinates; valid optional (B, N) bool (invalid rois give zeros);
    levels optional (B, N) level per roi (default: ``roi_levels``).
    Returns (B, N, output_size, output_size, C) in ``out_dtype`` (default:
    the feature dtype). Sums are taken in float32.

    Differentiable with respect to ``feats`` by autograd; the explicit
    backward is ``multi_scale_roi_align_backward``.
    """
    b, n = rois.shape[:2]
    c = feats[0].shape[-1]
    dev = rois.device
    if levels is None:
        levels = roi_levels(rois, spatial_scales)
    pyr = _Pyramid([f.shape for f in feats], spatial_scales, dev)
    flat = torch.cat([f.reshape(b, -1, c) for f in feats], dim=1).reshape(-1, c)
    s = output_size * sampling_ratio
    out = torch.zeros((b * n, output_size, output_size, c), dtype=torch.float32, device=dev)
    for sl, corners in _chunks(pyr, rois, valid, levels, output_size, sampling_ratio,
                               chunk_size):
        val = sum(w[..., None] * flat[rows.reshape(-1)].reshape(-1, s, s, c).float()
                  for rows, w in corners)
        out[sl] = val.reshape(-1, output_size, sampling_ratio, output_size,
                              sampling_ratio, c).mean(dim=(2, 4))
    return out.reshape(b, n, output_size, output_size, c).to(out_dtype or feats[0].dtype)


def _pooled_taps(start, extent, n_valid, out_size: int, sr: int, bf16: bool):
    """The pooled axis weights of K4 for every roi: for each output bin its
    ``2 * sr`` (pixel, weight) taps, (R, out_size, 2 * sr) each. Each sample
    puts ``1 - frac`` on its low pixel and ``frac`` on the next; a bin's
    weight on a pixel is the mean over its ``sr`` samples of their weights
    there, as the JAX package's ``_axis_weights`` sums its one-hot rows. A
    pixel that several taps of a bin share carries the whole weight on its
    first tap and 0 on the others. Samples outside the level weigh 0. With
    ``bf16`` the weights are rounded to bfloat16 (and back)."""
    lo, hi, frac, inside = _axis_samples(start, extent, n_valid, out_size, sr)
    zero = torch.zeros((), device=frac.device)
    w_lo = torch.where(inside, 1.0 - frac, zero)
    w_hi = torch.where(inside, frac, zero)
    r = lo.shape[0]
    # (R, out, sr, 2): the taps of each sample, low pixel first
    pix = torch.stack([lo, hi], -1).reshape(r, out_size, sr, 2)
    con = torch.stack([w_lo, w_hi], -1).reshape(r, out_size, sr, 2)
    # each sample's weight on each tap's pixel (a sample's two taps are one
    # pixel only at the level's edge, where the second weighs 0)
    per_sample = torch.where(pix[..., None] == pix.reshape(r, out_size, 1, 1, 2 * sr),
                             con[..., None], zero).sum(dim=3)          # (R, out, sr, 2sr)
    pooled = per_sample.sum(dim=2) / float(sr)                         # (R, out, 2sr)
    flat = pix.reshape(r, out_size, 2 * sr)
    k = torch.arange(2 * sr, device=flat.device)
    earlier = (flat[..., :, None] == flat[..., None, :]) & (k[None, :] < k[:, None])
    pooled = torch.where(earlier.any(dim=-1), zero, pooled)
    if bf16:
        pooled = pooled.to(torch.bfloat16).float()
    return flat, pooled
