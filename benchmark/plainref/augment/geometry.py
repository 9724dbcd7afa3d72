"""Geometric augmentations on fixed-canvas batches (port of
``cald_tpu/augment/geometry.py``).

Images are (B, H, W, C) float tensors on a fixed canvas whose top-left
``valid_hw[b]`` region is valid and the rest zero. Each function maps the
pixels, the reference boxes (B, K, 4) and the valid sizes (B, 2) with the
coordinate math of the reference's ``cald_helper.py``.

Pixels follow the JAX package's separable scheme, not PIL: resizing is one
banded interpolation matrix per axis, and rotation is a two-pass shear (scale
plus per-line fractional translation along x, then along y), so every pixel is
interpolated twice in 1-D instead of once in 2-D. That is the JAX package's
documented deviation from the reference, kept so the two agree.
"""

from __future__ import annotations

import math

import torch

_SHEAR_PAD = 128   # max |fractional translate| the padded slices support
_GROUP = 16        # lines per shared integer shift in the grouped translate


def horizontal_flip(images: torch.Tensor, boxes: torch.Tensor, valid_hw: torch.Tensor):
    """Flip each image's valid region left-right; x1' = w - x2, x2' = w - x1."""
    b, _, cw, c = images.shape
    w = valid_hw[:, 1:2]                                            # (B, 1)
    xs = torch.arange(cw, device=images.device)[None, :]
    src_x = torch.where(xs < w, w - 1 - xs, xs)                     # (B, W)
    flipped = torch.gather(images, 2, src_x[:, None, :, None].expand(
        b, images.shape[1], cw, c))
    wf = w.to(boxes.dtype)
    new_boxes = torch.stack([wf - boxes[..., 2], boxes[..., 1],
                             wf - boxes[..., 0], boxes[..., 3]], dim=-1)
    return flipped, new_boxes, valid_hw


def _band(lo: torch.Tensor, frac: torch.Tensor, canvas_in: int):
    """(B, n_out, canvas_in) rows with weights 1-frac at ``lo`` and frac at
    ``lo + 1``."""
    cols = torch.arange(canvas_in, dtype=torch.float32, device=lo.device)[None, None, :]
    zero = torch.zeros((), device=lo.device)
    return (torch.where(cols == lo[..., None], 1.0 - frac[..., None], zero)
            + torch.where(cols == lo[..., None] + 1.0, frac[..., None], zero))


def _interp_matrix(canvas_out: int, n_out: torch.Tensor, n_in: torch.Tensor,
                   canvas_in: int) -> torch.Tensor:
    """(B, canvas_out, canvas_in) 1-D bilinear resize matrices, PIL pixel
    centres: row i samples (i + 0.5) * n_in/n_out - 0.5. Rows >= n_out and
    columns >= n_in are zero. n_out, n_in: (B,) float."""
    i = torch.arange(canvas_out, dtype=torch.float32, device=n_in.device)[None, :]
    n_in = n_in[:, None]
    n_out = n_out[:, None]
    src = (i + 0.5) * (n_in / n_out.clamp_min(1.0)) - 0.5
    src = torch.minimum(src.clamp_min(0.0), n_in - 1.0)
    lo = torch.minimum(torch.floor(src), (n_in - 2.0).clamp_min(0.0))
    m = _band(lo, src - lo, canvas_in)
    cols = torch.arange(canvas_in, device=n_in.device)[None, None, :]
    m = torch.where((i < n_out)[..., None], m, torch.zeros((), device=m.device))
    return torch.where(cols < n_in[..., None], m, torch.zeros((), device=m.device))


def resize_image_boxes(images: torch.Tensor, boxes: torch.Tensor,
                       valid_hw: torch.Tensor, ratio: float):
    """Scale each valid region by ``ratio`` about the canvas origin; boxes *=
    ratio; the new valid size is floor(size * ratio) like PIL's int()."""
    _, ch, cw, _ = images.shape
    h = valid_hw[:, 0].float()
    w = valid_hw[:, 1].float()
    nh = torch.floor(h * ratio)
    nw = torch.floor(w * ratio)
    my = _interp_matrix(ch, nh, h, ch).to(images.dtype)             # (B, H, H)
    mx = _interp_matrix(cw, nw, w, cw).to(images.dtype)             # (B, W, W)
    out = torch.einsum("bYy,byxc->bYxc", my, images)
    out = torch.einsum("bXx,byxc->byXc", mx, out)
    return out, boxes * ratio, torch.stack([nh, nw], dim=-1).to(valid_hw.dtype)


def _affine_1d_matrix(canvas: int, scale: torch.Tensor, n_in: torch.Tensor) -> torch.Tensor:
    """(B, canvas, canvas) matrices sampling src = scale * i along one axis,
    zero outside [0, n_in - 1] (the black border of expand=True rotation)."""
    i = torch.arange(canvas, dtype=torch.float32, device=n_in.device)[None, :]
    src = scale[:, None] * i
    n_in = n_in[:, None]
    ok = (src >= 0.0) & (src <= n_in - 1.0)
    srcc = torch.minimum(src.clamp_min(0.0), (n_in - 2.0).clamp_min(0.0))
    lo = torch.floor(srcc)
    m = _band(lo, srcc - lo, canvas)
    cols = torch.arange(canvas, device=n_in.device)[None, None, :]
    m = torch.where(ok[..., None], m, torch.zeros((), device=m.device))
    return torch.where(cols < n_in[..., None], m, torch.zeros((), device=m.device))


def _translate_lines(image: torch.Tensor, shifts: torch.Tensor, taps: int) -> torch.Tensor:
    """out[b, v, x] = image[b, v, x + shifts[b, v]] with zeros outside, each
    line's fractional shift applied as a 2-tap lerp.

    image (B, V, X, C), shifts (B, V). The arithmetic follows the JAX
    package's translate: with V a multiple of 16, lines share the group's
    integer base shift k and the residual r = shift - k is split into the
    two bilinear-hat weights at floor(r) and floor(r) + 1; otherwise each line
    takes k = floor(shift) and weights (1 - r, r).
    """
    b, v, x, c = image.shape
    dt = image.dtype
    pad = _SHEAR_PAD
    if v % _GROUP == 0:
        k = torch.floor(shifts.reshape(b, v // _GROUP, _GROUP).amin(dim=2))
        k = k.clamp(-pad, pad - taps).repeat_interleave(_GROUP, dim=1)
        r = shifts - k
        t0 = torch.floor(r)
        w_lo = (1.0 - (r - t0)).clamp(0.0, 1.0).to(dt)
        w_hi = (1.0 - (t0 + 1.0 - r)).clamp(0.0, 1.0).to(dt)
        base = k + t0
    else:
        base = torch.floor(shifts).clamp(-pad, pad - 1)
        w_hi = (shifts - base).to(dt)
        w_lo = 1.0 - w_hi
    padded = torch.nn.functional.pad(image, (0, 0, pad, pad + 1))
    idx = (base.long() + pad)[..., None] + torch.arange(x, device=image.device)  # (B, V, X)
    idx = idx[..., None].expand(b, v, x, c)
    lo = torch.gather(padded, 2, idx)
    hi = torch.gather(padded, 2, idx + 1)
    return lo * w_lo[..., None, None] + hi * w_hi[..., None, None]


def rotate_image_boxes(images: torch.Tensor, boxes: torch.Tensor,
                       valid_hw: torch.Tensor, angle_deg: float):
    """Rotate by ``angle_deg`` with expand=True, then resize back to (h, w).

    Box math: rotate the 4 corners, take the enclosing box, rescale by the
    expanded size, clamp. Pixels: the net inverse affine
    ``src_x = m00*x + m01*y + c0, src_y = m10*x + m11*y + c1`` factors into a
    horizontal scale + per-row translate and a vertical scale + per-column
    translate (valid while |angle| < 90 deg).
    """
    _, ch, cw, _ = images.shape
    h = valid_hw[:, 0].float()
    w = valid_hw[:, 1].float()
    ang = math.radians(angle_deg)
    alpha = math.cos(ang)
    beta = math.sin(ang)
    cx = w / 2
    cy = h / 2
    # expanded size (the reference truncates with int())
    nw = torch.floor(h * abs(beta) + w * abs(alpha))
    nh = torch.floor(h * abs(alpha) + w * abs(beta))
    tx = (1 - alpha) * cx - beta * cy + nw / 2 - cx
    ty = beta * cx + (1 - alpha) * cy + nh / 2 - cy

    sxs = nw / w
    sys_ = nh / h
    m00 = alpha * sxs
    m01 = -beta * sys_
    c0 = beta * ty - alpha * tx
    m10 = beta * sxs
    m11 = alpha * sys_
    c1 = -(beta * tx + alpha * ty)

    if angle_deg == 0.0:
        out = images
    else:
        taps = int(math.ceil(16 * math.tan(abs(ang)) * 1.5)) + 2
        # pass 1 (x): T[v, x] = I[v, a1*x + b1(v)]
        a1 = m00 - m01 * m10 / m11
        rows = torch.arange(ch, dtype=torch.float32, device=images.device)[None, :]
        b1 = (m01 / m11)[:, None] * rows + (c0 - m01 * c1 / m11)[:, None]
        mx = _affine_1d_matrix(cw, a1, w).to(images.dtype)
        t = torch.einsum("bXx,bhxc->bhXc", mx, images)
        t = _translate_lines(t, b1 / a1[:, None], taps)
        # pass 2 (y): O[y, x] = T[m11*y + b2(x), x]
        cols = torch.arange(cw, dtype=torch.float32, device=images.device)[None, :]
        b2 = m10[:, None] * cols + c1[:, None]
        my = _affine_1d_matrix(ch, m11, h).to(images.dtype)
        t = torch.einsum("bYy,byxc->bYxc", my, t)
        out = _translate_lines(t.transpose(1, 2), b2 / m11[:, None], taps).transpose(1, 2)

    ys = torch.arange(ch, device=images.device)[None, :, None]
    xs = torch.arange(cw, device=images.device)[None, None, :]
    mask = (ys < h[:, None, None]) & (xs < w[:, None, None])
    out = torch.where(mask[..., None], out, torch.zeros((), dtype=out.dtype,
                                                        device=out.device))

    x1, y1, x2, y2 = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    cxs = torch.stack([x1, x2, x1, x2], dim=-1)
    cys = torch.stack([y1, y1, y2, y2], dim=-1)
    rx = alpha * cxs + beta * cys + tx[:, None, None]
    ry = -beta * cxs + alpha * cys + ty[:, None, None]
    scale_x = (nw / w)[:, None]
    scale_y = (nh / h)[:, None]
    wb, hb = w[:, None], h[:, None]
    zero = torch.zeros((), device=boxes.device)
    nx1 = torch.minimum(torch.maximum(rx.amin(-1) / scale_x, zero), wb)
    nx2 = torch.minimum(torch.maximum(rx.amax(-1) / scale_x, zero), wb)
    ny1 = torch.minimum(torch.maximum(ry.amin(-1) / scale_y, zero), hb)
    ny2 = torch.minimum(torch.maximum(ry.amax(-1) / scale_y, zero), hb)
    return out, torch.stack([nx1, ny1, nx2, ny2], dim=-1), valid_hw
