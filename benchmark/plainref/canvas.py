"""The reference's own canvases: Pillow decodes each JPEG, and the resize
into the batch's canvas is a frozen copy of ``ResizeIntoCanvas``'s plain
version (``cald_tpu_torch/native/nvjpeg.py::resize_into_canvas_plain``, the
C++ order in float32), with the canvas rule of the loader's fused path
(``data/batching.py``: the torchvision min/max-side scale, the smallest of
the two default canvases that fits the batch, shrunk where it does not).
"""

from __future__ import annotations

import numpy as np
import torch


def default_canvases(min_size: int, max_size: int, multiple: int = 64):
    def up(x):
        return int(-(-x // multiple) * multiple)

    return ((up(min_size), up(max_size)), (up(max_size), up(min_size)))


def resize_scale(h: int, w: int, min_size: int, max_size: int) -> float:
    return min(min_size / min(h, w), max_size / max(h, w))


def choose_canvas(h: int, w: int, canvases) -> tuple[int, int]:
    fitting = [c for c in canvases if h <= c[0] and w <= c[1]]
    if not fitting:
        return max(canvases, key=lambda c: c[0] * c[1])
    return min(fitting, key=lambda c: c[0] * c[1])


def output_size(h: int, w: int, scale: float) -> tuple[int, int]:
    s = np.float32(scale)
    return int(np.rint(np.float32(h) * s)), int(np.rint(np.float32(w) * s))


def decode(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im.convert("RGB"), np.uint8)


def image_size(path: str) -> tuple[int, int]:
    from PIL import Image

    with Image.open(path) as im:
        return im.height, im.width


def resize_into(src: torch.Tensor, out: torch.Tensor, oh: int, ow: int) -> None:
    """Bilinear resize of ``src`` (h, w, 3) float32 into the top-left
    (oh, ow) of ``out``, zeros elsewhere."""
    f32 = torch.float32
    sh, sw = src.shape[:2]
    out.zero_()

    def axis(n_out: int, n_src: int):
        ratio = torch.tensor(n_src, dtype=f32) / torch.tensor(n_out, dtype=f32)
        s = ((torch.arange(n_out, dtype=f32) + 0.5) * ratio - 0.5).clamp(0, n_src - 1)
        i0 = s.long()
        return i0, (i0 + 1).clamp(max=n_src - 1), s - i0.to(f32)

    y0, y1, ly = (t.to(out.device) for t in axis(oh, sh))
    x0, x1, lx = (t.to(out.device) for t in axis(ow, sw))
    ly, lx = ly[:, None, None], lx[None, :, None]
    w00, w01 = (1 - ly) * (1 - lx), (1 - ly) * lx
    w10, w11 = ly * (1 - lx), ly * lx
    r0, r1 = src[y0], src[y1]
    out[:oh, :ow] = w00 * r0[:, x0] + w01 * r0[:, x1] + w10 * r1[:, x0] + w11 * r1[:, x1]


def batch_canvas(paths, keep, min_size: int, max_size: int, device):
    """The canvas of the batch of ``paths`` (every member decides its size),
    filled for the members at positions ``keep``: ((len(keep), H, W, 3)
    float32, valid_hw (len(keep), 2) int32)."""
    sizes = [image_size(p) for p in paths]
    scales = [resize_scale(h, w, min_size, max_size) for h, w in sizes]
    need_h = max(int(round(h * s)) for (h, w), s in zip(sizes, scales))
    need_w = max(int(round(w * s)) for (h, w), s in zip(sizes, scales))
    ch, cw = choose_canvas(need_h, need_w, default_canvases(min_size, max_size))
    out = torch.zeros((len(keep), ch, cw, 3), dtype=torch.float32, device=device)
    hw = np.zeros((len(keep), 2), np.int32)
    for j, i in enumerate(keep):
        h, w = sizes[i]
        s = min(scales[i], ch / h, cw / w)
        oh, ow = output_size(h, w, s)
        src = torch.from_numpy(decode(paths[i])).to(device, torch.float32)
        resize_into(src, out[j], oh, ow)
        hw[j] = (oh, ow)
    return out, torch.from_numpy(hw).to(device)
