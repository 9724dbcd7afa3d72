"""The native decoder's device route: JPEGs decoded on the card by nvJPEG and
resized into a batch's canvas by a hand-written kernel, both in
``csrc/jpeg_decode.cu``.

The JAX package decodes, resizes and pastes each JPEG on the host in one
C++ pass (``native/dataloader.cc``, ``ResizeIntoCanvas`` at ``:80``). Here
nvJPEG decodes each file of a batch into one device buffer, and
``resize_into_canvas_kernel`` (one launch a batch) computes
``ResizeIntoCanvas`` for every image into the zero-padded (B, H, W, 3)
float32 canvas on the card, bit for bit the C++ arithmetic on the same
pixels. ``resize_into_canvas_plain`` is the same function in float32
PyTorch ops in the same order; the wrapper takes it for a canvas on the CPU
(the tests), and launches the kernel or raises for one on the card.

The library is built with ``nvcc`` and ``-lnvjpeg`` at first use
(``ops/cuda_build.py``); importing this module builds nothing, and a failed
build raises with the compiler's message. Every call runs on the calling
thread's own CUDA stream (``thread_stream``) and synchronises it before it
returns, because the loader hands batches from its worker threads to the
consumer; the source keeps one nvJPEG handle per process and a locked pool
of decoder states, so threads never share one.

A file nvJPEG cannot read raises ``JpegRejected`` (an ``IOError``);
``native.decode`` counts it in ``native.rejected`` and the loader sends the
file to Pillow, as the JAX package does with a file libjpeg refuses.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from cald_tpu_torch.ops.cuda_build import CSRC, KernelEntry, build_library
from cald_tpu_torch.utils.spans import span

SOURCE = CSRC / "jpeg_decode.cu"
LIBRARIES = ("nvjpeg",)
REJECTED = -1          # CALD_JPEG_REJECTED in the source
META_WORDS = 6         # per image: byte offset, h, w, channels, out h, out w

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
_IP = ctypes.POINTER(ctypes.c_int)


class JpegRejected(IOError):
    """nvJPEG cannot read the file (corrupt, truncated, or a coding or a
    component count it does not take)."""


def _check(rc: int, what: str):
    if rc == REJECTED:
        raise JpegRejected(f"{what}: nvJPEG rejected the file")
    if rc >= 2000:
        raise RuntimeError(f"{what}: CUDA error {rc - 2000}")
    if rc != 0:
        raise RuntimeError(f"{what}: nvJPEG status {rc - 1000}")


class NvJpeg:
    """nvJPEG's two entry points in the library built from ``jpeg_decode.cu``
    (the header probe and the decode); ``decoded`` counts the images decoded.
    Thread-safe: the first call builds and binds under a lock."""

    def __init__(self):
        self.decoded = 0
        self._lib = None
        self._lock = threading.Lock()

    def load(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(build_library(SOURCE, LIBRARIES)))
                lib.cald_jpeg_info.argtypes = [ctypes.c_char_p, _S, _IP, _IP, _IP]
                lib.cald_jpeg_info.restype = ctypes.c_int
                lib.cald_jpeg_decode.argtypes = [ctypes.c_char_p, _S, _P, _I, _I, _I, _P]
                lib.cald_jpeg_decode.restype = ctypes.c_int
                self._lib = lib
        return self._lib

    def info(self, data: bytes, what: str = "jpeg") -> tuple[int, int, int]:
        """(width, height, components) from the header; components 1 or 3."""
        w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        _check(self.load().cald_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                                          ctypes.byref(c)), what)
        return w.value, h.value, c.value

    def decode(self, data: bytes, out: torch.Tensor, width: int, channels: int,
               what: str = "jpeg"):
        """Decode ``data`` into the uint8 CUDA tensor ``out`` (h * w * c
        bytes, rows of w * c: interleaved RGB, or luma for c = 1) on the
        current stream. Synchronise before reading ``out`` or freeing
        ``data``."""
        stream = torch.cuda.current_stream(out.device).cuda_stream
        _check(self.load().cald_jpeg_decode(data, len(data), out.data_ptr(), width, channels,
                                            out.device.index, stream), what)
        with self._lock:
            self.decoded += 1


nvjpeg = NvJpeg()


def resize_into_canvas_plain(pixels: torch.Tensor, meta: torch.Tensor,
                             canvas: torch.Tensor) -> torch.Tensor:
    """``ResizeIntoCanvas`` (``native/dataloader.cc:80``) of every image into
    ``canvas``: float32 tensor ops in the C++ order, zeros beyond each
    image's (out_h, out_w). ``pixels`` holds the images one after another,
    ``meta`` (B, 6) int64 their byte offset, h, w, channels (1 or 3), out_h
    and out_w."""
    f32 = torch.float32
    canvas.zero_()
    for (off, sh, sw, ch, oh, ow), out in zip(meta.tolist(), canvas):
        src = pixels[off:off + sh * sw * ch].view(sh, sw, ch).to(f32).expand(sh, sw, 3)

        def axis(n_out: int, n_src: int):
            ratio = torch.tensor(n_src, dtype=f32) / torch.tensor(n_out, dtype=f32)
            s = ((torch.arange(n_out, dtype=f32) + 0.5) * ratio - 0.5).clamp(0, n_src - 1)
            i0 = s.long()
            return i0, (i0 + 1).clamp(max=n_src - 1), s - i0.to(f32)

        y0, y1, ly = (t.to(canvas.device) for t in axis(oh, sh))
        x0, x1, lx = (t.to(canvas.device) for t in axis(ow, sw))
        ly, lx = ly[:, None, None], lx[None, :, None]
        w00, w01 = (1 - ly) * (1 - lx), (1 - ly) * lx
        w10, w11 = ly * (1 - lx), ly * lx
        r0, r1 = src[y0], src[y1]
        out[:oh, :ow] = (w00 * r0[:, x0] + w01 * r0[:, x1] + w10 * r1[:, x0]
                         + w11 * r1[:, x1])
    return canvas


class ResizeIntoCanvasKernel(KernelEntry):
    """The hand-written resize: one launch a batch (``launches`` counts
    them). A canvas on the CPU takes ``resize_into_canvas_plain``."""

    source = SOURCE
    libraries = LIBRARIES
    symbol = "cald_resize_into_canvas"
    argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()

    def __call__(self, pixels: torch.Tensor, meta: torch.Tensor,
                 canvas: torch.Tensor) -> torch.Tensor:
        """pixels: uint8 1-D; meta: (B, 6) int64 on the CPU; canvas: (B, H,
        W, 3) float32 on the pixels' device, every element written."""
        if canvas.dim() != 4 or canvas.shape[3] != 3 or canvas.dtype != torch.float32 \
                or not canvas.is_contiguous():
            raise ValueError("resize_into_canvas: canvas must be a contiguous (B, H, W, 3) "
                             "float32 tensor")
        b, ch, cw = canvas.shape[:3]
        if pixels.dtype != torch.uint8 or pixels.dim() != 1 or pixels.device != canvas.device:
            raise ValueError("resize_into_canvas: pixels must be a 1-D uint8 tensor on the "
                             "canvas's device")
        if meta.shape != (b, META_WORDS) or meta.dtype != torch.int64 or meta.is_cuda:
            raise ValueError(f"resize_into_canvas: meta must be a ({b}, {META_WORDS}) int64 "
                             "CPU tensor")
        m = meta.numpy()
        if ((m[:, 0] < 0).any() or (m[:, 0] + m[:, 1] * m[:, 2] * m[:, 3] > pixels.numel()).any()
                or not np.isin(m[:, 3], (1, 3)).all() or (m[:, 1:3] < 1).any()
                or (m[:, 4] < 1).any() or (m[:, 5] < 1).any()
                or (m[:, 4] > ch).any() or (m[:, 5] > cw).any()):
            raise ValueError(f"resize_into_canvas: meta out of range for {pixels.numel()} "
                             f"pixels and a {ch}x{cw} canvas:\n{m}")
        if canvas.device.type == "cpu":
            return resize_into_canvas_plain(pixels, meta, canvas)
        if canvas.device.type != "cuda":
            raise ValueError(f"resize_into_canvas: unsupported device {canvas.device}")
        meta_dev = meta.to(canvas.device)
        stream = torch.cuda.current_stream(canvas.device).cuda_stream
        self._launch(pixels.data_ptr(), meta_dev.data_ptr(), canvas.data_ptr(), b, ch, cw,
                     canvas.device.index, stream)
        return canvas

    def _launch(self, *args):
        with self._lock:          # loader threads launch at once: no count is lost
            super()._launch(*args)


resize_into_canvas = ResizeIntoCanvasKernel()

_local = threading.local()


def thread_stream(device: torch.device) -> torch.cuda.Stream:
    """The calling thread's own stream on ``device``."""
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    if device not in streams:
        streams[device] = torch.cuda.Stream(device=device)
    return streams[device]


def output_size(h: int, w: int, scale: float) -> tuple[int, int]:
    """The resized (h, w): nearbyint of size * scale in float32, as
    ``cald_decode_resize`` computes it (``native/dataloader.cc:145-148``)."""
    s = np.float32(scale)
    return int(np.rint(np.float32(h) * s)), int(np.rint(np.float32(w) * s))


def batch_meta(shapes: Sequence[tuple[int, int, int]], scales: Sequence[float],
               canvas_hw: tuple[int, int], paths: Sequence[str],
               align: int = 1) -> tuple[np.ndarray, int]:
    """The kernel's (B, 6) meta for images of ``shapes`` (h, w, channels)
    laid one after another, each at a multiple of ``align`` bytes, and their
    total bytes. Raises ``IOError`` for an image the canvas does not hold."""
    meta = np.zeros((len(shapes), META_WORDS), np.int64)
    off = 0
    for i, ((h, w, c), s) in enumerate(zip(shapes, scales)):
        rh, rw = output_size(h, w, s)
        if not (0 < rh <= canvas_hw[0] and 0 < rw <= canvas_hw[1]):
            raise IOError(f"{paths[i]}: {h}x{w} at scale {s} does not fit the "
                          f"{canvas_hw[0]}x{canvas_hw[1]} canvas")
        meta[i] = (off, h, w, c, rh, rw)
        off += -(-h * w * c // align) * align
    return meta, off


def decode_resize_batch_cuda(paths: Sequence[str], scales: Sequence[float],
                             canvas_hw: tuple[int, int], device: torch.device):
    """nvJPEG decode of every file, then one resize launch into a new (B, H,
    W, 3) float32 canvas on ``device``; returns (canvas, valid_hw (B, 2)
    int32). Raises ``JpegRejected`` for a file nvJPEG rejects and
    ``IOError`` for an image the canvas does not hold."""
    datas = [Path(p).read_bytes() for p in paths]
    infos = [nvjpeg.info(d, p) for d, p in zip(datas, paths)]
    meta, total = batch_meta([(h, w, c) for w, h, c in infos], scales, canvas_hw, paths,
                             align=256)
    stream = thread_stream(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        with span("loader.decode"):
            pixels = torch.empty(total, dtype=torch.uint8, device=device)
            for d, p, (w, _, c), o in zip(datas, paths, infos, meta[:, 0].tolist()):
                nvjpeg.decode(d, pixels[o:], w, c, p)
        with span("loader.resize"):
            canvas = torch.empty((len(paths), *canvas_hw, 3), dtype=torch.float32,
                                 device=device)
            resize_into_canvas(pixels, torch.from_numpy(meta), canvas)
            stream.synchronize()
    # the consumer reads the canvas on the device's default stream: its memory
    # goes back to this stream's pool only once that work is done
    canvas.record_stream(torch.cuda.default_stream(device))
    return canvas, meta[:, 4:6].astype(np.int32)


def decode_cuda(path: str, device: torch.device) -> np.ndarray:
    """nvJPEG decode of ``path`` to a host (H, W, 3) uint8 RGB array."""
    data = Path(path).read_bytes()
    w, h, c = nvjpeg.info(data, path)
    stream = thread_stream(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        buf = torch.empty(h * w * c, dtype=torch.uint8, device=device)
        nvjpeg.decode(data, buf, w, c, path)
        host = buf.cpu().numpy().reshape(h, w, c)     # a blocking copy on the stream
    return np.repeat(host, 3, axis=2) if c == 1 else host
