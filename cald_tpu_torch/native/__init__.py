"""ctypes bindings for the native JPEG decoder (port of
``cald_tpu/native/__init__.py``).

``csrc/dataloader.cc`` (a byte-for-byte copy of the JAX package's
``native/dataloader.cc``) decodes a JPEG with libjpeg, resizes it
bilinearly and pastes it into a float32 canvas in one C++ pass. The ctypes
calls release the GIL, so the ``BatchLoader``'s thread pool decodes in
parallel.

Two routes, chosen by the device:

- **CPU** (``device`` None or a CPU device): the libjpeg library. Nothing
  is built at import or at first use: ``build()`` (or ``python -m
  cald_tpu_torch.native``) compiles the source with ``g++`` against libjpeg
  into ``cald_tpu_torch/build/``, keyed by the source's hash, and raises
  with the compiler's message when that fails. ``available()`` is True once
  the library exists; as in the JAX package, the loader's fused fast path
  and the native decode are on only then, and Pillow decodes otherwise.
- **CUDA**: nvJPEG and a hand-written resize kernel (``native/nvjpeg.py``,
  ``csrc/jpeg_decode.cu``), built with ``nvcc`` at first use. It serves
  ``image_size``, ``decode`` (to host uint8, for the training loader's host
  transform) and the batched ``decode_resize_batch``, and never falls back:
  a failed build or launch raises.

``rejected`` counts the files the CUDA route's ``decode`` rejected, each of
which the loader then hands to Pillow (as the JAX package hands it a file
libjpeg refuses), so that a run can show that none was.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from cald_tpu_torch.native import nvjpeg

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "dataloader.cc"
BUILD_DIR = _PKG / "build"

_lib = None
rejected = 0
_rejected_lock = threading.Lock()


def on_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def cuda_device(device) -> torch.device:
    """``device`` with its index (``cuda`` alone is the current device)."""
    device = torch.device(device)
    return device if device.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


@functools.cache
def library_path() -> Path:
    """Where ``build()`` puts the library of the current source."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libcald_data_{digest}.so"


def build(out: Path | None = None) -> Path:
    """Compile ``csrc/dataloader.cc`` into ``out`` (default
    ``library_path()``) unless it exists; written to a temporary file and
    renamed, so concurrent builds never see a partial library. Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    out = Path(out) if out is not None else library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-Wall",
                               str(SOURCE), "-o", tmp, "-ljpeg"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the JPEG decoder failed (g++ exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load():
    global _lib
    path = library_path()
    if _lib is None and path.exists():
        lib = ctypes.CDLL(str(path))
        lib.cald_image_size.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_int)]
        lib.cald_image_size.restype = ctypes.c_int
        lib.cald_decode_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.cald_decode_resize.restype = ctypes.c_int
        lib.cald_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                                    ctypes.c_int, ctypes.c_int]
        lib.cald_decode.restype = ctypes.c_int
        _lib = lib
    return _lib


def available() -> bool:
    """True once the library has been built."""
    return _load() is not None


def image_size(path: str, device=None) -> tuple[int, int]:
    """(width, height) from the JPEG header only (on a CUDA ``device``,
    nvJPEG's)."""
    if on_cuda(device):
        w, h, _ = nvjpeg.nvjpeg.info(Path(path).read_bytes(), path)
        return w, h
    lib = _load()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.cald_image_size(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"cald_image_size failed ({rc}) for {path}")
    return w.value, h.value


def decode_resize_into(path: str, canvas: np.ndarray, scale: float) -> tuple[int, int]:
    """Decode ``path``, resize by ``scale`` and paste into the top-left of
    the float32 (H, W, 3) C-contiguous ``canvas``. Returns the resized
    (h, w)."""
    lib = _load()
    if canvas.dtype != np.float32 or not canvas.flags.c_contiguous or canvas.ndim != 3 \
            or canvas.shape[2] != 3:
        raise ValueError("canvas must be a C-contiguous float32 (H, W, 3) array")
    ch, cw = canvas.shape[:2]
    oh = ctypes.c_int()
    ow = ctypes.c_int()
    rc = lib.cald_decode_resize(
        path.encode(), ch, cw, ctypes.c_float(scale),
        canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(oh), ctypes.byref(ow))
    if rc != 0:
        raise IOError(f"cald_decode_resize failed ({rc}) for {path}")
    return oh.value, ow.value


def decode(path: str, device=None) -> np.ndarray:
    """Full decode to (H, W, 3) uint8 RGB on the host. On a CUDA ``device``
    nvJPEG decodes on the card; a file it rejects is counted in
    ``rejected`` and raises ``IOError``."""
    if on_cuda(device):
        global rejected
        try:
            return nvjpeg.decode_cuda(path, cuda_device(device))
        except nvjpeg.JpegRejected:
            with _rejected_lock:
                rejected += 1
            raise
    lib = _load()
    w, h = image_size(path)
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.cald_decode(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         w, h)
    if rc != 0:
        raise IOError(f"cald_decode failed ({rc}) for {path}")
    return out


def decode_resize_batch(paths: Sequence[str], scales: Sequence[float],
                        canvas_hw: tuple[int, int], device) -> tuple[torch.Tensor, np.ndarray]:
    """The batched ``decode_resize_into``: every file decoded, resized by its
    scale and pasted into the top-left of its slot of a new zero-padded (B,
    H, W, 3) float32 canvas on ``device``. Returns (canvas, valid_hw (B, 2)
    int32), the resized sizes being ``cald_decode_resize``'s.

    On a CUDA device nvJPEG decodes and one kernel launch resizes the batch,
    synchronised before the return. On the CPU the libjpeg route decodes
    (``build()`` first) and the kernel's plain version resizes: the tests'
    route, equal to ``decode_resize_into`` bit for bit. Raises ``IOError``
    for a file the route rejects or an image the canvas does not hold."""
    if on_cuda(device):
        return nvjpeg.decode_resize_batch_cuda(paths, scales, canvas_hw, cuda_device(device))
    if not available():
        raise RuntimeError("the CPU route decodes with the libjpeg library: build() it first")
    images = [decode(p) for p in paths]
    meta, _ = nvjpeg.batch_meta([im.shape for im in images], scales, canvas_hw, paths)
    pixels = torch.from_numpy(np.concatenate([im.reshape(-1) for im in images]))
    canvas = torch.empty((len(paths), *canvas_hw, 3), dtype=torch.float32, device=device)
    nvjpeg.resize_into_canvas(pixels, torch.from_numpy(meta), canvas)
    return canvas, meta[:, 4:6].astype(np.int32)
