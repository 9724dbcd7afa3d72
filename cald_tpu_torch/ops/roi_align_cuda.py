"""Multi-scale RoIAlign through the hand-written Hopper kernel
(``csrc/roi_align.cu``), which replaces the TPU kernel
``cald_tpu/ops/flm_roi_align.py::_flm_kernel``.

``roi_align_kernel(feats, rois, valid, spatial_scales=...)`` chooses by the
device of the tensors it is given: for CPU tensors it runs the plain version
(``ops/roi_align.py``); for CUDA tensors it launches the kernel or raises. The
kernel is compiled with ``nvcc`` for ``sm_90a`` at first launch into
``cald_tpu_torch/build/`` (keyed by a hash of the source) and bound with
``ctypes``; importing this module builds nothing.

The kernel's output equals the TPU kernel's pooled slots gathered back by
``slot_of_roi``: (B, N, 7, 7, C) in proposal order, in the feature dtype, with
zeros for invalid rois.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

import torch

from cald_tpu_torch.ops import roi_align as plain

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "roi_align.cu"
BUILD_DIR = _PKG / "build"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def build_library() -> Path:
    """Compile the kernel source into a shared library for sm_90a unless a
    build of the same source exists. Returns the library's path."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libcald_roi_align_{digest}.so"
    if lib.exists():
        return lib
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                        "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, str(SOURCE)],
                       check=True)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


class RoIAlignKernel:
    """The wrapper: device dispatch, argument checks and the launch count.

    ``launches`` is incremented once per kernel launch and nowhere else, so a
    run can show that its main path went through the kernel.
    """

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._fn = None

    def load(self):
        """Build (if needed) and bind the kernel; returns the C entry point."""
        if self._fn is None:
            self._lib = ctypes.CDLL(str(build_library()))
            fn = self._lib.cald_roi_align_fwd
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                           + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p])
            self._fn = fn
        return self._fn

    def __call__(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                 valid: torch.Tensor, *, spatial_scales: Sequence[float],
                 output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
        """feats: list of (B, H_l, W_l, C) levels, finest first; rois (B, N, 4)
        f32; valid (B, N) bool. Returns (B, N, S, S, C) in the feature dtype."""
        levels = plain.roi_levels(rois, spatial_scales)
        if rois.device.type == "cpu":
            return plain.multi_scale_roi_align(
                feats, rois, spatial_scales=spatial_scales, valid=valid, levels=levels,
                output_size=output_size, sampling_ratio=sampling_ratio)
        if rois.device.type != "cuda":
            raise ValueError(f"roi_align: unsupported device {rois.device}")
        self._check(feats, rois, valid, spatial_scales)
        b, n = rois.shape[:2]
        c = feats[0].shape[-1]
        out = torch.empty((b, n, output_size, output_size, c), dtype=feats[0].dtype,
                          device=rois.device)
        nl = len(feats)
        ptrs = (ctypes.c_void_p * nl)(*[f.data_ptr() for f in feats])
        hs = (ctypes.c_int * nl)(*[f.shape[1] for f in feats])
        ws = (ctypes.c_int * nl)(*[f.shape[2] for f in feats])
        scales = (ctypes.c_float * nl)(*[float(s) for s in spatial_scales])
        levels = levels.contiguous()
        err = self.load()(
            ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(hs, ctypes.c_void_p),
            ctypes.cast(ws, ctypes.c_void_p), ctypes.cast(scales, ctypes.c_void_p), nl,
            rois.data_ptr(), valid.data_ptr(), levels.data_ptr(), out.data_ptr(),
            b, n, c, output_size, sampling_ratio, _DTYPES[feats[0].dtype],
            torch.cuda.current_stream(rois.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"roi_align kernel launch failed: CUDA error {err}")
        self.launches += 1
        return out

    @staticmethod
    def _check(feats, rois, valid, spatial_scales):
        if not 1 <= len(feats) <= 8 or len(spatial_scales) != len(feats):
            raise ValueError("roi_align: need 1..8 levels with one scale each")
        b, n = rois.shape[:2]
        c = feats[0].shape[-1]
        dt = feats[0].dtype
        if dt not in _DTYPES:
            raise TypeError(f"roi_align: features must be float32 or bfloat16, not {dt}")
        for f in feats:
            if (f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c or f.dtype != dt
                    or f.device != rois.device or not f.is_contiguous()):
                raise ValueError("roi_align: levels must be contiguous (B, H, W, C) "
                                 "tensors of one dtype on the rois' device")
        if rois.shape != (b, n, 4) or rois.dtype != torch.float32 or not rois.is_contiguous():
            raise ValueError("roi_align: rois must be a contiguous (B, N, 4) float32 tensor")
        if (valid.shape != (b, n) or valid.dtype != torch.bool or not valid.is_contiguous()
                or valid.device != rois.device):
            raise ValueError("roi_align: valid must be a contiguous (B, N) bool tensor")


roi_align_kernel = RoIAlignKernel()
