"""Multi-scale RoIAlign through the hand-written Hopper kernels
(``csrc/roi_align.cu``), which replace three TPU kernels:

- ``roi_align_kernel`` (K1): the inference forward, output in the feature
  dtype; replaces ``cald_tpu/ops/flm_roi_align.py::_flm_kernel``.
- ``roi_align_train_fwd_kernel`` (K2): the training forward, float32 output;
  replaces ``cald_tpu/ops/pallas_roi_align.py::_roi_kernel``.
- ``roi_align_bwd_kernel`` (K3): the training backward into float32 level
  gradients; replaces ``cald_tpu/ops/pallas_roi_align.py::_roi_bwd_kernel``.

``RoIAlignFunction`` joins K2 and K3 for autograd (the detector applies it
in ``models/roi_heads.py::pool_box_features``). Each wrapper chooses by the
device of the tensors it is given: for CPU tensors it runs the plain version
(``ops/roi_align.py``); for CUDA tensors it launches its kernel or raises. The kernels are compiled with
``nvcc`` for ``sm_90a`` at first launch into ``cald_tpu_torch/build/`` (keyed
by a hash of the source) and bound with ``ctypes``; importing this module
builds nothing.

The forwards' output equals the TPU kernels' (K1's pooled slots gathered back
by ``slot_of_roi``): (B, N, 7, 7, C) in proposal order, with zeros for invalid
rois.
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
_P, _I = ctypes.c_void_p, ctypes.c_int


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


def _host_levels(shapes: Sequence[tuple], spatial_scales: Sequence[float], ptrs):
    """The host arrays of a C entry point's level arguments."""
    nl = len(shapes)
    return ((_P * nl)(*ptrs), (_I * nl)(*[s[1] for s in shapes]),
            (_I * nl)(*[s[2] for s in shapes]),
            (ctypes.c_float * nl)(*[float(s) for s in spatial_scales]))


def _check_rois(rois, valid, levels, b: int):
    n = rois.shape[1] if rois.dim() == 3 else -1
    if rois.shape != (b, n, 4) or rois.dtype != torch.float32 or not rois.is_contiguous():
        raise ValueError("roi_align: rois must be a contiguous (B, N, 4) float32 tensor")
    for t, dt, name in ((valid, torch.bool, "valid"), (levels, torch.int32, "levels")):
        if (t.shape != (b, n) or t.dtype != dt or not t.is_contiguous()
                or t.device != rois.device):
            raise ValueError(f"roi_align: {name} must be a contiguous (B, N) {dt} tensor")


def _check_levels(feats, rois, spatial_scales, dtypes=_DTYPES):
    if not 1 <= len(feats) <= 8 or len(spatial_scales) != len(feats):
        raise ValueError("roi_align: need 1..8 levels with one scale each")
    b, c, dt = feats[0].shape[0], feats[0].shape[-1], feats[0].dtype
    if dt not in dtypes:
        raise TypeError(f"roi_align: levels must be {sorted(map(str, dtypes))}, not {dt}")
    for f in feats:
        if (f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c or f.dtype != dt
                or f.device != rois.device or not f.is_contiguous()):
            raise ValueError("roi_align: levels must be contiguous (B, H, W, C) "
                             "tensors of one dtype on the rois' device")


class _Entry:
    """One C entry point of the kernel library: binding and launch count.

    ``launches`` is incremented once per kernel launch and nowhere else, so a
    run can show that its main path went through the kernel.
    """

    symbol = ""
    argtypes: list = []

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._fn = None

    def load(self):
        """Build (if needed) and bind the kernel; returns the C entry point."""
        if self._fn is None:
            self._lib = ctypes.CDLL(str(build_library()))
            fn = getattr(self._lib, self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = self.argtypes
            self._fn = fn
        return self._fn

    def _launch(self, *args):
        err = self.load()(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: kernel launch failed: CUDA error {err}")
        self.launches += 1

    @staticmethod
    def _device(rois: torch.Tensor) -> str:
        if rois.device.type not in ("cpu", "cuda"):
            raise ValueError(f"roi_align: unsupported device {rois.device}")
        return rois.device.type


_FWD_ARGS = [_P] * 4 + [_I] + [_P] * 4 + [_I] * 6 + [_P]


class RoIAlignKernel(_Entry):
    """K1, the inference forward: output in the feature dtype."""

    symbol = "cald_roi_align_fwd"
    argtypes = _FWD_ARGS

    def __call__(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                 valid: torch.Tensor, *, spatial_scales: Sequence[float],
                 output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
        """feats: list of (B, H_l, W_l, C) levels, finest first; rois (B, N, 4)
        f32; valid (B, N) bool. Returns (B, N, S, S, C) in the feature dtype."""
        levels = plain.roi_levels(rois, spatial_scales)
        if self._device(rois) == "cpu":
            return plain.multi_scale_roi_align(
                feats, rois, spatial_scales=spatial_scales, valid=valid, levels=levels,
                output_size=output_size, sampling_ratio=sampling_ratio)
        return _forward(self, feats, rois, valid, levels.contiguous(), spatial_scales,
                        output_size, sampling_ratio, feats[0].dtype)


class RoIAlignTrainForward(_Entry):
    """K2, the training forward: float32 output whatever the feature dtype."""

    symbol = "cald_roi_align_train_fwd"
    argtypes = _FWD_ARGS

    def __call__(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                 valid: torch.Tensor, levels: torch.Tensor, *,
                 spatial_scales: Sequence[float], output_size: int = 7,
                 sampling_ratio: int = 2) -> torch.Tensor:
        """As ``RoIAlignKernel`` with the levels given ((B, N) int32).
        Returns (B, N, S, S, C) float32."""
        if self._device(rois) == "cpu":
            return plain.multi_scale_roi_align(
                feats, rois, spatial_scales=spatial_scales, valid=valid, levels=levels,
                output_size=output_size, sampling_ratio=sampling_ratio,
                out_dtype=torch.float32)
        return _forward(self, feats, rois, valid, levels, spatial_scales, output_size,
                        sampling_ratio, torch.float32)


def _forward(entry: _Entry, feats, rois, valid, levels, spatial_scales, output_size,
             sampling_ratio, out_dtype):
    _check_levels(feats, rois, spatial_scales)
    b, c = feats[0].shape[0], feats[0].shape[-1]
    _check_rois(rois, valid, levels, b)
    n = rois.shape[1]
    out = torch.empty((b, n, output_size, output_size, c), dtype=out_dtype, device=rois.device)
    ptrs, hs, ws, scales = _host_levels([f.shape for f in feats], spatial_scales,
                                        [f.data_ptr() for f in feats])
    entry._launch(ctypes.cast(ptrs, _P), ctypes.cast(hs, _P), ctypes.cast(ws, _P),
                  ctypes.cast(scales, _P), len(feats), rois.data_ptr(), valid.data_ptr(),
                  levels.data_ptr(), out.data_ptr(), b, n, c, output_size, sampling_ratio,
                  _DTYPES[feats[0].dtype], torch.cuda.current_stream(rois.device).cuda_stream)
    return out


class RoIAlignBackward(_Entry):
    """K3, the training backward: float32 gradients of the levels."""

    symbol = "cald_roi_align_bwd"
    argtypes = [_P] * 4 + [_I] + [_P] * 4 + [_I] * 5 + [_P]

    def __call__(self, grad_out: torch.Tensor, rois: torch.Tensor, valid: torch.Tensor,
                 levels: torch.Tensor, level_shapes: Sequence[tuple], *,
                 spatial_scales: Sequence[float], output_size: int = 7,
                 sampling_ratio: int = 2) -> list[torch.Tensor]:
        """grad_out (B, N, S, S, C) float32; level_shapes the (B, H_l, W_l, C)
        of each level. Returns one float32 (B, H_l, W_l, C) gradient per
        level."""
        if self._device(rois) == "cpu":
            return plain.multi_scale_roi_align_backward(
                grad_out, rois, valid, levels, level_shapes, spatial_scales=spatial_scales,
                output_size=output_size, sampling_ratio=sampling_ratio)
        grads = [torch.zeros(tuple(s), dtype=torch.float32, device=rois.device)
                 for s in level_shapes]
        _check_levels(grads, rois, spatial_scales, {torch.float32: 0})
        b, c = grads[0].shape[0], grads[0].shape[-1]
        _check_rois(rois, valid, levels, b)
        n = rois.shape[1]
        if (grad_out.shape != (b, n, output_size, output_size, c)
                or grad_out.dtype != torch.float32 or not grad_out.is_contiguous()
                or grad_out.device != rois.device):
            raise ValueError("roi_align backward: grad_out must be a contiguous "
                             "(B, N, S, S, C) float32 tensor on the rois' device")
        ptrs, hs, ws, scales = _host_levels(level_shapes, spatial_scales,
                                            [g.data_ptr() for g in grads])
        self._launch(ctypes.cast(ptrs, _P), ctypes.cast(hs, _P), ctypes.cast(ws, _P),
                     ctypes.cast(scales, _P), len(grads), rois.data_ptr(), valid.data_ptr(),
                     levels.data_ptr(), grad_out.data_ptr(), b, n, c, output_size,
                     sampling_ratio, torch.cuda.current_stream(rois.device).cuda_stream)
        return grads


roi_align_kernel = RoIAlignKernel()
roi_align_train_fwd_kernel = RoIAlignTrainForward()
roi_align_bwd_kernel = RoIAlignBackward()


class RoIAlignFunction(torch.autograd.Function):
    """Training RoIAlign, differentiable with respect to the levels: K2
    forward and K3 backward for CUDA tensors, the plain versions for CPU
    tensors. The rois get no gradient (proposals are detached upstream, as
    the TPU kernel's custom_vjp gives them a zero cotangent)."""

    @staticmethod
    def forward(ctx, rois, valid, spatial_scales, output_size, sampling_ratio, *feats):
        levels = plain.roi_levels(rois, spatial_scales).contiguous()
        out = roi_align_train_fwd_kernel(feats, rois, valid, levels,
                                         spatial_scales=spatial_scales,
                                         output_size=output_size,
                                         sampling_ratio=sampling_ratio)
        ctx.save_for_backward(rois, valid, levels)
        ctx.level_shapes = [tuple(f.shape) for f in feats]
        ctx.level_dtype = feats[0].dtype
        ctx.args = (tuple(spatial_scales), output_size, sampling_ratio)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        rois, valid, levels = ctx.saved_tensors
        spatial_scales, output_size, sampling_ratio = ctx.args
        grads = roi_align_bwd_kernel(grad_out.contiguous(), rois, valid, levels,
                                     ctx.level_shapes, spatial_scales=spatial_scales,
                                     output_size=output_size, sampling_ratio=sampling_ratio)
        # accumulated in float32, cast once to the levels' dtype
        return (None, None, None, None, None, *[g.to(ctx.level_dtype) for g in grads])

