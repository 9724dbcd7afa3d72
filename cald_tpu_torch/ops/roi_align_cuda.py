"""Multi-scale RoIAlign through the hand-written Hopper kernels
(``csrc/roi_align.cu``), which replace three TPU kernels:

- ``roi_align_kernel`` (K1): the inference forward, output in the feature
  dtype; replaces ``cald_tpu/ops/flm_roi_align.py::_flm_kernel``.
- ``roi_align_train_fwd_kernel`` (K2): the training forward, float32 output;
  replaces ``cald_tpu/ops/pallas_roi_align.py::_roi_kernel``.
- ``roi_align_bwd_kernel`` (K3): the training backward into float32 level
  gradients; replaces ``cald_tpu/ops/pallas_roi_align.py::_roi_bwd_kernel``.
- ``roi_align_group_fwd_kernel`` (K4): the grouped training forward, g rois
  of one image per block in the separable form, float32 output; replaces
  ``cald_tpu/ops/pallas_roi_align.py::_roi_group_kernel``.

``window_roi_align`` is the TPU window kernels' forward: K4 under the group
gate (``CALD_TPU_ROI_GROUP``), else K2. ``RoIAlignFunction`` joins it and K3
for autograd (the detector applies it in
``models/roi_heads.py::pool_box_features``). Each wrapper chooses by the
device of the tensors it is given: for CPU tensors it runs the plain version
(``ops/roi_align.py``); for CUDA tensors it launches its kernel or raises. The kernels are compiled with
``nvcc`` for ``sm_90a`` at first launch (``ops/cuda_build.py``); importing
this module builds nothing. K1, K2 and K3 move 16 bytes of channels a lane
when C is a multiple of the vector width (8 bf16 or 4 f32 channels) and
every level and output is 16-byte aligned, else one channel a lane: the
kernel source picks the path from the shapes and pointers it is given.

The forwards' output equals the TPU kernels' (K1's pooled slots gathered back
by ``slot_of_roi``): (B, N, 7, 7, C) in proposal order, with zeros for invalid
rois.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from cald_tpu_torch.ops import roi_align as plain
from cald_tpu_torch.ops.cuda_build import CSRC, KernelEntry

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


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


def _check_sizes(output_size: int, sampling_ratio: int, max_sr: int):
    """The kernels' limits: one warp per output row (K1, K2), a bin's taps
    unrolled (K1, K2: sampling ratio up to 4), the taps' plan in shared
    memory (K3: up to 8)."""
    if not (1 <= output_size <= 8 and 1 <= sampling_ratio <= max_sr):
        raise ValueError(f"roi_align: the kernel takes output_size 1..8 and sampling_ratio "
                         f"1..{max_sr}, not {output_size} and {sampling_ratio}")


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


class _Entry(KernelEntry):
    """An entry point of ``csrc/roi_align.cu``."""

    source = CSRC / "roi_align.cu"

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
        _check_sizes(output_size, sampling_ratio, 4)
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
        _check_sizes(output_size, sampling_ratio, 4)
        return _forward(self, feats, rois, valid, levels, spatial_scales, output_size,
                        sampling_ratio, torch.float32)


class RoIAlignGroupForward(_Entry):
    """K4, the grouped training forward: float32 output, g rois per group."""

    symbol = "cald_roi_align_group_fwd"
    argtypes = [_P] * 4 + [_I] + [_P] * 4 + [_I] * 8 + [_P]

    def __call__(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                 valid: torch.Tensor, levels: torch.Tensor, *, g: int, hi_prec: bool,
                 spatial_scales: Sequence[float], output_size: int = 7,
                 sampling_ratio: int = 2) -> torch.Tensor:
        """As ``RoIAlignTrainForward``, with ``g`` rois of one image per group
        and ``hi_prec`` False for the "bf16" mode. Returns (B, N, S, S, C)
        float32."""
        if self._device(rois) == "cpu":
            return plain.grouped_multi_scale_roi_align(
                feats, rois, spatial_scales=spatial_scales, g=g, hi_prec=hi_prec,
                valid=valid, levels=levels, output_size=output_size,
                sampling_ratio=sampling_ratio)
        if not 1 <= g <= 64:
            raise ValueError(f"roi_align group: g must be in 1..64, not {g}")
        return _forward(self, feats, rois, valid, levels, spatial_scales, output_size,
                        sampling_ratio, torch.float32, g, int(hi_prec))


def _forward(entry: _Entry, feats, rois, valid, levels, spatial_scales, output_size,
             sampling_ratio, out_dtype, *extra):
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
                  _DTYPES[feats[0].dtype], *extra,
                  torch.cuda.current_stream(rois.device).cuda_stream)
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
        _check_sizes(output_size, sampling_ratio, 8)
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
roi_align_group_fwd_kernel = RoIAlignGroupForward()


def window_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor, valid: torch.Tensor,
                     levels: torch.Tensor, *, spatial_scales: Sequence[float],
                     output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """The forward of the TPU window kernels (the JAX package's
    ``pallas_roi_align._forward``), float32 output: K4 when
    ``CALD_TPU_ROI_GROUP`` is g > 1 and every image has at least 4g rois (the
    TPU kernel's two pipeline slots of g), else K2. Both gates are read at
    call time."""
    g = plain.roi_group()
    kw = dict(spatial_scales=spatial_scales, output_size=output_size,
              sampling_ratio=sampling_ratio)
    if g > 1 and rois.shape[1] >= 4 * g:
        return roi_align_group_fwd_kernel(feats, rois, valid, levels, g=g,
                                          hi_prec=plain.roi_group_hi_prec(), **kw)
    return roi_align_train_fwd_kernel(feats, rois, valid, levels, **kw)


class RoIAlignFunction(torch.autograd.Function):
    """Training RoIAlign, differentiable with respect to the levels:
    ``window_roi_align`` forward (K4 or K2) and K3 backward for CUDA
    tensors, the plain versions for CPU tensors. The backward is K3 whichever
    forward ran, as the TPU custom_vjp keeps its standard plan. The rois get
    no gradient (proposals are detached upstream, as the TPU kernel's
    custom_vjp gives them a zero cotangent)."""

    @staticmethod
    def forward(ctx, rois, valid, spatial_scales, output_size, sampling_ratio, *feats):
        levels = plain.roi_levels(rois, spatial_scales).contiguous()
        out = window_roi_align(feats, rois, valid, levels, spatial_scales=spatial_scales,
                               output_size=output_size, sampling_ratio=sampling_ratio)
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

