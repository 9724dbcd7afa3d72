"""K8, the trunk's convolution epilogue (``csrc/conv_epilogue.cu``): one pass
over a convolution's output that adds the per-channel bias, optionally a
residual or the FPN's coarser level, and optionally applies ReLU,

    out = act(y + bias [+ r])

in float32, rounded once to y's dtype, written over y. It replaces no TPU
kernel (the JAX package leaves these passes to XLA, which fuses them into
the convolutions); with every frozen norm folded into its conv it takes the
place of the norm's multiply and add, the ReLUs, the residual add, the conv
bias add and the FPN's upsample and merge add on the trunk's inference route
(``models/layers.py::inference_route``).

``r`` is None, a tensor of y's shape, or a level at half y's resolution
(exactly half in both sizes), read at ``(h // 2, w // 2)``: for sizes
exactly double that is ``F.interpolate(r, size=(h, w), mode="nearest-exact")``.

``conv_epilogue`` is the plain version; ``conv_epilogue_kernel`` the
wrapper: for CPU tensors it runs the plain version, for CUDA tensors it
launches the kernel or raises. The kernel takes float32 or bfloat16
(B, C, H, W) tensors contiguous in ``torch.channels_last`` with C a
multiple of 8 and 16-byte aligned data, and a float32 (C,) bias.
"""

from __future__ import annotations

import ctypes

import torch

from cald_tpu_torch.ops.cuda_build import CSRC, KernelEntry
from cald_tpu_torch.utils.spans import count

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
# the kernel's vector index is 32-bit
_MAX_VECTORS = 2 ** 31 - 1


def _half_resolution(y: torch.Tensor, r: torch.Tensor) -> bool:
    return (r.shape[:2] == y.shape[:2] and 2 * r.shape[2] == y.shape[2]
            and 2 * r.shape[3] == y.shape[3])


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, r: torch.Tensor | None = None, *,
                  relu: bool = False) -> torch.Tensor:
    """The plain version: ``act(y + bias [+ r])`` in float32 with the
    additions in that order, rounded once to y's dtype; a new channels-last
    tensor."""
    out = y.float() + bias.float()[:, None, None]
    if r is not None:
        if r.shape != y.shape:
            if not _half_resolution(y, r):
                raise ValueError(f"conv_epilogue: r {tuple(r.shape)} is neither y's shape "
                                 f"{tuple(y.shape)} nor half its resolution")
            rows = torch.arange(y.shape[2], device=r.device) // 2
            cols = torch.arange(y.shape[3], device=r.device) // 2
            r = r.index_select(2, rows).index_select(3, cols)
        out = out + r.float()
    if relu:
        out = torch.relu(out)
    return out.to(y.dtype).contiguous(memory_format=torch.channels_last)


class ConvEpilogueKernel(KernelEntry):
    """K8: one launch a convolution of the trunk's inference route."""

    source = CSRC / "conv_epilogue.cu"
    symbol = "cald_conv_epilogue"
    argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]

    def __call__(self, y: torch.Tensor, bias: torch.Tensor, r: torch.Tensor | None = None, *,
                 relu: bool = False) -> torch.Tensor:
        """Writes ``act(y + bias [+ r])`` over y and returns y."""
        if y.device.type == "cpu" and all(
                t.device.type == "cpu" for t in (bias, r) if t is not None):
            return y.copy_(conv_epilogue(y, bias, r, relu=relu))
        mode = self._check(y, bias, r)
        b, c, h, w = y.shape
        self._launch(y.data_ptr(), bias.data_ptr(), 0 if r is None else r.data_ptr(), mode,
                     int(relu), _DTYPES[y.dtype], b, h, w, c,
                     torch.cuda.current_stream(y.device).cuda_stream)
        count("trunk.epilogue")
        return y

    def _check(self, y: torch.Tensor, bias: torch.Tensor, r: torch.Tensor | None) -> int:
        """The kernel's mode for r (0 none, 1 y's shape, 2 half resolution);
        raises on what the kernel does not take."""
        name = self.symbol
        if y.device.type != "cuda" or any(t.device != y.device for t in (bias, r)
                                          if t is not None):
            raise ValueError(f"{name}: y, bias and r must be on one CUDA device, not "
                             f"{[str(t.device) for t in (y, bias, r) if t is not None]}")
        if y.dtype not in _DTYPES:
            raise TypeError(f"{name}: y must be float32 or bfloat16, not {y.dtype}")
        if y.dim() != 4 or not y.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"{name}: y must be a (B, C, H, W) tensor contiguous in "
                             "torch.channels_last")
        b, c, h, w = y.shape
        if c % 8:
            raise ValueError(f"{name}: C must be a multiple of 8, not {c}")
        if b * h * w * c // (16 // y.element_size()) > _MAX_VECTORS:
            raise ValueError(f"{name}: y {tuple(y.shape)} is too large for one launch")
        if bias.dtype != torch.float32 or bias.shape != (c,) or not bias.is_contiguous():
            raise ValueError(f"{name}: bias must be a contiguous float32 ({c},) tensor")
        mode = 0
        if r is not None:
            if r.dtype != y.dtype or r.dim() != 4 or not r.is_contiguous(
                    memory_format=torch.channels_last):
                raise ValueError(f"{name}: r must be a {y.dtype} (B, C, H, W) tensor "
                                 "contiguous in torch.channels_last")
            if r.shape == y.shape:
                mode = 1
            elif _half_resolution(y, r):
                mode = 2
            else:
                raise ValueError(f"{name}: r {tuple(r.shape)} is neither y's shape "
                                 f"{tuple(y.shape)} nor half its resolution")
            if r.data_ptr() == y.data_ptr():
                raise ValueError(f"{name}: r may not be y")
        if any(t.data_ptr() % 16 for t in (y, bias, r) if t is not None):
            raise ValueError(f"{name}: y, bias and r must be 16-byte aligned")
        return mode


conv_epilogue_kernel = ConvEpilogueKernel()
