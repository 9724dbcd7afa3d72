"""Fused stride-1 bottlenecks through the hand-written Hopper kernels
(``csrc/bottleneck.cu``), which replace two TPU kernels:

- ``fused_block_kernel`` (K5): one folded block per launch; replaces
  ``cald_tpu/ops/pallas_bottleneck.py::_block_kernel``.
- ``fused_stage_kernel`` (K6): a stage's stride-1 suffix, one launch per
  group of chained blocks of ``ops.bottleneck.stage_plan``; replaces
  ``cald_tpu/ops/pallas_bottleneck.py::_stage_kernel``.

Each wrapper chooses by the device of the input: for a CPU tensor it runs
the plain version (``ops/bottleneck.py``); for a CUDA tensor it launches its
kernel or raises. The kernels take float32 or bfloat16 activations that are
contiguous in ``torch.channels_last`` and write a new channels-last tensor
(neighbouring tiles read the input's halo, so nothing is updated in place).
The folded weights are cast to the activation dtype, the biases kept
float32, and laid out (out, in) per product with the 3x3 taps first.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from cald_tpu_torch.ops import bottleneck as plain
from cald_tpu_torch.ops.cuda_build import CSRC, KernelEntry

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 8 + [_I] * 7


def _check_input(x: torch.Tensor, name: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.device.type == "cpu":
        return "cpu"
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: activations must be float32 or bfloat16, not {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: x must be a (B, C, H, W) tensor contiguous in "
                         "torch.channels_last")
    return "cuda"


def _kernel_weights(x: torch.Tensor, blocks: Sequence[plain.Block], name: str):
    """The blocks' weights stacked in the kernel's layout: w1 (g, P, C),
    w2 (g, 9, P, P), w3 (g, C, P) in x's dtype; b1, b2 (g, P), b3 (g, C)
    float32; all contiguous on x's device."""
    c = x.shape[1]
    p = blocks[0][0].shape[0]
    shapes = ((p, c), (p,), (p, p, 3, 3), (p,), (c, p), (c,))
    for block in blocks:
        if len(block) != 6 or any(tuple(t.shape) != s for t, s in zip(block, shapes)):
            raise ValueError(f"{name}: a folded block is (w1 (P, C), b1 (P,), w2 (P, P, 3, 3), "
                             f"b2 (P,), w3 (C, P), b3 (C,)) with C={c}")
        if any(t.device != x.device for t in block):
            raise ValueError(f"{name}: weights on {block[0].device}, input on {x.device}")
    stack = lambda i, f, dt: torch.stack([f(b[i]) for b in blocks]).to(dt).contiguous()
    return (stack(0, lambda w: w, x.dtype), stack(1, lambda b: b, torch.float32),
            stack(2, lambda w: w.permute(2, 3, 0, 1).reshape(9, p, p), x.dtype),
            stack(3, lambda b: b, torch.float32), stack(4, lambda w: w, x.dtype),
            stack(5, lambda b: b, torch.float32))


class _Entry(KernelEntry):
    """An entry point of ``csrc/bottleneck.cu``."""

    source = CSRC / "bottleneck.cu"

    def _run(self, x: torch.Tensor, blocks, th: int, tw: int, *extra) -> torch.Tensor:
        return self.launch_staged(x, _kernel_weights(x, blocks, self.symbol), th, tw, *extra)

    def launch_staged(self, x: torch.Tensor, weights, th: int, tw: int, *extra) -> torch.Tensor:
        """One launch on weights already in the kernel's layout
        (``_kernel_weights``); ``extra`` is K6's g."""
        b, c, h, w = x.shape
        out = torch.empty_like(x, memory_format=torch.channels_last)
        self._launch(x.data_ptr(), out.data_ptr(), *[t.data_ptr() for t in weights], b, h, w,
                     c, weights[0].shape[1], th, tw, *extra, _DTYPES[x.dtype],
                     torch.cuda.current_stream(x.device).cuda_stream)
        return out


class FusedBlockKernel(_Entry):
    """K5: one folded stride-1 bottleneck per launch."""

    symbol = "cald_bottleneck_block"
    argtypes = _ARGS + [_I, _P]

    def __call__(self, x: torch.Tensor, block: plain.Block) -> torch.Tensor:
        """x (B, C, H, W); block the folded tuple. Returns the block output,
        a new channels-last tensor in x's dtype."""
        if _check_input(x, self.symbol) == "cpu":
            return plain.fused_block(x, block)
        th, tw = plain.block_tile(x.shape[2], x.shape[3], x.shape[1], block[0].shape[0],
                                  x.element_size())
        return self._run(x, [block], th, tw)


class FusedStageKernel(_Entry):
    """K6: a stage's stride-1 suffix, one launch per group of its plan."""

    symbol = "cald_bottleneck_stage"
    argtypes = _ARGS + [_I, _I, _P]

    def __call__(self, x: torch.Tensor, blocks: Sequence[plain.Block]) -> torch.Tensor:
        """x (B, C, H, W); blocks the folded tuples of the suffix. Returns the
        suffix output, a new channels-last tensor in x's dtype."""
        if _check_input(x, self.symbol) == "cpu":
            return plain.fused_stage(x, blocks)
        if not blocks:
            return x
        i = 0
        for g, th, tw in plain.stage_plan(x.shape[2], x.shape[3], x.shape[1],
                                          blocks[0][0].shape[0], len(blocks),
                                          x.element_size()):
            x = self._run(x, blocks[i: i + g], th, tw, g)
            i += g
        return x


fused_block_kernel = FusedBlockKernel()
fused_stage_kernel = FusedStageKernel()
