"""Fused stride-1 ResNet bottlenecks with frozen norms folded into the convs:
the plain versions (port of ``cald_tpu/ops/pallas_bottleneck.py``) and the
tile plan of the Hopper kernels (``ops/bottleneck_cuda.py``).

A folded block is the tuple ``(w1 (P, C), b1 (P,), w2 (P, P, 3, 3), b2 (P,),
w3 (C, P), b3 (C,))`` in PyTorch's (out, in) layouts, float32: each
``FrozenBatchNorm`` folded into the conv before it (``fold_frozen``). The
block computes ``relu(conv1x1(z, w3) + b3 + x)`` with ``z = relu(conv3x3(y1,
w2) + b2)`` and ``y1 = relu(conv1x1(x, w1) + b1)``; pixels outside the image
contribute 0 to the 3x3 taps (zero "SAME" padding of ``y1``, not
``relu(b1)``).

The plain versions round where the TPU kernel rounds: the folded weights are
cast to the activation dtype (biases stay float32), every product is
accumulated in float32, ``y1`` and ``z`` are rounded to the activation dtype,
and the block output once. Tensors are NCHW in ``torch.channels_last``, as
the backbone holds them. The convolutions run on float32 copies of the
rounded operands, so a float32 input is plain float32 (with TF32 off on a
card).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

Block = tuple  # (w1, b1, w2, b2, w3, b3)

# the dynamic shared memory one thread block may use on an H100, and what
# each of two blocks on one SM may use (228 KB per SM, 1 KB reserved a block)
SMEM_BYTES = 232448
SMEM_BYTES_TWO_PER_SM = 233472 // 2 - 1024
# row padding of every shared-memory buffer of the kernels, in elements
SMEM_PAD = 8
# the bf16 kernel's ring of weight (and block-0 input) k-slabs: stages x rows
# x (k + pad) elements (csrc/bottleneck.cu: kStages, kRingRows, kBK)
RING_STAGES, RING_ROWS, RING_K = 2, 192, 64
RING_BYTES = RING_STAGES * RING_ROWS * (RING_K + SMEM_PAD) * 2
TILE_SIDES = (1, 2, 4, 8, 16, 32)
# K5's fastest bf16 tiles at R50's four stride-1 suffixes on the 640x1024
# canvas, B=8, on the H100 (bottleneck_turns.py --sweep, PERF.md): (C, P) ->
# (th, tw). Layer4's 8x8 runs 96 thread blocks, fewer than the SMs, and
# still wins: each block streams all 8.9 MB of the weights from L2.
MEASURED_TILES = {(256, 64): (8, 16), (512, 128): (8, 8), (1024, 256): (8, 4),
                  (2048, 512): (8, 8)}


def fold_frozen(weight: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor):
    """Fold a per-out-channel frozen norm (``y = conv(x) * scale + shift``)
    into a conv weight with out-channels first; returns (weight, bias)."""
    return weight * scale.reshape((-1,) + (1,) * (weight.dim() - 1)), shift


def fused_block(x: torch.Tensor, block: Block) -> torch.Tensor:
    """One folded stride-1 bottleneck on x (B, C, H, W); returns a new
    channels-last tensor in x's dtype."""
    w1, b1, w2, b2, w3, b3 = block
    dt = x.dtype
    rounded = lambda w: w.to(dt).float()
    y1 = F.relu(F.conv2d(x.float(), rounded(w1)[:, :, None, None], b1.float()))
    z = F.relu(F.conv2d(y1.to(dt).float(), rounded(w2), b2.float(), padding=1))
    o = F.conv2d(z.to(dt).float(), rounded(w3)[:, :, None, None], b3.float()) + x.float()
    return F.relu(o).to(dt).contiguous(memory_format=torch.channels_last)


def fused_stage(x: torch.Tensor, blocks: Sequence[Block]) -> torch.Tensor:
    """The chain of folded blocks (a stage's stride-1 suffix); every
    inter-block activation is rounded to x's dtype."""
    for block in blocks:
        x = fused_block(x, block)
    return x


# --------------------------- the kernels' tile plan ---------------------------
#
# One thread block of the kernels computes g chained blocks on a th x tw
# output tile read with a g-pixel halo. Its shared memory holds, each row
# padded by SMEM_PAD elements and each buffer rounded up to 16 bytes: y1 over
# the haloed tile, z over the tile plus (g - 1) pixels, for g > 1 the
# inter-block activation over the same area (C channels), and in bf16 the
# ring of k-slabs.


def smem_bytes(th: int, tw: int, g: int, c: int, p: int, itemsize: int) -> int:
    """Dynamic shared memory of one thread block (csrc/bottleneck.cu)."""
    sec = lambda n: -(-n * itemsize // 16) * 16
    inner = (th + 2 * g - 2) * (tw + 2 * g - 2)
    x = sec(inner * (c + SMEM_PAD)) if g > 1 else 0
    ring = RING_BYTES if itemsize == 2 else 0
    return (x + sec((th + 2 * g) * (tw + 2 * g) * (p + SMEM_PAD)) + sec(inner * (p + SMEM_PAD))
            + ring)


def pick_tile(h: int, w: int, c: int, p: int, g: int, itemsize: int,
              budget: int = SMEM_BYTES):
    """The (th, tw, efficiency) whose shared memory fits ``budget`` with the
    highest efficiency: output pixels of the image over the haloed pixels
    that all tiles compute (ragged tiles count whole). None if nothing fits."""
    best = None
    for th in TILE_SIDES:
        for tw in TILE_SIDES:
            if th >= 2 * h or tw >= 2 * w:      # no tile wider than the image needs
                continue
            if smem_bytes(th, tw, g, c, p, itemsize) > budget:
                continue
            tiles = math.ceil(h / th) * math.ceil(w / tw)
            eff = h * w / (tiles * (th + 2 * g) * (tw + 2 * g))
            if best is None or eff > best[2]:
                best = (th, tw, eff)
    return best


def block_tile(h: int, w: int, c: int, p: int, itemsize: int) -> tuple[int, int]:
    """(th, tw) of one block per launch (K5, and a K6 group of 1). In bf16 at
    R50's widths, the measured tile (MEASURED_TILES) where it is no larger
    than the image needs; else the best tile that lets two thread blocks
    share an SM (25-30% faster than larger tiles at R50's suffixes in the
    pointer-row kernel, PERF.md), else the best that fits. Raises if no tile
    fits."""
    t = MEASURED_TILES.get((c, p)) if itemsize == 2 else None
    if t is not None and t[0] < 2 * h and t[1] < 2 * w:
        return t
    t = (pick_tile(h, w, c, p, 1, itemsize, SMEM_BYTES_TWO_PER_SM)
         or pick_tile(h, w, c, p, 1, itemsize))
    if t is None:
        raise ValueError(f"bottleneck: no tile fits {SMEM_BYTES} bytes at C={c} P={p}")
    return t[0], t[1]


def stage_plan(h: int, w: int, c: int, p: int, n_blocks: int,
               itemsize: int) -> list[tuple[int, int, int]]:
    """The stage kernel's (K6) groups for a suffix of ``n_blocks``: a list of
    (g, th, tw) whose g sum to ``n_blocks``. As the TPU plan
    (``maybe_fused_stage_deep``): the largest g whose best tile fits
    SMEM_BYTES with interior/haloed area >= 0.5, else g = 1; a tail group
    gets its own tile, and a group of 1 K5's tile (``block_tile``). Raises if
    not even g = 1 fits."""
    if n_blocks < 1:
        return []

    def group(g: int):
        if g == 1:
            return (1, *block_tile(h, w, c, p, itemsize))
        t = pick_tile(h, w, c, p, g, itemsize)
        return None if t is None or t[2] < 0.5 else (g, t[0], t[1])

    pick = next(t for g in range(n_blocks, 0, -1) if (t := group(g)) is not None)
    g = pick[0]
    plan = [pick] * (n_blocks // g)
    tail = n_blocks % g
    if tail == 1:
        plan.append(group(1))
    elif tail:      # a shallower group always fits where a deeper one did
        t = pick_tile(h, w, c, p, tail, itemsize)
        plan.append((tail, t[0], t[1]))
    return plan
