"""The Hopper RoIAlign kernel against its plain PyTorch version, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with an H100 and ``nvcc`` run them with ``python -m pytest tests/test_torch_cuda.py``.
This file imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from cald_tpu_torch.ops import roi_align as plain
from cald_tpu_torch.ops.roi_align_cuda import RoIAlignKernel

pytestmark = pytest.mark.cuda

SHAPES = ((40, 64), (20, 32), (10, 16), (5, 8))
SCALES = [0.25, 0.125, 0.0625, 0.03125]


@pytest.fixture(scope="module")
def kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return RoIAlignKernel()


def _inputs(c: int, n: int = 64, b: int = 2, seed: int = 0):
    rng = np.random.default_rng(seed)
    feats = [torch.from_numpy(rng.normal(0, 1, (b, h, w, c)).astype(np.float32)).cuda()
             for h, w in SHAPES]
    cx = rng.uniform(0, 256, (b, n))
    cy = rng.uniform(0, 160, (b, n))
    sz = rng.uniform(4, 200, (b, n))
    ar = rng.uniform(0.25, 4.0, (b, n))
    w, h = sz * np.sqrt(ar), sz / np.sqrt(ar)
    rois = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)
    rois[0, :4] = [[-20, -10, 60, 50], [240, 150, 300, 200], [100, 100, 100.5, 100.5],
                   [0, 0, 256, 160]]
    valid = rng.uniform(size=(b, n)) > 0.3
    rois[~valid] = 0.0
    return feats, torch.from_numpy(rois).cuda(), torch.from_numpy(valid).cuda()


@pytest.mark.parametrize("c", [256, 96, 33])
def test_kernel_matches_plain_f32(kernel, c):
    """Any channel count, including ones that are not a multiple of 32."""
    feats, rois, valid = _inputs(c)
    got = kernel(feats, rois, valid, spatial_scales=SCALES)
    torch.cuda.synchronize()
    want = plain.multi_scale_roi_align(feats, rois, spatial_scales=SCALES, valid=valid)
    v = valid.cpu().numpy()
    err = (got - want).abs().cpu().numpy()
    # atol 1e-4: f32 sums of 16 weighted corners, in another order
    assert err[v].max() < 1e-4
    assert got[~valid].abs().max().item() == 0.0


def test_kernel_matches_plain_bf16(kernel):
    feats, rois, valid = _inputs(256)
    got = kernel([f.bfloat16() for f in feats], rois, valid, spatial_scales=SCALES)
    want = plain.multi_scale_roi_align(feats, rois, spatial_scales=SCALES, valid=valid)
    assert got.dtype == torch.bfloat16
    # bf16 features and output against the f32 plain version
    assert (got.float() - want).abs().max().item() < 5e-2


def test_launch_count_and_bad_input(kernel):
    feats, rois, valid = _inputs(64)
    before = kernel.launches
    kernel(feats, rois, valid, spatial_scales=SCALES)
    assert kernel.launches == before + 1
    with pytest.raises(ValueError):
        kernel([f.permute(0, 2, 1, 3) for f in feats], rois, valid, spatial_scales=SCALES)
    with pytest.raises(TypeError):
        kernel([f.half() for f in feats], rois, valid, spatial_scales=SCALES)
    assert kernel.launches == before + 1
