"""The Hopper RoIAlign kernels (K1 inference forward, K2 training forward,
K3 training backward) against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with an H100 and ``nvcc`` run them with ``python -m pytest tests/test_torch_cuda.py``.
This file imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from cald_tpu_torch.ops import roi_align as plain
from cald_tpu_torch.ops.roi_align_cuda import (
    RoIAlignBackward, RoIAlignFunction, RoIAlignKernel, RoIAlignTrainForward,
)

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


@pytest.fixture(scope="module")
def train_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return RoIAlignTrainForward(), RoIAlignBackward()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [256, 96, 33])
def test_train_kernels_match_plain(train_kernels, c, dtype):
    """K2 (float32 output) and K3 (float32 level gradients) against the plain
    forward and backward on the f32 features. f32: atol 1e-4 (sums in
    another order; K3's atomics add in an order that changes from run to
    run). bf16 features: forward atol 5e-2, gradient atol 5e-2 + 1e-2
    relative (the gradient is f32 and rounded once to bf16)."""
    fwd, bwd = train_kernels
    feats, rois, valid = _inputs(c)
    levels = plain.roi_levels(rois, SCALES).contiguous()
    cot = torch.randn((*rois.shape[:2], 7, 7, c), generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda")
    want = plain.multi_scale_roi_align(feats, rois, spatial_scales=SCALES, valid=valid,
                                       out_dtype=torch.float32)
    want_g = plain.multi_scale_roi_align_backward(cot, rois, valid, levels,
                                                  [f.shape for f in feats],
                                                  spatial_scales=SCALES)
    kf = [f.to(dtype) for f in feats]
    got = fwd(kf, rois, valid, levels, spatial_scales=SCALES)
    got_g = bwd(cot, rois, valid, levels, [f.shape for f in kf], spatial_scales=SCALES)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and all(g.dtype == torch.float32 for g in got_g)
    assert got[~valid].abs().max().item() == 0.0
    if dtype == torch.float32:
        assert (got - want).abs().max().item() < 1e-4
        for g, w in zip(got_g, want_g):
            assert (g - w).abs().max().item() < 1e-4
    else:
        assert (got - want).abs().max().item() < 5e-2
        for g, w in zip(got_g, want_g):
            g = g.to(dtype).float()
            assert ((g - w).abs() <= 5e-2 + 1e-2 * w.abs()).all()


def test_train_kernels_invalid_rois_add_nothing(train_kernels):
    """A cotangent only on invalid rois leaves every gradient exactly 0."""
    _, bwd = train_kernels
    feats, rois, valid = _inputs(64)
    rois = torch.where(valid[..., None], rois, rois.new_tensor([8.0, 8.0, 90.0, 70.0]))
    levels = plain.roi_levels(rois, SCALES).contiguous()
    cot = torch.ones((*rois.shape[:2], 7, 7, 64), device="cuda")
    cot = cot * (~valid)[..., None, None, None]
    grads = bwd(cot, rois, valid, levels, [f.shape for f in feats], spatial_scales=SCALES)
    assert all(g.abs().max().item() == 0.0 for g in grads)


def test_train_launch_counts_and_bad_input(train_kernels):
    """One launch each per forward/backward through RoIAlignFunction; a CUDA
    input the kernels refuse raises and launches nothing."""
    fwd, bwd = train_kernels
    feats, rois, valid = _inputs(32)
    levels = plain.roi_levels(rois, SCALES).contiguous()
    from cald_tpu_torch.ops import roi_align_cuda

    before = (roi_align_cuda.roi_align_train_fwd_kernel.launches,
              roi_align_cuda.roi_align_bwd_kernel.launches)
    leaves = [f.clone().requires_grad_() for f in feats]
    out = RoIAlignFunction.apply(rois, valid, tuple(SCALES), 7, 2, *leaves)
    out.sum().backward()
    assert (roi_align_cuda.roi_align_train_fwd_kernel.launches,
            roi_align_cuda.roi_align_bwd_kernel.launches) == (before[0] + 1, before[1] + 1)
    assert all(f.grad is not None and f.grad.dtype == torch.float32 for f in leaves)

    n_fwd, n_bwd = fwd.launches, bwd.launches
    with pytest.raises(ValueError):
        fwd([f.permute(0, 2, 1, 3) for f in feats], rois, valid, levels, spatial_scales=SCALES)
    with pytest.raises(TypeError):
        fwd([f.half() for f in feats], rois, valid, levels, spatial_scales=SCALES)
    with pytest.raises(ValueError):
        fwd(feats, rois, valid, levels.long(), spatial_scales=SCALES)
    with pytest.raises(ValueError):
        bwd(torch.zeros((*rois.shape[:2], 7, 7, 32), device="cuda").bfloat16(), rois, valid,
            levels, [f.shape for f in feats], spatial_scales=SCALES)
    assert (fwd.launches, bwd.launches) == (n_fwd, n_bwd)
