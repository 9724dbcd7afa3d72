"""The Hopper kernels against their plain PyTorch versions, on the card:
RoIAlign (K1 inference forward, K2 training forward, K3 training backward,
K4 grouped training forward) and the fused bottlenecks (K5 one block, K6 a
stage's stride-1 suffix); then the PyTorch-op modules of ``--norm group``
and the photometric augs on the card against the CPU on the same inputs.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with an H100 and ``nvcc`` run them with ``python -m pytest tests/test_torch_cuda.py``.
This file imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from cald_tpu_torch.ops import roi_align as plain
from cald_tpu_torch.ops import roi_align_cuda
from cald_tpu_torch.ops.roi_align_cuda import (
    RoIAlignBackward, RoIAlignFunction, RoIAlignGroupForward, RoIAlignKernel,
    RoIAlignTrainForward,
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


@pytest.mark.parametrize("c", [256, 96, 33])
def test_kernel_matches_plain_bf16(kernel, c):
    """C=256 and 96 take the 16-byte vector path (96: a partial warp), 33
    the scalar path."""
    feats, rois, valid = _inputs(c)
    got = kernel([f.bfloat16() for f in feats], rois, valid, spatial_scales=SCALES)
    want = plain.multi_scale_roi_align(feats, rois, spatial_scales=SCALES, valid=valid)
    assert got.dtype == torch.bfloat16
    # bf16 features and output against the f32 plain version
    assert (got.float() - want).abs().max().item() < 5e-2
    assert got[~valid].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_all_rois_invalid(kernel, dtype):
    """Every roi invalid: the kernel writes zeros everywhere (the output
    starts as uninitialised memory) and reads no level."""
    feats, rois, valid = _inputs(256)
    got = kernel([f.to(dtype) for f in feats], rois, torch.zeros_like(valid),
                 spatial_scales=SCALES)
    torch.cuda.synchronize()
    assert got.abs().max().item() == 0.0


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


ODD_SHAPES = ((39, 63), (20, 31), (10, 15), (5, 7))


@pytest.mark.parametrize("case", ["offset", "odd_c36", "odd_c34"])
def test_unaligned_levels_match_plain(kernel, case):
    """Levels the 16-byte path cannot take: a level that starts off a
    16-byte boundary (C=256), and odd level sizes with C=36 or 34, so that
    an image's level starts off a 16-byte boundary in bf16. K1 (f32 and bf16)
    and K3 (C=36 in f32 takes the vector path, C=34 or an unaligned gradient
    the scalar one) against their plain versions at today's tolerances."""
    c = {"offset": 256, "odd_c36": 36, "odd_c34": 34}[case]
    rng = np.random.default_rng(5)
    shapes = SHAPES if case == "offset" else ODD_SHAPES
    feats, rois, valid = _inputs(c)
    feats = [torch.from_numpy(rng.normal(0, 1, (2, h, w, c)).astype(np.float32)).cuda()
             for h, w in shapes]
    want = plain.multi_scale_roi_align(feats, rois, spatial_scales=SCALES, valid=valid)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        kf = [f.to(dtype) for f in feats]
        if case == "offset":
            kf[1] = _misaligned(kf[1])
        got = kernel(kf, rois, valid, spatial_scales=SCALES)
        torch.cuda.synchronize()
        assert (got.float() - want).abs().max().item() < tol
    levels = plain.roi_levels(rois, SCALES).contiguous()
    cot = torch.randn((*rois.shape[:2], 7, 7, c), generator=torch.Generator(
        device="cuda").manual_seed(3), device="cuda")
    want_g = plain.multi_scale_roi_align_backward(cot, rois, valid, levels,
                                                  [f.shape for f in feats],
                                                  spatial_scales=SCALES)
    got_g = roi_align_cuda.roi_align_bwd_kernel(
        _misaligned(cot) if case == "offset" else cot, rois, valid, levels,
        [f.shape for f in feats], spatial_scales=SCALES)
    torch.cuda.synchronize()
    for g, w in zip(got_g, want_g):
        assert (g - w).abs().max().item() < 1e-4


def test_launch_count_and_bad_input(kernel):
    feats, rois, valid = _inputs(64)
    before = kernel.launches
    kernel(feats, rois, valid, spatial_scales=SCALES)
    assert kernel.launches == before + 1
    with pytest.raises(ValueError):
        kernel([f.permute(0, 2, 1, 3) for f in feats], rois, valid, spatial_scales=SCALES)
    with pytest.raises(TypeError):
        kernel([f.half() for f in feats], rois, valid, spatial_scales=SCALES)
    with pytest.raises(ValueError):
        kernel(feats, rois, valid, spatial_scales=SCALES, sampling_ratio=5)
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


@pytest.fixture(scope="module")
def group_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return RoIAlignGroupForward()


@pytest.mark.parametrize("hi", [True, False], ids=["hi", "bf16"])
@pytest.mark.parametrize("g", [1, 2, 5, 8])
@pytest.mark.parametrize("c", [256, 33])
def test_group_kernel_matches_plain(group_kernel, c, g, hi):
    """K4 against its plain version in the same mode, on f32 features and on
    the same bf16 features (atol 1e-4 "hi"; 5e-2 "bf16", where a t on a
    rounding boundary may round the other way), bf16 features against the
    plain f32 version (atol 5e-2); 64 rois per image, so g = 5 leaves a
    short last group; invalid rois are exactly 0; g changes no bit of the
    result."""
    feats, rois, valid = _inputs(c)
    feats_bf = [f.bfloat16() for f in feats]
    levels = plain.roi_levels(rois, SCALES).contiguous()
    args = dict(spatial_scales=SCALES, valid=valid, levels=levels)
    want = plain.grouped_multi_scale_roi_align(feats, rois, g=g, hi_prec=hi, **args)
    want_bf = plain.grouped_multi_scale_roi_align(feats_bf, rois, g=g, hi_prec=hi, **args)
    want_f32 = plain.grouped_multi_scale_roi_align(feats, rois, g=g, **args)
    got = group_kernel(feats, rois, valid, levels, g=g, hi_prec=hi, spatial_scales=SCALES)
    got_bf = group_kernel(feats_bf, rois, valid, levels, g=g, hi_prec=hi, spatial_scales=SCALES)
    got_g1 = group_kernel(feats_bf, rois, valid, levels, g=1, hi_prec=hi, spatial_scales=SCALES)
    torch.cuda.synchronize()
    assert got.dtype == got_bf.dtype == torch.float32
    tol = 1e-4 if hi else 5e-2
    assert (got - want).abs().max().item() < tol
    assert (got_bf - want_bf).abs().max().item() < tol
    assert (got_bf - want_f32).abs().max().item() < 5e-2
    assert torch.equal(got_bf, got_g1)
    assert got[~valid].abs().max().item() == 0.0 and got_bf[~valid].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["c256", "c33", "offset"])
def test_group_hi_equals_k2(group_kernel, case, dtype):
    """K4 in "hi" is K2's instantiation: bit for bit K2's output on the same
    inputs, on the vector path (C=256), the scalar path (C=33) and with a
    level one element off a 16-byte boundary (the scalar path at C=256)."""
    feats, rois, valid = _inputs(33 if case == "c33" else 256)
    feats = [f.to(dtype) for f in feats]
    if case == "offset":
        feats[1] = _misaligned(feats[1])
    levels = plain.roi_levels(rois, SCALES).contiguous()
    k2 = roi_align_cuda.roi_align_train_fwd_kernel
    want = k2(feats, rois, valid, levels, spatial_scales=SCALES)
    got = group_kernel(feats, rois, valid, levels, g=8, hi_prec=True, spatial_scales=SCALES)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got[~valid].abs().max().item() == 0.0


def test_group_launch_count_and_bad_input(group_kernel):
    feats, rois, valid = _inputs(64)
    levels = plain.roi_levels(rois, SCALES).contiguous()
    before = group_kernel.launches
    group_kernel(feats, rois, valid, levels, g=4, hi_prec=True, spatial_scales=SCALES)
    assert group_kernel.launches == before + 1
    with pytest.raises(ValueError):
        group_kernel(feats, rois, valid, levels, g=0, hi_prec=True, spatial_scales=SCALES)
    with pytest.raises(ValueError):
        group_kernel(feats, rois, valid, levels.long(), g=4, hi_prec=True,
                     spatial_scales=SCALES)
    with pytest.raises(TypeError):
        group_kernel([f.half() for f in feats], rois, valid, levels, g=4, hi_prec=True,
                     spatial_scales=SCALES)
    # K2's limits: output size 1..8, sampling ratio 1..4
    for size in (dict(output_size=9), dict(sampling_ratio=5)):
        for hi in (True, False):
            with pytest.raises(ValueError):
                group_kernel(feats, rois, valid, levels, g=4, hi_prec=hi, spatial_scales=SCALES,
                             **size)
    assert group_kernel.launches == before + 1


def test_function_routes_to_group_kernel(group_kernel, monkeypatch):
    """With CALD_TPU_ROI_GROUP=4 and 64 rois per image the training forward
    launches K4 (not K2) and the backward K3."""
    monkeypatch.setenv("CALD_TPU_ROI_GROUP", "4")
    feats, rois, valid = _inputs(64)
    feats = [f.requires_grad_() for f in feats]
    ks = (roi_align_cuda.roi_align_group_fwd_kernel, roi_align_cuda.roi_align_train_fwd_kernel,
          roi_align_cuda.roi_align_bwd_kernel)
    before = [k.launches for k in ks]
    out = RoIAlignFunction.apply(rois, valid, tuple(SCALES), 7, 2, *feats)
    out.sum().backward()
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(ks, before)] == [1, 0, 1]


@pytest.mark.parametrize("case", ["identical", "one_pixel"])
def test_backward_dense_overlap(train_kernels, case):
    """K3 where many rois add into the same pixels at once: 64 identical rois
    in one image; and rois whose footprint is one pixel at their level (every
    sample of every bin on the same 2x2 pixels), 64 of them on an 8x8 grid of
    spots 3 image pixels apart, so that neighbours share level pixels. f32
    atol 1e-4."""
    _, bwd = train_kernels
    feats, rois, valid = _inputs(256, n=64)
    rois = rois.clone()
    if case == "identical":
        rois[0] = rois.new_tensor([60.0, 40.0, 130.0, 110.0])
    else:
        i = torch.arange(64, device="cuda", dtype=torch.float32)
        x, y = 100.0 + 3.0 * (i % 8), 60.0 + 3.0 * (i // 8)
        rois[0] = torch.stack([x, y, x + 0.2, y + 0.3], -1)
    valid = valid.clone()
    valid[0] = True
    levels = plain.roi_levels(rois, SCALES).contiguous()
    cot = torch.randn((*rois.shape[:2], 7, 7, 256), generator=torch.Generator(
        device="cuda").manual_seed(4), device="cuda")
    shapes = [f.shape for f in feats]
    want = plain.multi_scale_roi_align_backward(cot, rois, valid, levels, shapes,
                                                spatial_scales=SCALES)
    got = bwd(cot, rois, valid, levels, shapes, spatial_scales=SCALES)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() < 1e-4


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


# --------------------- fused bottlenecks (K5 and K6) ---------------------


@pytest.fixture(scope="module")
def bneck():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cald_tpu_torch.ops.bottleneck_cuda import FusedBlockKernel, FusedStageKernel

    return FusedBlockKernel(), FusedStageKernel()


def _folded_blocks(c: int, p: int, n: int, b1=None, seed: int = 0, device="cuda"):
    """Seeded folded blocks in the port's layouts, scaled so activations stay
    of order 1 through a chain."""
    rng = np.random.default_rng(seed)
    mk = lambda std, *s: torch.from_numpy(rng.normal(0, std, s).astype(np.float32)).to(device)
    return [(mk(c ** -0.5, p, c),
             mk(0.1, p) if b1 is None else torch.full((p,), b1, device=device),
             mk((9 * p) ** -0.5, p, p, 3, 3), mk(0.1, p), mk(0.5 * p ** -0.5, c, p),
             mk(0.1, c)) for _ in range(n)]


def _activations(b: int, c: int, h: int, w: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(0, 1, (b, c, h, w))).astype(np.float32)
    return torch.from_numpy(x).cuda().contiguous(memory_format=torch.channels_last)


def _check(got: torch.Tensor, want: torch.Tensor, dtype):
    """f32: max abs error <= 1e-4 of the output's largest magnitude (sums of
    up to 9 P products in another order). bf16 against the f32 plain version:
    the bounds of tests/test_pallas_bottleneck.py, mean relative error < 0.03
    overall and on the border rows and columns."""
    assert got.dtype == dtype and got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    if dtype == torch.float32:
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()
        return
    scale = w.abs().mean().item() + 1e-6
    assert (g - w).abs().mean().item() / scale < 0.03
    edge = torch.cat([(g - w)[:, :, 0].flatten(), (g - w)[:, :, -1].flatten(),
                      (g - w)[:, :, :, 0].flatten(), (g - w)[:, :, :, -1].flatten()])
    assert edge.abs().mean().item() / scale < 0.03


# (B, H, W, C, P): narrow, odd widths (the unaligned path), ragged H and W,
# R50's layer3 and layer4 suffix inputs, and layer4 of the 96x128 canvas;
# R50's layer1 and layer2 widths at a small H x W; images smaller than one
# tile (1x1, 3x5); B = 17; C = 48 (a half k-slab on the bf16 path) with
# P = 16, and the ragged pair C = 48, P = 24 (the pointer-row path)
BLOCK_SHAPES = [(2, 13, 19, 64, 16), (2, 7, 9, 40, 12), (1, 40, 64, 1024, 256),
                (2, 20, 32, 2048, 512), (2, 3, 4, 2048, 512), (2, 11, 13, 256, 64),
                (2, 9, 11, 512, 128), (2, 1, 1, 256, 64), (1, 3, 5, 1024, 256),
                (17, 5, 7, 64, 16), (2, 9, 10, 48, 16), (2, 9, 10, 48, 24)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BLOCK_SHAPES)
def test_block_kernel_matches_plain(bneck, shape, dtype):
    from cald_tpu_torch.ops import bottleneck

    block_k, _ = bneck
    b, h, w, c, p = shape
    x = _activations(b, c, h, w)
    blk = _folded_blocks(c, p, 1)[0]
    want = bottleneck.fused_block(x, blk)
    got = block_k(x.to(dtype), blk)
    torch.cuda.synchronize()
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n", [((2, 24, 32, 64, 16), 7), ((1, 160, 256, 256, 64), 2),
                                     ((2, 11, 21, 40, 12), 3), ((1, 80, 128, 512, 128), 3),
                                     ((2, 9, 13, 1024, 256), 5), ((1, 5, 6, 2048, 512), 2),
                                     ((17, 6, 7, 256, 64), 3), ((1, 1, 1, 256, 64), 2)])
def test_stage_kernel_matches_plain(bneck, shape, n, dtype):
    """K6 through its plan against the plain chain."""
    from cald_tpu_torch.ops import bottleneck

    _, stage_k = bneck
    b, h, w, c, p = shape
    x = _activations(b, c, h, w)
    blocks = _folded_blocks(c, p, n)
    want = bottleneck.fused_stage(x, blocks)
    before = stage_k.launches
    got = stage_k(x.to(dtype), blocks)
    torch.cuda.synchronize()
    plan = bottleneck.stage_plan(h, w, c, p, n, x.to(dtype).element_size())
    assert stage_k.launches == before + len(plan)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,tile", [((2, 13, 19, 256, 64), (8, 8)),
                                        ((2, 13, 19, 256, 64), (4, 16)),
                                        ((1, 13, 19, 512, 128), (8, 16)),
                                        ((1, 9, 7, 1024, 256), (8, 8))])
def test_block_kernel_ragged_tiles(bneck, shape, tile, dtype):
    """K5 at R50 widths on tiles that cross the ragged right and bottom edges
    (and one larger than the image)."""
    from cald_tpu_torch.ops import bottleneck

    block_k, _ = bneck
    b, h, w, c, p = shape
    x = _activations(b, c, h, w)
    blk = _folded_blocks(c, p, 1)[0]
    want = bottleneck.fused_block(x, blk)
    got = block_k._run(x.to(dtype), [blk], *tile)
    torch.cuda.synchronize()
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,p", [(64, 16), (48, 24)])
def test_block_kernel_unaligned_input(bneck, c, p, dtype):
    """An input one element off a 16-byte boundary takes the pointer-row path
    (the launcher checks every pointer) and agrees all the same."""
    from cald_tpu_torch.ops import bottleneck

    block_k, _ = bneck
    x = _activations(2, c, 9, 13)
    blk = _folded_blocks(c, p, 1)[0]
    want = bottleneck.fused_block(x, blk)
    xd = x.to(dtype)
    buf = torch.empty(xd.numel() + 1, dtype=dtype, device=xd.device)
    nhwc = buf[1:].view(2, 9, 13, c)
    nhwc.copy_(xd.permute(0, 2, 3, 1))
    mis = nhwc.permute(0, 3, 1, 2)
    assert mis.is_contiguous(memory_format=torch.channels_last) and mis.data_ptr() % 16
    got = block_k(mis, blk)
    torch.cuda.synchronize()
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,th,tw", [(1, 4, 8), (2, 4, 8), (3, 4, 4), (4, 2, 8), (3, 8, 16)])
def test_stage_kernel_any_group_and_tile(bneck, g, th, tw, dtype):
    """One launch of g chained blocks on ragged tiles (13x19 is no multiple
    of any tile): every intermediate is masked by the image, not the tile."""
    from cald_tpu_torch.ops import bottleneck

    _, stage_k = bneck
    x = _activations(2, 64, 13, 19)
    blocks = _folded_blocks(64, 16, g, b1=0.5)
    want = bottleneck.fused_stage(x, blocks)
    got = stage_k._run(x.to(dtype), blocks, th, tw, g)
    torch.cuda.synchronize()
    _check(got, want, dtype)


@pytest.mark.parametrize("kind", ["block", "stage"])
def test_positive_b1_border(bneck, kind):
    """The halo-bias case with the bounds of tests/test_pallas_bottleneck.py:
    with b1 = 1.0 the pixels outside the image must give the 3x3 taps 0, not
    relu(b1): border mean < 0.02 and max < 0.15 of the mean magnitude."""
    from cald_tpu_torch.ops import bottleneck

    block_k, stage_k = bneck
    x = _activations(1, 256, 16, 32)
    blk = _folded_blocks(256, 64, 1, b1=1.0)[0]
    want = bottleneck.fused_block(x, blk)
    xb = x.bfloat16()
    got = (block_k(xb, blk) if kind == "block" else stage_k(xb, [blk])).float()
    torch.cuda.synchronize()
    scale = want.abs().mean().item() + 1e-6
    d = got - want
    border = torch.cat([d[:, :, 0].flatten(), d[:, :, -1].flatten(), d[:, :, :, 0].flatten(),
                        d[:, :, :, -1].flatten()]).abs()
    assert border.mean().item() / scale < 0.02
    assert border.max().item() / scale < 0.15


def test_bottleneck_launch_counts_and_bad_input(bneck):
    """One K5 launch per call, one K6 launch per group; an input the kernels
    refuse raises and launches nothing."""
    block_k, stage_k = bneck
    x = _activations(1, 64, 8, 8)
    blocks = _folded_blocks(64, 16, 3)
    n5, n6 = block_k.launches, stage_k.launches
    block_k(x, blocks[0])
    stage_k(x, blocks)
    from cald_tpu_torch.ops import bottleneck

    assert block_k.launches == n5 + 1
    assert stage_k.launches == n6 + len(bottleneck.stage_plan(8, 8, 64, 16, 3, 4))
    n5, n6 = block_k.launches, stage_k.launches
    with pytest.raises(TypeError):
        block_k(x.half(), blocks[0])
    with pytest.raises(ValueError):
        block_k(x.contiguous(), blocks[0])              # NCHW, not channels_last
    with pytest.raises(ValueError):
        stage_k(x.contiguous(), blocks)
    with pytest.raises(ValueError):
        block_k(x, tuple(t.cpu() for t in blocks[0]))   # CPU weights, CUDA input
    with pytest.raises(ValueError):
        stage_k(x, [tuple(t.cpu() for t in blk) for blk in blocks])
    with pytest.raises(ValueError):
        block_k(x, _folded_blocks(32, 8, 1)[0])         # weights of another width
    assert (block_k.launches, stage_k.launches) == (n5, n6)


# --------------------------------------------------------------------------
# GroupNorm and the photometric augs: PyTorch ops, card against CPU
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [64, 72, 256])
def test_group_norm_card_matches_cpu(card, width, dtype):
    """Forward (and, in f32, the input and parameter gradients) of
    GroupNorm on channels-last NCHW input: f32 atol 1e-5 of unit-scale
    outputs; bf16 within one bf16 step (rtol 2^-7) of the CPU's bf16."""
    from cald_tpu_torch.models.layers import GroupNorm, group_count

    rng = np.random.default_rng(width)
    x = torch.from_numpy(rng.normal(0.5, 1.5, (2, width, 20, 24)).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last).to(dtype)
    norm = GroupNorm(width, group_count(width))
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(rng.uniform(0.7, 1.3, width).astype(np.float32)))
        norm.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, width).astype(np.float32)))
    norm_gpu = GroupNorm(width, group_count(width)).to(card)
    norm_gpu.load_state_dict(norm.state_dict())
    xc, xg = x.clone().requires_grad_(), x.to(card).requires_grad_()
    want, got = norm(xc), norm_gpu(xg)
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
        g = torch.from_numpy(rng.normal(0, 1, want.shape).astype(np.float32))
        want.backward(g)
        got.backward(g.to(card))
        torch.testing.assert_close(xg.grad.cpu(), xc.grad, atol=1e-4, rtol=1e-4)
        for name in ("weight", "bias"):
            torch.testing.assert_close(getattr(norm_gpu, name).grad.cpu(),
                                       getattr(norm, name).grad, atol=1e-3, rtol=1e-4)
    else:
        torch.testing.assert_close(got.float().cpu(), want.float(), atol=1e-6, rtol=2 ** -7)


@pytest.mark.parametrize("name", ["ga", "ga:48", "sp", "sp:0.3", "color_adjust",
                                  "color_adjust:5", "color_swap"])
def test_photometric_card_matches_cpu(card, name):
    """build_aug_batch of each photometric aug with the same injected draws
    on the card and on the CPU (a padded image included): pixels within
    1e-3 (color_adjust 5e-2 at factor 5: its contrast mean is a float32 sum
    reduced in another order on each device), boxes and sizes exact."""
    from cald_tpu_torch.augment import suite

    rng = np.random.default_rng(3)
    images = rng.uniform(10, 245, (2, 96, 128, 3)).astype(np.float32)
    images[1, 70:] = 0.0
    images[1, :, 100:] = 0.0
    hw = np.array([[96, 128], [70, 100]], np.int32)
    boxes = np.tile(np.array([[10.0, 12.0, 50.0, 60.0]], np.float32), (2, 3, 1))
    valid = np.ones((2, 3), bool)
    draws = {}

    def draw(i, shape, kind="uniform"):
        if (i, shape, kind) not in draws:
            g = torch.Generator().manual_seed(7 + i)
            fn = torch.randn if kind == "normal" else torch.rand
            draws[(i, shape, kind)] = fn(shape, generator=g)
        return draws[(i, shape, kind)]

    args = [torch.from_numpy(a) for a in (images, boxes, valid, hw)]
    want = suite.build_aug_batch(*args, [name], draw)
    got = suite.build_aug_batch(*(a.to(card) for a in args), [name], draw)
    atol = 5e-2 if name == "color_adjust:5" else 1e-3
    torch.testing.assert_close(got[0].cpu(), want[0], atol=atol, rtol=0)
    torch.testing.assert_close(got[1].cpu(), want[1], atol=0, rtol=0)
    torch.testing.assert_close(got[2].cpu(), want[2], atol=0, rtol=0)
