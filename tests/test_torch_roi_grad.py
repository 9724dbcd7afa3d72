"""Training RoIAlign of the port: the plain versions of K2 (forward, float32
output) and K3 (backward, ``multi_scale_roi_align_backward``) against the JAX
package's K2/K3 kernels (``ops/pallas_roi_align.py``) run in interpret mode,
against ``jax.grad`` of the JAX points path, and against torch autograd; and
the CPU route of ``RoIAlignFunction``. On the CPU in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cald_tpu.ops.pallas_roi_align import WIN_TRAIN, pallas_multi_scale_roi_align
from cald_tpu.ops.roi_align import multi_scale_roi_align as jmsra
from cald_tpu_torch.models.roi_heads import pool_box_features
from cald_tpu_torch.ops import roi_align as plain
from cald_tpu_torch.ops.roi_align_cuda import (
    RoIAlignFunction, roi_align_bwd_kernel, roi_align_train_fwd_kernel,
)
from tests.torch_helpers import to_np

T = torch.from_numpy
SHAPES = ((40, 64), (20, 32), (10, 16), (5, 8))          # P2..P5 of a 160x256 image
SCALES = [0.25, 0.125, 0.0625, 0.03125]


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The TPU kernels run in interpret mode, as tests/test_pallas_interpret.py
    runs them on the CPU."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _feats(rng, b, c):
    return [rng.normal(0, 1, (b, h, w, c)).astype(np.float32) for h, w in SHAPES]


def _rois(rng, n, *, wide: bool = False):
    """Rois inside the 48x56 training window at their level; with ``wide``,
    elongated ones that cross it (and border-crossing, tiny ones)."""
    cx = rng.uniform(20, 236, n)
    cy = rng.uniform(20, 140, n)
    sz = rng.uniform(16, 120, n)
    ar = rng.uniform(0.5, 2.0, n)
    w, h = sz * np.sqrt(ar), sz / np.sqrt(ar)
    rois = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)
    if wide:
        rois[:5] = [[5.0, 5.0, 250.0, 40.0], [10.0, 2.0, 40.0, 158.0], [-20.0, -10.0, 60.0, 50.0],
                    [100.0, 100.0, 100.5, 100.5], [200.0, 120.0, 300.0, 190.0]]
    return rois


def _plain_fwd(feats, rois, valid=None):
    return plain.multi_scale_roi_align(feats, rois, spatial_scales=SCALES, valid=valid,
                                       out_dtype=torch.float32)


def _plain_bwd(cot, rois, valid, feats):
    levels = plain.roi_levels(rois, SCALES)
    return plain.multi_scale_roi_align_backward(cot, rois, valid, levels,
                                                [f.shape for f in feats],
                                                spatial_scales=SCALES)


def test_plain_matches_tpu_kernels_inside_window(rng, interpret_pallas):
    """K2 forward and the K3 custom_vjp backward, interpret mode, on rois
    inside WIN_TRAIN, where the TPU kernels are exact. atol 1e-4: the TPU
    kernels contract in HIGHEST-precision matmuls, in another order."""
    feats = _feats(rng, 1, 128)
    rois = _rois(rng, 16)
    cot = rng.normal(0, 1, (16, 7, 7, 128)).astype(np.float32)
    jf = [jnp.asarray(f[0]) for f in feats]
    fwd = lambda fs: pallas_multi_scale_roi_align(list(fs), jnp.asarray(rois),
                                                  spatial_scales=SCALES, window=WIN_TRAIN)
    want = fwd(jf)
    want_g = jax.grad(lambda fs: jnp.sum(fwd(fs) * cot))(tuple(jf))
    assert want.dtype == jnp.float32

    tf = [T(f) for f in feats]
    got = _plain_fwd(tf, T(rois)[None])
    got_g = _plain_bwd(T(cot)[None], T(rois)[None], None, tf)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got)[0], np.asarray(want), atol=1e-4, rtol=0)
    for g, w in zip(got_g, want_g):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(to_np(g)[0], np.asarray(w), atol=1e-4, rtol=0)


def test_plain_matches_points_path_grad_outside_window(rng):
    """Rois wider than the TPU window, where the port stays exact: against
    the JAX points path and its jax.grad (atol 1e-5, f32 sums in another
    order)."""
    feats = _feats(rng, 2, 24)
    rois = np.stack([_rois(rng, 12, wide=True), _rois(rng, 12, wide=True)])
    cot = rng.normal(0, 1, (2, 12, 7, 7, 24)).astype(np.float32)

    def jfwd(fs):
        return jax.vmap(lambda *fr: jmsra(list(fr[:-1]), fr[-1], spatial_scales=SCALES,
                                           method="points"))(*fs, jnp.asarray(rois))

    jf = tuple(jnp.asarray(f) for f in feats)
    want_g = jax.grad(lambda fs: jnp.sum(jfwd(fs) * cot))(jf)
    tf = [T(f) for f in feats]
    np.testing.assert_allclose(to_np(_plain_fwd(tf, T(rois))), np.asarray(jfwd(jf)),
                               atol=1e-5, rtol=0)
    for g, w in zip(_plain_bwd(T(cot), T(rois), None, tf), want_g):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-5, rtol=0)


def test_plain_backward_is_autograd_of_plain_forward(rng):
    """The explicit scatter equals torch autograd of the plain forward,
    invalid rois included (they add nothing). atol 1e-5: f32 scatter order."""
    feats = [T(f).requires_grad_() for f in _feats(rng, 2, 16)]
    rois = T(np.stack([_rois(rng, 10, wide=True), _rois(rng, 10)]))
    valid = T(rng.uniform(size=(2, 10)) > 0.3)
    cot = T(rng.normal(0, 1, (2, 10, 7, 7, 16)).astype(np.float32))
    want = torch.autograd.grad((_plain_fwd(feats, rois, valid) * cot).sum(), feats)
    got = _plain_bwd(cot, rois, valid, feats)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), to_np(w), atol=1e-5, rtol=0)
    # a cotangent only on the invalid slots moves nothing
    dead = _plain_bwd(cot * (~valid)[..., None, None, None], rois, valid, feats)
    assert all(float(g.abs().max()) == 0.0 for g in dead)


def test_function_cpu_route_is_the_plain_versions(rng):
    """RoIAlignFunction on CPU tensors: forward and backward are the plain
    versions exactly, the rois get no gradient, and no kernel is built or
    launched."""
    feats = [T(f).requires_grad_() for f in _feats(rng, 2, 8)]
    rois = T(np.stack([_rois(rng, 6, wide=True), _rois(rng, 6)])).requires_grad_()
    valid = T(rng.uniform(size=(2, 6)) > 0.3)
    cot = T(rng.normal(0, 1, (2, 6, 7, 7, 8)).astype(np.float32))
    before = (roi_align_train_fwd_kernel.launches, roi_align_bwd_kernel.launches)

    out = RoIAlignFunction.apply(rois, valid, tuple(SCALES), 7, 2, *feats)
    assert torch.equal(out, _plain_fwd([f.detach() for f in feats], rois.detach(), valid))
    (out * cot).sum().backward()
    want = _plain_bwd(cot, rois.detach(), valid, feats)
    for f, w in zip(feats, want):
        assert torch.equal(f.grad, w)
    assert rois.grad is None
    assert float(out.detach()[~valid].abs().max()) == 0.0
    # pool_box_features, the form the detector calls, is the same function
    again = pool_box_features([f.detach() for f in feats], rois, valid, SCALES)
    assert torch.equal(again, out.detach())
    assert (roi_align_train_fwd_kernel.launches, roi_align_bwd_kernel.launches) == before
    assert roi_align_train_fwd_kernel._fn is None and roi_align_bwd_kernel._fn is None


def _separable_backward(cot, rois, valid, levels, level_shapes, out=7, sr=2):
    """K3's formulation (``csrc/roi_align.cu``), in torch: per valid roi, the
    pooled taps of each axis ("hi" mode) regrouped by distinct pixel into
    Wy (S, nu) and Wx (S, nv), then one add per distinct pixel of the roi's
    footprint, dF[u, v] = sum_y sum_x Wy[y, u] * Wx[x, v] * g[y, x]. Returns
    the level gradients and the number of adds."""
    grads = [torch.zeros(tuple(s)) for s in level_shapes]
    adds = 0

    def by_pixel(pix, wt):
        uniq = torch.unique(pix[wt != 0])              # ascending
        w = torch.zeros(out, len(uniq))
        for y in range(out):
            for k in range(2 * sr):
                if wt[y, k] != 0:
                    w[y, torch.searchsorted(uniq, pix[y, k])] = wt[y, k]
        return uniq, w

    for i in range(rois.shape[0]):
        for j in range(rois.shape[1]):
            if not valid[i, j]:
                continue
            lv = int(levels[i, j])
            h, w, scale = level_shapes[lv][1], level_shapes[lv][2], SCALES[lv]
            x1, y1 = rois[i, j, 0] * scale, rois[i, j, 1] * scale
            rw = (rois[i, j, 2] * scale - x1).clamp_min(1.0)
            rh = (rois[i, j, 3] * scale - y1).clamp_min(1.0)
            rows, wy = plain._pooled_taps(y1[None], rh[None], torch.tensor([float(h)]), out, sr,
                                          False)
            cols, wx = plain._pooled_taps(x1[None], rw[None], torch.tensor([float(w)]), out, sr,
                                          False)
            ru, wy_u = by_pixel(rows[0], wy[0])
            cu, wx_v = by_pixel(cols[0], wx[0])
            d = torch.einsum("yu,xv,yxc->uvc", wy_u, wx_v, cot[i, j])
            grads[lv][i, ru[:, None], cu[None, :]] += d
            adds += d.shape[0] * d.shape[1]
    return grads, adds


def test_separable_backward_matches_plain_and_jax(rng):
    """K3's merged form equals the corner scatter and jax.grad of the JAX
    points path (f32, atol 1e-5) on border-crossing, tiny, one-pixel,
    overlapping (a roi repeated and jittered) and invalid rois, with one add
    per distinct footprint pixel: fewer than the 784 corner adds of a roi."""
    feats = _feats(rng, 2, 8)
    rois = np.stack([_rois(rng, 12, wide=True), _rois(rng, 12)])
    rois[1, :4] = [[30.0, 30.0, 30.2, 30.3], rois[0, 0], rois[0, 0],
                   rois[0, 0] + [1.5, -0.5, 2.0, 1.0]]
    rois[0, 6:8] = rois[0, 5]
    valid = rng.uniform(size=(2, 12)) > 0.25
    valid[:, :8] = True
    cot = rng.normal(0, 1, (2, 12, 7, 7, 8)).astype(np.float32)
    tr, tv, tc = T(rois), T(valid), T(cot)
    levels = plain.roi_levels(tr, SCALES)
    shapes = [f.shape for f in feats]
    got, adds = _separable_backward(tc, tr, tv, levels, shapes)
    assert adds < 784 * int(valid.sum())
    want = plain.multi_scale_roi_align_backward(tc, tr, tv, levels, shapes,
                                                spatial_scales=SCALES)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), to_np(w), atol=1e-5, rtol=0)

    def jfwd(fs):
        return jax.vmap(lambda *fr: jmsra(list(fr[:-1]), fr[-1], spatial_scales=SCALES,
                                           method="points"))(*fs, jnp.asarray(rois))

    jcot = cot * valid[..., None, None, None]
    want_j = jax.grad(lambda fs: jnp.sum(jfwd(fs) * jcot))(tuple(jnp.asarray(f) for f in feats))
    for g, w in zip(got, want_j):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-5, rtol=0)
