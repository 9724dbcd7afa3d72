"""Parity of the port's ops (cald_tpu_torch.ops) with the JAX package's, on
the CPU in float32, from the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cald_tpu.ops import boxes as jboxes
from cald_tpu.ops import consistency as jcons
from cald_tpu.ops import divergence as jdiv
from cald_tpu.ops.nms import batched_nms as jbatched_nms
from cald_tpu.ops.nms import nms as jnms
from cald_tpu.ops.roi_align import fpn_level_assignment as jlevels
from cald_tpu.ops.roi_align import multi_scale_roi_align as jmsra
from cald_tpu.ops.flm_roi_align import flm_multi_scale_roi_align
from cald_tpu_torch.ops import boxes, consistency, divergence, nms, roi_align
from cald_tpu_torch.ops.roi_align_cuda import RoIAlignKernel
from tests.test_ops_boxes import random_boxes
from tests.torch_helpers import to_np

T = torch.from_numpy


def _close(got, want, atol):
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=atol, rtol=0)


# --------------------------------------------------------------------------
# boxes, divergence, consistency: atol 1e-5
# --------------------------------------------------------------------------

def test_box_iou_and_nocheck(rng):
    b1 = np.stack([random_boxes(rng, 17) for _ in range(2)])
    b2 = np.stack([random_boxes(rng, 23) for _ in range(2)])
    _close(boxes.box_iou(T(b1), T(b2)), jboxes.box_iou(b1, b2), 1e-5)
    ref = b1[:, :5]
    _close(boxes.pairwise_iou_nocheck(T(ref), T(b2)[:, None]),
           jax.vmap(jax.vmap(jboxes.pairwise_iou_nocheck, (0, None)))(ref, b2), 1e-5)


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_encode_decode(rng, weights):
    props = random_boxes(rng, 30)
    gt = random_boxes(rng, 30)
    _close(boxes.encode_boxes(T(gt), T(props), weights),
           jboxes.encode_boxes(gt, props, weights), 1e-5)
    # large deltas exercise the log(1000/16) clamp, which decodes boxes of
    # thousands of pixels: there 1e-5 is relative. Class-specific (N, C, 4).
    deltas = rng.normal(0, 3, (30, 5, 4)).astype(np.float32)
    for d in (deltas, deltas[:, 0]):
        np.testing.assert_allclose(to_np(boxes.decode_boxes(T(d), T(props), weights)),
                                   jboxes.decode_boxes(d, props, weights), atol=1e-5, rtol=1e-5)


def test_clip_boxes_per_image(rng):
    bx = (rng.uniform(-50, 200, (2, 10, 4))).astype(np.float32)
    hw = np.array([[96.0, 128.0], [80.0, 100.0]], np.float32)
    got = boxes.clip_boxes(T(bx), (T(hw[:, 0:1]), T(hw[:, 1:2])))
    want = jax.vmap(lambda b, h: jboxes.clip_boxes(b, (h[0], h[1])))(bx, hw)
    _close(got, want, 1e-5)


def test_divergences(rng):
    p = rng.uniform(0, 1, (6, 21)).astype(np.float32)
    q = rng.uniform(0, 1, (6, 21)).astype(np.float32)
    p[0, :5] = 0.0                                    # 0 * log(0/m) == 0
    _close(divergence.kl_divergence(T(p), T(q)), jdiv.kl_divergence(p, q), 1e-5)
    _close(divergence.js_divergence(T(p), T(q)), jdiv.js_divergence(p, q), 1e-5)


def _dets(rng, shape, k, c):
    bx = np.stack([random_boxes(rng, k, size=80.0) for _ in range(int(np.prod(shape)))])
    cls = rng.dirichlet(np.ones(c), size=shape + (k,)).astype(np.float32)
    return (bx.reshape(shape + (k, 4)), cls, cls[..., 1:].max(-1),
            rng.uniform(size=shape + (k,)) > 0.3)


def test_consistency_and_class_correlation(rng):
    b, a, k, c = 3, 4, 12, 5
    aug_boxes = np.stack([random_boxes(rng, k, size=80.0) for _ in range(b * a)]).reshape(
        b, a, k, 4)
    _, ref_cls, ref_pm, ref_valid = _dets(rng, (b,), k, c)
    det_boxes, det_cls, det_pm, det_valid = _dets(rng, (b, a), k, c)
    ref_valid[2] = False                              # no base detections
    det_valid[1, 3] = False                           # an aug with no detections
    args = (aug_boxes, ref_cls, ref_pm, ref_valid, det_boxes, det_cls, det_pm, det_valid)
    _close(consistency.cald_consistency(*map(T, args), 1.3),
           jcons.cald_consistency(*args, jnp.float32(1.3)), 1e-5)

    scores = rng.uniform(size=(b, a, k)).astype(np.float32)
    labels = rng.integers(0, c, (b, a, k)).astype(np.int32)
    _close(consistency.class_correlation(T(scores), T(labels), T(det_valid), c - 1),
           jcons.class_correlation(scores, labels, det_valid, c - 1), 1e-5)


# --------------------------------------------------------------------------
# NMS: slot for slot on the tie-free fixtures of tests/test_ops_nms.py
# --------------------------------------------------------------------------

def _jax_nms(bx, sc, **kw):
    outs = [jnms(jnp.asarray(b), jnp.asarray(s), **kw) for b, s in zip(bx, sc)]
    return np.stack([np.asarray(o[0]) for o in outs]), np.stack([np.asarray(o[1]) for o in outs])


@pytest.mark.parametrize("size,max_out,pre", [(40.0, 60, None), (500.0, 10, None),
                                              (40.0, 32, 32)])
def test_nms_slot_for_slot(rng, size, max_out, pre):
    n = 60
    bx = np.stack([random_boxes(rng, n, size=size) for _ in range(3)])
    sc = rng.uniform(0, 1, (3, n)).astype(np.float32)
    idx, valid = nms.nms(T(bx), T(sc), iou_threshold=0.5, max_outputs=max_out,
                         pre_nms_size=pre)
    jidx, jvalid = _jax_nms(bx, sc, iou_threshold=0.5, max_outputs=max_out,
                            pre_nms_size=pre)
    np.testing.assert_array_equal(to_np(valid), jvalid)
    np.testing.assert_array_equal(to_np(idx)[to_np(valid)], jidx[jvalid])


def test_nms_valid_mask_and_many_tiles(rng):
    """More candidates than one 512 tile: the cross-tile kill path runs."""
    n = 1100
    bx = np.stack([random_boxes(rng, n, size=600.0) for _ in range(2)])
    sc = rng.uniform(0, 1, (2, n)).astype(np.float32)
    valid = rng.uniform(size=(2, n)) > 0.2
    idx, kv = nms.nms(T(bx), T(sc), iou_threshold=0.5, max_outputs=300, valid=T(valid))
    outs = [jnms(jnp.asarray(b), jnp.asarray(s), iou_threshold=0.5, max_outputs=300,
                     valid=jnp.asarray(v)) for b, s, v in zip(bx, sc, valid)]
    for i, (ji, jv) in enumerate(outs):
        np.testing.assert_array_equal(to_np(kv[i]), np.asarray(jv))
        np.testing.assert_array_equal(to_np(idx[i])[to_np(kv[i])], np.asarray(ji)[np.asarray(jv)])


def test_batched_nms_slot_for_slot(rng):
    bx = np.stack([np.tile(random_boxes(rng, 12, size=30.0), (2, 1)) for _ in range(2)])
    sc = rng.uniform(0, 1, (2, 24)).astype(np.float32)
    labels = np.stack([np.array([1] * 12 + [2] * 12)] * 2).astype(np.int32)
    idx, valid = nms.batched_nms(T(bx), T(sc), T(labels), iou_threshold=0.5, max_outputs=24)
    for i in range(2):
        ji, jv = jbatched_nms(jnp.asarray(bx[i]), jnp.asarray(sc[i]),
                                  jnp.asarray(labels[i]), iou_threshold=0.5, max_outputs=24)
        np.testing.assert_array_equal(to_np(valid[i]), np.asarray(jv))
        np.testing.assert_array_equal(to_np(idx[i])[to_np(valid[i])],
                                      np.asarray(ji)[np.asarray(jv)])


# --------------------------------------------------------------------------
# RoIAlign: plain version vs the points path and vs the TPU kernel (FLM)
# --------------------------------------------------------------------------

SHAPES = ((80, 128), (40, 64), (20, 32), (10, 16))
SCALES = [0.25, 0.125, 0.0625, 0.03125]


def _pyramid(rng, b, c=128, shapes=SHAPES):
    return [rng.normal(0, 1, (b, h, w, c)).astype(np.float32) for h, w in shapes]


def _rois(rng, b, n, img_wh=(512, 320)):
    cx = rng.uniform(30, img_wh[0] - 30, (b, n))
    cy = rng.uniform(30, img_wh[1] - 30, (b, n))
    sz = rng.uniform(8, 280, (b, n))
    ar = rng.uniform(0.5, 2.0, (b, n))
    w, h = sz * np.sqrt(ar), sz / np.sqrt(ar)
    rois = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)
    # border-crossing, sub-pixel, whole-image, overhanging, extreme aspect
    rois[0, :6] = [[-20.0, -10.0, 60.0, 50.0], [500.0, 300.0, 560.0, 360.0],
                   [100.0, 100.0, 100.5, 100.5], [0.0, 0.0, 512.0, 320.0],
                   [480.0, 10.0, 680.0, 40.0], [5.0, 5.0, 6.0, 300.0]]
    return rois


def test_level_assignment(rng):
    rois = _rois(rng, 2, 40)
    want = jax.vmap(lambda r: jlevels(r))(rois)
    np.testing.assert_array_equal(to_np(roi_align.fpn_level_assignment(T(rois))), want)


def test_plain_matches_points_path(rng):
    feats = _pyramid(rng, 2, c=32)
    rois = _rois(rng, 2, 40)
    got = roi_align.multi_scale_roi_align([T(f) for f in feats], T(rois),
                                          spatial_scales=SCALES, chunk_size=16)
    want = jax.vmap(lambda *fr: jmsra(
        list(fr[:-1]), fr[-1], spatial_scales=SCALES, method="points"))(*feats, rois)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("shapes,img_wh", [
    (SHAPES, (512, 320)),
    (((42, 336), (21, 168), (11, 84), (6, 42)), (1300, 160)),   # COCO level widths
])
def test_plain_matches_flm_kernel(rng, shapes, img_wh):
    """Against the TPU kernel in interpret mode, gathered back by slot_of_roi
    (tests/test_flm_roi_align.py runs it so); invalid rois give zeros."""
    feats = _pyramid(rng, 2, c=128, shapes=shapes)
    rois = _rois(rng, 2, 24, img_wh=img_wh)
    valid = rng.uniform(size=(2, 24)) > 0.3
    rois = np.where(valid[..., None], rois, 0.0).astype(np.float32)
    pooled, slot = jax.jit(lambda f, r, v: flm_multi_scale_roi_align(
        f, r, v, spatial_scales=SCALES, group=8, hi_prec=True, interpret=True))(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), jnp.asarray(valid))
    want = np.asarray(jnp.take_along_axis(pooled, slot[:, :, None, None, None], axis=1))
    got = to_np(roi_align.multi_scale_roi_align([T(f) for f in feats], T(rois),
                                                spatial_scales=SCALES, valid=T(valid)))
    # atol 1e-4: the TPU kernel sums its W-tiled contraction in another order
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4, rtol=0)
    assert np.abs(got[~valid]).max() == 0.0


def test_wrapper_cpu_route_is_the_plain_version(rng):
    feats = [T(f) for f in _pyramid(rng, 2, c=16)]
    rois = T(_rois(rng, 2, 20))
    valid = T(rng.uniform(size=(2, 20)) > 0.4)
    kernel = RoIAlignKernel()
    got = kernel(feats, rois, valid, spatial_scales=SCALES)
    want = roi_align.multi_scale_roi_align(feats, rois, spatial_scales=SCALES, valid=valid)
    assert torch.equal(got, want)
    assert kernel.launches == 0 and kernel._fn is None   # nothing built or launched
    with pytest.raises(ValueError):
        kernel([f.to("meta") for f in feats], rois.to("meta"), valid.to("meta"),
               spatial_scales=SCALES)
