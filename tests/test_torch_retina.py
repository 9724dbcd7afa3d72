"""The port's RetinaNet (``cald_tpu_torch.models.retinanet``) against the JAX
package's on the CPU in float32, with the same weights moved through the
bridge: the FPN's extra blocks, the head and its reshape order, the focal
and L1 losses per image, the postprocess slot for slot (and against the
reference transcription of tests/test_golden_retina.py), ``detect`` and
``loss`` end to end on the tiny model, and the focal prior of the port's own
initialisation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cald_tpu.models.fpn import FPN as JFPN
from cald_tpu.models.retinanet import RetinaNetHead as JHead
from cald_tpu.models.retinanet import retinanet_losses as jlosses
from cald_tpu.models.retinanet import retinanet_postprocess as jpostprocess
from cald_tpu_torch.convert.from_flax import module_state_dict
from cald_tpu_torch.models.fpn import FPN
from cald_tpu_torch.models.init import random_init_
from cald_tpu_torch.models.matcher import BELOW, BETWEEN, match_anchors
from cald_tpu_torch.models.retinanet import (
    RetinaNet, RetinaNetConfig, RetinaNetHead, retinanet_losses, retinanet_postprocess,
)
from tests.test_golden_retina import golden_retina_postprocess
from tests.torch_helpers import TINY_RETINA, retina_models, tiny_images, to_np

# detection fields compared slot for slot on valid slots, with their tolerances
DET_ATOL = {"boxes": 1e-3, "scores": 1e-5, "scores_cls": 1e-5, "prob_max": 1e-5}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("extra,shapes", [
    ("p6p7", [(12, 16, 8), (6, 8, 16), (3, 4, 32)]),
    ("none", [(12, 16, 8), (6, 8, 16), (3, 4, 32)]),
    ("pool", [(3, 4, 16), (3, 4, 32)]),            # MobileNet's two stride-32 maps
], ids=["p6p7", "none", "pool-equal-levels"])
def test_fpn_extra_blocks(extra, shapes):
    """P6 from P5's output, P7 from relu(P6); equal-size levels add without
    resampling. float32, 1e-5 of each level's largest magnitude."""
    r = np.random.default_rng(1)
    feats = [r.normal(0, 1, (2, h, w, c)).astype(np.float32) for h, w, c in shapes]
    jfpn = JFPN(out_channels=16, extra=extra)
    params = jax.tree.map(np.asarray, jfpn.init(jax.random.key(0), feats)["params"])
    params = jax.tree.map(lambda p: p + r.normal(0, 0.05, p.shape).astype(np.float32), params)
    want = jfpn.apply({"params": params}, feats)
    fpn = FPN([c for _, _, c in shapes], 16, extra=extra)
    fpn.load_state_dict(module_state_dict(params), strict=True)
    got = fpn([_nchw(f) for f in feats])
    assert len(got) == len(want) == len(shapes) + {"p6p7": 2, "none": 0, "pool": 1}[extra]
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(to_np(g.permute(0, 2, 3, 1)), w,
                                   atol=1e-5 * np.abs(w).max(), rtol=0)


def test_head_matches_and_keeps_the_anchor_order():
    """The shared subnets on a 3-level pyramid (float32, 1e-5 of the largest
    value), and the reshape: anchor a of cell (y, x) of a level is row
    (y * W + x) * A + a, its class c the conv's channel a * C + c."""
    r = np.random.default_rng(2)
    pyramid = [r.normal(0, 1, (2, h, w, 16)).astype(np.float32)
               for h, w in ((6, 8), (3, 4), (2, 2))]
    jhead = JHead(num_classes=5, num_anchors=3, channels=16)
    params = jax.tree.map(np.asarray, jhead.init(jax.random.key(0), pyramid)["params"])
    params = jax.tree.map(lambda p: p * 30.0 + r.normal(0, 0.1, p.shape).astype(np.float32),
                          params)
    want = jhead.apply({"params": params}, pyramid)
    head = RetinaNetHead(5, 3, 16)
    head.load_state_dict(module_state_dict(params), strict=True)
    got = head([_nchw(f) for f in pyramid])
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(to_np(g), w, atol=1e-5 * np.abs(w).max(), rtol=0)
    conv = head.cls_logits(head._tower(_nchw(pyramid[1]), "cls"))        # (2, 15, 3, 4)
    y, x, a, c = 2, 1, 2, 3
    row = 6 * 8 * 3 + (y * 4 + x) * 3 + a
    assert to_np(got[0])[1, row, c] == pytest.approx(to_np(conv)[1, a * 5 + c, y, x], abs=1e-6)


def _loss_inputs(r, n_classes=6):
    """Anchors on a grid, logits and regressions, two images of gt (one
    with boxes on top of anchors, one with none)."""
    xy = np.stack(np.meshgrid(np.arange(0, 96, 12.0), np.arange(0, 64, 12.0)), -1).reshape(-1, 2)
    anchors = np.concatenate([np.concatenate([xy, xy + 16], 1),
                              np.concatenate([xy, xy + [24, 12]], 1)]).astype(np.float32)
    n = len(anchors)
    logits = r.normal(-1.0, 2.0, (2, n, n_classes)).astype(np.float32)
    regs = r.normal(0, 0.3, (2, n, 4)).astype(np.float32)
    gt_boxes = np.zeros((2, 4, 4), np.float32)
    gt_boxes[0, :3] = anchors[[5, 40, 77]] + r.normal(0, 2.0, (3, 4)).astype(np.float32)
    gt_labels = np.zeros((2, 4), np.int32)
    gt_labels[0, :3] = [1, 3, 5]
    gt_valid = np.zeros((2, 4), bool)
    gt_valid[0, :3] = True
    return logits, regs, anchors, gt_boxes, gt_labels, gt_valid


def test_losses_per_image():
    """Focal loss over non-ignored anchors and L1 over the foreground, each
    over the image's foreground count (at least 1), per image; the fixture
    has foreground, background and between anchors, and an image with no
    gt. float32, 1e-5 relative."""
    logits, regs, anchors, gb, gl, gv = _loss_inputs(np.random.default_rng(3))
    t = [torch.from_numpy(a) for a in (logits, regs, anchors, gb, gl, gv)]
    matches = to_np(match_anchors(t[3], t[5], t[2], high=0.5, low=0.4, allow_low_quality=True))
    assert (matches[0] >= 0).sum() > 3 and (matches[0] == BETWEEN).any()
    assert (matches[0] == BELOW).any() and (matches[1] == BELOW).all()
    kw = dict(num_classes=6, fg_iou=0.5, bg_iou=0.4, alpha=0.25, gamma=2.0)
    got = retinanet_losses(*t, **kw)
    want = jax.vmap(lambda cl, br, b, lb, v: jlosses(cl, br, jnp.asarray(anchors), b, lb, v,
                                                     **kw))(logits, regs, gb, gl, gv)
    for g, w in zip(got, want):
        assert g.shape == (2,)
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-5, atol=0)
    assert float(got[1][1]) == 0.0                  # no gt: no box loss


def _postprocess_inputs(r, counts=(60, 24), c=5):
    n = sum(counts)
    logits = r.normal(-5.0, 1.5, (2, n, c)).astype(np.float32)
    hot = r.choice(n * c, 80, replace=False)
    logits[0].reshape(-1)[hot] = r.normal(0.5, 1.5, 80).astype(np.float32)
    logits[1].reshape(-1)[hot[:40]] = r.normal(0.0, 1.5, 40).astype(np.float32)
    regs = r.normal(0, 0.2, (2, n, 4)).astype(np.float32)
    xy = r.uniform(0, 120, (n, 2))
    anchors = np.concatenate([xy, xy + r.uniform(8, 30, (n, 2))], 1).astype(np.float32)
    hw = np.array([[96, 128], [70, 90]], np.int32)
    return logits, regs, anchors, hw


@pytest.mark.parametrize("topk", [40, 1000], ids=["topk-cut", "topk-all"])
def test_postprocess_slot_for_slot(topk):
    """Per-level top-k, score/size/label filters, class-aware NMS: on valid
    slots boxes within 1e-3, scores and rows within 1e-5, labels and the
    valid mask exact; props zero."""
    logits, regs, anchors, hw = _postprocess_inputs(np.random.default_rng(4))
    kw = dict(score_thresh=0.05, nms_thresh=0.5, detections_per_img=24, topk_candidates=topk)
    got = retinanet_postprocess(torch.from_numpy(logits), torch.from_numpy(regs),
                                torch.from_numpy(anchors), (60, 24), torch.from_numpy(hw), **kw)
    want = jax.vmap(lambda cl, br, h: jpostprocess(cl, br, jnp.asarray(anchors), (60, 24), h,
                                                   **kw))(logits, regs, hw)
    valid = np.asarray(want.valid)
    assert valid.sum(axis=1).min() > 3, "degenerate fixture"
    np.testing.assert_array_equal(to_np(got.valid), valid)
    np.testing.assert_array_equal(to_np(got.labels)[valid], np.asarray(want.labels)[valid])
    for field, atol in DET_ATOL.items():
        np.testing.assert_allclose(to_np(getattr(got, field))[valid],
                                   np.asarray(getattr(want, field))[valid], atol=atol, rtol=0)
    assert not to_np(got.props).any()
    assert (to_np(got.labels)[valid] > 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_postprocess_matches_reference_transcription(seed):
    """The fixture of tests/test_golden_retina.py (two levels, counts below
    every cap) against its numpy transcription of the reference: scores and
    rows 2e-5, labels exact, boxes 1e-2, as that test holds the JAX path."""
    r = np.random.default_rng(seed)
    level_counts, c = (24, 12), 5
    n = sum(level_counts)
    logits = r.normal(-6.0, 1.0, (n, c)).astype(np.float32)
    hot = r.choice(n * c, 30, replace=False)
    logits.reshape(-1)[hot] = r.normal(0.5, 1.5, 30).astype(np.float32)
    regs = r.normal(0, 0.15, (n, 4)).astype(np.float32)
    xy = r.uniform(4, 120, (n, 2))
    wh = r.uniform(8, 24, (n, 2))
    anchors = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    hw = np.asarray([96, 112], np.int32)
    golden = golden_retina_postprocess(logits, regs, anchors, hw)
    assert len(golden) > 4

    dets = retinanet_postprocess(
        torch.from_numpy(logits)[None], torch.from_numpy(regs)[None], torch.from_numpy(anchors),
        level_counts, torch.from_numpy(hw)[None], score_thresh=0.05, nms_thresh=0.5,
        detections_per_img=64, topk_candidates=n * c)
    v = to_np(dets.valid)[0]
    assert int(v.sum()) == len(golden)
    order = np.argsort(-to_np(dets.scores)[0][v], kind="stable")
    got = {f: to_np(getattr(dets, f))[0][v][order]
           for f in ("scores", "labels", "boxes", "scores_cls", "prob_max")}
    for i, (s, cls, b, rows, pm) in enumerate(golden):
        assert got["scores"][i] == pytest.approx(s, abs=2e-5)
        assert int(got["labels"][i]) == cls
        np.testing.assert_allclose(got["boxes"][i], b, atol=1e-2)
        np.testing.assert_allclose(got["scores_cls"][i], rows, atol=2e-5)
        assert got["prob_max"][i] == pytest.approx(pm, abs=2e-5)


@pytest.fixture(scope="module")
def tiny():
    jmodel, variables, tmodel = retina_models()
    images, valid_hw = tiny_images()
    im, hw = jnp.asarray(images), jnp.asarray(valid_hw)
    pyr_j = jax.jit(lambda v, i, h: jmodel.apply(v, i, h, method="extract_features"))(
        variables, im, hw)
    det_j = jax.jit(lambda v, i, h: jmodel.apply(v, i, h, method="detect"))(variables, im, hw)
    with torch.inference_mode():
        pyr_t = tmodel.features(torch.from_numpy(images), torch.from_numpy(valid_hw))
        det_t = tmodel.detect(torch.from_numpy(images), torch.from_numpy(valid_hw))
    return jmodel, variables, tmodel, (pyr_j, det_j, pyr_t, det_t)


def test_tiny_pyramid(tiny):
    """P3..P7 of the tiny backbone, float32, 1e-4 absolute."""
    pyr_j, _, pyr_t, _ = tiny[3]
    assert len(pyr_t) == len(pyr_j) == 5
    for a, b in zip(pyr_j, pyr_t):
        np.testing.assert_allclose(to_np(b.permute(0, 2, 3, 1)), np.asarray(a), atol=1e-4,
                                   rtol=0)


def test_tiny_detect_slot_for_slot(tiny):
    """``detect`` end to end: valid masks and labels exact, the other fields
    on valid slots at ``DET_ATOL`` but scores and rows at 1e-4 (the pyramid
    runs through the amplified head)."""
    _, det_j, _, det_t = tiny[3]
    valid = np.asarray(det_j.valid)
    assert valid.sum() > 6, "degenerate fixture"
    np.testing.assert_array_equal(to_np(det_t.valid), valid)
    np.testing.assert_array_equal(to_np(det_t.labels), np.asarray(det_j.labels))
    atol = {**DET_ATOL, "scores": 1e-4, "scores_cls": 1e-4, "prob_max": 1e-4}
    for field, tol in atol.items():
        np.testing.assert_allclose(to_np(getattr(det_t, field))[valid],
                                   np.asarray(getattr(det_j, field))[valid], atol=tol, rtol=0)


def test_tiny_loss_per_image(tiny):
    """``loss(per_image=True)`` end to end with gt on both images, float32,
    1e-4 relative; ``draw`` is ignored (RetinaNet samples nothing) and the
    mean losses are the per-image means."""
    jmodel, variables, tmodel, _ = tiny
    images, valid_hw = tiny_images()
    r = np.random.default_rng(5)
    xy = r.uniform(0, 60, (2, 3, 2))
    gb = np.concatenate([xy, xy + r.uniform(12, 36, (2, 3, 2))], -1).astype(np.float32)
    gl = np.array([[1, 2, 3], [3, 1, 0]], np.int32)
    gv = np.array([[True, True, True], [True, True, False]])
    want, _ = jax.jit(lambda v, *a: jmodel.apply(v, *a, per_image=True, method="loss"))(
        variables, images, valid_hw, gb, gl, gv)
    args = [torch.from_numpy(a) for a in (images, valid_hw, gb, gl, gv)]
    got, pyramid = tmodel.loss(*args, None, per_image=True)
    assert set(got) == {"classification", "bbox_regression"} and len(pyramid) == 5
    for k in got:
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]), rtol=1e-4, atol=0)
    mean, _ = tmodel.loss(*args, lambda *_: 1 / 0)
    for k in got:
        assert float(mean[k].detach()) == pytest.approx(float(got[k].detach().mean()), rel=1e-6)


def test_initial_scores_at_the_focal_prior():
    """The port's own initialisation: head convs normal(0.01) and the
    cls_logits bias at -log((1 - 0.01) / 0.01), so every sigmoid score
    starts near 0.01 and an untrained model detects nothing (the JAX
    package's tests/test_models.py::test_focal_prior_initial_scores)."""
    model = RetinaNet(RetinaNetConfig(**TINY_RETINA)).eval()
    random_init_(model, 0)
    assert float(model.head.cls_logits.bias[0].detach()) == pytest.approx(-np.log(99.0), rel=1e-6)
    assert float(model.head.cls_conv0.weight.detach().std()) == pytest.approx(0.01, rel=0.05)
    assert not model.head.bbox_reg.bias.any()
    images, valid_hw = (torch.from_numpy(a) for a in tiny_images())
    with torch.inference_mode():
        logits, _ = model.head(model.features(images, valid_hw))
        dets = model.detect(images, valid_hw)
    p = torch.sigmoid(logits)
    assert float(p.mean()) == pytest.approx(0.01, rel=0.05)
    assert float(p.max()) < 0.05
    assert not dets.valid.any()
