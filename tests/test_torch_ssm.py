"""The port's SSM (``models/roi_heads.py::ssm_postprocess_detections``,
``FasterRCNNConfig.ssm_mode``, ``strategies/ssm.py``) against the JAX
package's on the CPU in float32: the postprocess slot for slot (the
per-class cap and sub-threshold cases of tests/test_models.py among them),
the tiny detector's SSM detect, the host judges, and ``ssm_select`` with a
stubbed re-detect on the same detections and the same ``default_rng``.
Each comparison states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cald_tpu import native
from cald_tpu.data.loader import decode_image as jdecode
from cald_tpu.data.voc import get_voc2007 as jget_voc2007
from cald_tpu.models.roi_heads import ssm_postprocess_detections as jssm_postprocess
from cald_tpu.strategies import ssm as jssm
from cald_tpu_torch.data.loader import decode_image
from cald_tpu_torch.data.synthetic import make_learnable_voc
from cald_tpu_torch.data.voc import get_voc2007
from cald_tpu_torch.models.roi_heads import ssm_postprocess_detections
from cald_tpu_torch.strategies import ssm
from tests.torch_helpers import tiny_images, tiny_models, to_np

T = torch.from_numpy
EXACT = ("valid", "labels")
ATOL = {"boxes": 1e-4, "props": 1e-4, "scores": 1e-6, "scores_cls": 1e-6, "prob_max": 1e-6}


def _random_case(rng):
    """Two images of 24 proposals over 4 classes: overlapping boxes, a few
    invalid proposals, regressions that move the boxes, and a second image
    with a smaller valid region (clipping)."""
    b, n, c = 2, 24, 4
    logits = rng.normal(0, 2.0, (b, n, c)).astype(np.float32)
    xy = rng.uniform(0, 40, (b, n, 2))
    wh = rng.uniform(5, 20, (b, n, 2))
    props = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    regs = rng.normal(0, 0.3, (b, n, 4 * c)).astype(np.float32)
    valid = rng.uniform(size=(b, n)) > 0.15
    hw = np.array([[64, 64], [40, 50]], np.int32)
    return logits, regs, props, valid, hw, dict(detections_per_class=3, out_slots=32)


def _cap_case(rng):
    """tests/test_models.py's per-class cap: 8 disjoint boxes of one class,
    scores descending, capped at 4; the second image repeats them with
    zero logits (every score 0.5 over two classes) and invalid slots."""
    n, c = 8, 2
    props = np.asarray([[i * 8.0, 0.0, i * 8.0 + 6.0, 6.0] for i in range(n)], np.float32)
    logits = np.zeros((2, n, c), np.float32)
    logits[0, :, 1] = np.linspace(3.0, 1.0, n)
    regs = np.zeros((2, n, c * 4), np.float32)
    valid = np.ones((2, n), bool)
    valid[1, ::3] = False
    return (logits, regs, np.stack([props, props]), valid, np.array([[64, 64]] * 2, np.int32),
            dict(detections_per_class=4, out_slots=16))


def _subthreshold_case(rng):
    """Duplicates of one box: the top survives per class, and classes whose
    scores are all at or below 0.05 leave no detection (filtered after
    NMS); several classes per proposal compete in the 32 slots."""
    n, c = 12, 6
    box = np.array([10.0, 10.0, 30.0, 30.0], np.float32)
    props = (box + rng.normal(0, 0.5, (2, n, 4))).astype(np.float32)
    logits = np.full((2, n, c), -4.0, np.float32)
    logits[:, :, 0] = 3.0                               # background dominates
    logits[:, :, 1] = rng.uniform(1.0, 3.0, (2, n))     # above 0.05
    logits[:, :, 2] = rng.uniform(-1.0, 0.6, (2, n))    # around 0.05
    regs = np.zeros((2, n, c * 4), np.float32)
    return (logits, regs, props, np.ones((2, n), bool), np.array([[48, 48]] * 2, np.int32),
            dict(detections_per_class=2, out_slots=32))


@pytest.mark.parametrize("case", [_random_case, _cap_case, _subthreshold_case],
                         ids=["random", "per-class-cap", "sub-threshold"])
def test_ssm_postprocess_slot_for_slot(rng, case):
    """Labels and validity exact; boxes and props 1e-4; scores 1e-6."""
    logits, regs, props, valid, hw, kw = case(rng)
    kw = dict(score_thresh=0.05, nms_thresh=0.3, **kw)
    want = jax.jit(jax.vmap(lambda *a: jssm_postprocess(*a, **kw)))(
        logits, regs, props, valid, hw)
    got = ssm_postprocess_detections(T(logits), T(regs), T(props), T(valid), T(hw), **kw)
    assert int(np.asarray(want.valid).sum()) > 0
    for field in EXACT:
        np.testing.assert_array_equal(to_np(getattr(got, field)),
                                      np.asarray(getattr(want, field)), err_msg=field)
    for field, atol in ATOL.items():
        np.testing.assert_allclose(to_np(getattr(got, field)), np.asarray(getattr(want, field)),
                                   atol=atol, rtol=0, err_msg=field)


def test_ssm_postprocess_caps_each_class(rng):
    logits, regs, props, valid, hw, kw = _cap_case(rng)
    got = ssm_postprocess_detections(T(logits), T(regs), T(props), T(valid), T(hw),
                                     nms_thresh=0.3, **kw)
    assert int(got.valid[0].sum()) == 4
    assert got.scores.shape == (2, 16)


def test_ssm_detect_matches_jax():
    """The tiny detector in ssm_mode (NMS 0.3, 20 per class, 300 slots),
    slot for slot at tests/test_torch_detect.py's tolerances."""
    kw = dict(ssm_mode=True, box_nms_thresh=0.3)
    jmodel, variables, tmodel = tiny_models(**kw)
    images, hw = tiny_images()
    want = jax.jit(lambda v, i, h: jmodel.apply(v, i, h, method="detect"))(
        variables, jnp.asarray(images), jnp.asarray(hw))
    with torch.inference_mode():
        got = tmodel.detect(T(images), T(hw))
    assert got.valid.shape == (2, 300) and int(np.asarray(want.valid).sum()) > 10
    for field in EXACT:
        np.testing.assert_array_equal(to_np(getattr(got, field)),
                                      np.asarray(getattr(want, field)), err_msg=field)
    for field, atol in {"scores": 1e-3, "prob_max": 1e-3, "scores_cls": 1e-3,
                        "boxes": 1e-2, "props": 1e-2}.items():
        np.testing.assert_allclose(to_np(getattr(got, field)), np.asarray(getattr(want, field)),
                                   atol=atol, rtol=0, err_msg=field)


def test_host_judges_are_the_jax_functions(rng):
    rows = rng.uniform(0, 1, (20, 7))
    lam = rng.uniform(0.05, 1.0, 7)
    for r in rows:
        y = ssm.judge_y(r)
        np.testing.assert_array_equal(y, jssm.judge_y(r))
        loss = ssm.pseudo_loss(r, y)
        np.testing.assert_array_equal(loss, jssm.pseudo_loss(r, y))
        for gamma in (0.15, 3.0):
            easy, v = ssm.judge_uv(loss, gamma, lam)
            jeasy, jv = jssm.judge_uv(loss, gamma, lam)
            assert easy == jeasy
            np.testing.assert_array_equal(v, jv)


# --------------------------------------------------------------------------
# ssm_select with the cross-validator and a stubbed re-detect
# --------------------------------------------------------------------------

COLORS = np.array([(220, 40, 40), (40, 220, 40), (40, 40, 220)], np.float32)


def stub_detect(images):
    """A re-detect that finds each class colour of make_learnable_voc: the
    bounding box of its pixels, score 0.9, VOC labels 1-3."""
    out = []
    for img in images:
        boxes, labels = [], []
        for c, col in enumerate(COLORS):
            ys, xs = np.nonzero(np.abs(img - col).max(-1) < 30)
            if len(ys):
                boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
                labels.append(c + 1)
        out.append({"boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
                    "scores": np.full(len(labels), 0.9, np.float32),
                    "labels": np.asarray(labels, np.int32)})
    return out


@pytest.fixture
def voc_jpg(tmp_path, monkeypatch):
    # both packages decode the JPEGs with Pillow (the JAX package's native
    # decoder, where built, is another codec)
    monkeypatch.setattr(native, "available", lambda: False)
    return make_learnable_voc(tmp_path / "voc", num_images=16, hw=(60, 80), seed=2)


def _pool_dets(ds, pool, rng):
    """Per pool image: al (no confident detection) for a few, otherwise the
    gt boxes with confident single-class rows (easy, cross-validated) or,
    now and then, a row confident in two classes (hard)."""
    dets = []
    for k, idx in enumerate(pool):
        rec = ds.record(int(idx))
        rows = np.full((len(rec.boxes), 20), 1e-3)
        rows[np.arange(len(rec.boxes)), rec.labels - 1] = 0.97
        if k % 5 == 4:
            rows[0, 10] = 0.6
        dets.append({"boxes": rec.boxes.astype(np.float32), "score_rows": rows,
                     "al": k % 7 == 3})
    return dets


@pytest.mark.parametrize("budget", [3, 8])
def test_ssm_select_matches_jax(voc_jpg, rng, budget):
    """The same chosen positions, gamma and clslambda (atol 1e-12) as the
    JAX package's on the same detections and the same default_rng; the
    cross-validator pastes and re-detects."""
    ds, jds = get_voc2007(voc_jpg, "trainval"), jget_voc2007(voc_jpg, "trainval")
    labeled, pool = np.arange(6), np.arange(6, 16)
    dets = _pool_dets(ds, pool, rng)
    calls = {"port": 0, "jax": 0}

    def run(mod, dataset, decode, name):
        def detect(images):
            calls[name] += len(images)
            return stub_detect(images)

        def patch_getter(i, box):
            img = decode(dataset.record(int(pool[i])).image_path).astype(np.float32)
            x1, y1, x2, y2 = (int(max(0, box[0])), int(max(0, box[1])),
                              int(min(img.shape[1], box[2])), int(min(img.shape[0], box[3])))
            return img[y1:y2, x1:x2]

        r = np.random.default_rng(100)
        cv = mod.CrossValidator(dataset, detect, mod.SSMConfig(), r)
        return mod.ssm_select(dets, np.arange(len(pool)), budget, gamma=0.15,
                              clslambda=np.full(20, np.log(2.0)), cross_validator=cv,
                              labeled_indices=labeled, rng=r, patch_getter=patch_getter)

    got = run(ssm, ds, decode_image, "port")
    want = run(jssm, jds, jdecode, "jax")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == pytest.approx(0.2)
    np.testing.assert_allclose(got[2], want[2], atol=1e-12, rtol=0)
    assert calls["port"] == calls["jax"] > 0 and len(got[0]) == budget
