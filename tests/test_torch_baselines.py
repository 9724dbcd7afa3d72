"""The LT/C and LS/C baselines of the port (``strategies/ltc.py``,
``strategies/lsc.py``) against the JAX package's, on the CPU in float32:
the legacy IoU, ``ltc_scores`` on the same ``Detections``, the top-30
reference slots, both score functions on the tiny detector with the same
weights (LS/C with JAX's noise normals injected), and the pool drivers'
bookkeeping. Each comparison states its tolerance."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cald_tpu.models.detections import Detections as JDetections
from cald_tpu.strategies import lsc as jlsc
from cald_tpu.strategies import ltc as jltc
from cald_tpu_torch.models.detections import Detections
from cald_tpu_torch.strategies import lsc, ltc
from tests.torch_helpers import tiny_images, tiny_models, to_np

T = torch.from_numpy


def _random_boxes(rng, shape, size=100.0):
    xy = rng.uniform(0, size, shape + (2,))
    wh = rng.uniform(-2, 40, shape + (2,))          # a few inverted boxes
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _detections(rng, b=3, k=40, c=4):
    """Random fixed-slot detections: props near the boxes (some disjoint),
    tied prob_max values, image 2 without any valid slot."""
    boxes = _random_boxes(rng, (b, k))
    props = boxes + rng.normal(0, 3, boxes.shape).astype(np.float32)
    props[:, ::7] += 200.0
    prob_max = rng.choice([0.3, 0.55, 0.9], (b, k)).astype(np.float32)
    valid = rng.uniform(size=(b, k)) > 0.3
    valid[2] = False
    arrays = dict(boxes=boxes, scores=prob_max, valid=valid,
                  labels=rng.integers(1, c, (b, k)).astype(np.int32),
                  scores_cls=rng.uniform(size=(b, k, c)).astype(np.float32),
                  prob_max=prob_max, props=props)
    return (Detections(**{f: T(a) for f, a in arrays.items()}),
            JDetections(**{f: jnp.asarray(a) for f, a in arrays.items()}))


def test_legacy_iou_matches_jax(rng):
    """The asymmetric +1 conventions, disjoint and inverted pairs: 1e-6."""
    a, b = _random_boxes(rng, (200,)), _random_boxes(rng, (200,))
    b[:50] = a[:50] + rng.normal(0, 2, (50, 4)).astype(np.float32)
    want = np.asarray(jltc._legacy_iou(a, b))
    got = to_np(ltc._legacy_iou(T(a), T(b)))
    assert (want == 0).any() and (want > 0.5).any()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_ltc_scores_match_jax(rng):
    """Invalid slots count as +inf, the minimum is capped at 1.0 (image 2,
    without detections, scores 1.0): 1e-6."""
    dets, jdets = _detections(rng)
    got, want = to_np(ltc.ltc_scores(dets)), np.asarray(jltc.ltc_scores(jdets))
    assert want[2] == 1.0
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_top30_matches_jax(rng):
    """The same 30 slots in the same order, ties by the lower slot first."""
    dets, jdets = _detections(rng)
    got = lsc._top30(dets)
    want = jlsc._top30(jdets)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    assert got[0].shape == (3, 30, 4)


@pytest.fixture(scope="module")
def models():
    jm, variables, tm = tiny_models()
    images, valid_hw = tiny_images()
    return jm, variables, tm, images, valid_hw


def test_ltc_score_fn_matches_jax(models):
    """The tiny detector with bridged weights: atol 1e-3 (detect's prob_max
    tolerance; its 1e-2 px box tolerance moves the IoU of boxes tens of
    pixels wide by less)."""
    jm, variables, tm, images, valid_hw = models
    want = np.asarray(jltc.make_ltc_score_fn(jm)(variables, images, valid_hw))
    got = to_np(ltc.make_ltc_score_fn(tm)(T(images), T(valid_hw)))
    assert (want < 1.0).all(), "degenerate fixture"
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def jax_normals(key, batch_index):
    """A port ``Draw`` giving the normals JAX's LS/C draws for noise level i
    of batch ``batch_index``: ``split(fold_in(fold_in(key, bi), i), B)``,
    one (H, W, C) draw per image."""
    key = jax.random.fold_in(key, batch_index)

    def draw(i, shape, kind="uniform"):
        assert kind == "normal"
        keys = jax.random.split(jax.random.fold_in(key, i), shape[0])
        return T(np.array(jax.vmap(lambda k: jax.random.normal(k, shape[1:]))(keys)))
    return draw


def test_lsc_score_fn_matches_jax(models):
    """stds (8, 24, 48): the base detect, the 3 x B noisy images in one
    detect, the stability and the score: atol 1e-3 (detect's tolerances,
    as for LT/C)."""
    jm, variables, tm, images, valid_hw = models
    stds = (8.0, 24.0, 48.0)
    key = jax.random.key(4)
    want = np.asarray(jlsc.make_lsc_score_fn(jm, stds)(
        variables, jnp.asarray(images), jnp.asarray(valid_hw), jax.random.fold_in(key, 0)))
    detects = []
    detect = tm.detect

    def counting(images_, valid_hw_):
        detects.append(images_.shape[0])
        return detect(images_, valid_hw_)

    tm.detect = counting
    try:
        got = to_np(lsc.make_lsc_score_fn(tm, stds)(T(images), T(valid_hw),
                                                     jax_normals(key, 0)))
    finally:
        del tm.detect
    assert detects == [2, 2 * len(stds)], "the noisy variants are not one batched detect"
    assert np.all(want != 0.0), "degenerate fixture"
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("strategy", ["ltc", "lsc"])
def test_pool_drivers_match_jax(strategy):
    """run_ltc / lsc_scores place each batch's scores at their pool
    positions as the JAX drivers do: a padded duplicate writes its value
    again, and an image no batch scored keeps the driver's fill (LT/C
    +inf, LS/C 0)."""
    pool = [10, 11, 12, 13, 14]
    batches = []
    for idx in ([12, 10], [13, 13]):
        images = np.zeros((2, 4, 4, 3), np.float32)
        images[:, 0, 0, 0] = idx                     # the score functions read it back
        batches.append(types.SimpleNamespace(images=images, image_idx=np.array(idx),
                                             valid_hw=np.full((2, 2), 4, np.int32)))

    def score(images):
        return (np.asarray(images)[:, 0, 0, 0] - 11.5) / 4

    if strategy == "ltc":
        want = jltc.run_ltc(lambda v, im, hw: score(im), None, batches, pool)
        got = ltc.run_ltc(lambda im, hw: T(score(im)), batches, pool, "cpu")
        assert np.isinf(got[[1, 4]]).all()
    else:
        want = jlsc.lsc_scores(lambda v, im, hw, k: score(im), None, batches,
                               jax.random.key(0), pool)
        got = lsc.lsc_scores(lambda im, hw, draw: T(score(im)), batches, pool,
                             torch.Generator())
    np.testing.assert_array_equal(got, want)
