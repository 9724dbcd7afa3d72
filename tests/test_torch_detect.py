"""The port's Faster R-CNN (tiny backbone, frozen norms, 96x128 canvas)
against the JAX package's, with the same weights moved through the bridge,
on the CPU in float32. Detections are compared slot for slot at the
tolerances of tests/test_golden_parity.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cald_tpu_torch.models import rpn
from cald_tpu_torch.models.anchors import generate_anchors
from cald_tpu.models.anchors import generate_anchors as jgenerate_anchors
from cald_tpu.models.rpn import select_proposals as jselect_proposals
from tests.torch_helpers import tiny_images, tiny_models, to_np

FIELDS_ATOL = {"scores": 1e-3, "prob_max": 1e-3, "scores_cls": 1e-3,
               "boxes": 1e-2, "props": 1e-2}


@pytest.fixture(scope="module")
def outputs():
    jmodel, variables, tmodel = tiny_models()
    images, valid_hw = tiny_images()
    im, hw = jnp.asarray(images), jnp.asarray(valid_hw)
    pyr_j = jax.jit(lambda v, i, h: jmodel.apply(v, i, h, method="extract_features"))(
        variables, im, hw)
    det_j = jax.jit(lambda v, i, h: jmodel.apply(v, i, h, method="detect"))(variables, im, hw)
    with torch.inference_mode():
        pyr_t = tmodel.features(torch.from_numpy(images), torch.from_numpy(valid_hw))
        det_t = tmodel.detect(torch.from_numpy(images), torch.from_numpy(valid_hw))
    return pyr_j, det_j, pyr_t, det_t


def test_pyramid(outputs):
    pyr_j, _, pyr_t, _ = outputs
    assert len(pyr_j) == len(pyr_t) == 5
    for a, b in zip(pyr_j, pyr_t):
        np.testing.assert_allclose(to_np(b.permute(0, 2, 3, 1)), np.asarray(a), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("field", ["valid", "labels"])
def test_detections_exact_fields(outputs, field):
    _, det_j, _, det_t = outputs
    assert int(np.asarray(det_j.valid).sum()) > 10, "degenerate fixture"
    np.testing.assert_array_equal(to_np(getattr(det_t, field)),
                                  np.asarray(getattr(det_j, field)))


@pytest.mark.parametrize("field", sorted(FIELDS_ATOL))
def test_detections_slot_for_slot(outputs, field):
    _, det_j, _, det_t = outputs
    np.testing.assert_allclose(to_np(getattr(det_t, field)),
                               np.asarray(getattr(det_j, field)),
                               atol=FIELDS_ATOL[field], rtol=0)


def test_anchors():
    shapes, strides = [(24, 32), (12, 16), (6, 8)], (4, 8, 16)
    sizes = ((32,), (64,), (128,))
    got, counts = generate_anchors(shapes, strides, sizes, (0.5, 1.0, 2.0))
    want, jcounts = jgenerate_anchors(shapes, strides, sizes, (0.5, 1.0, 2.0))
    assert counts == jcounts
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


def test_select_proposals_excludes_padding_anchors(rng):
    """Padding-anchor exclusion and clip to valid_hw, per image, against the
    vmapped JAX function on random logits."""
    anchors, counts = generate_anchors([(24, 32), (12, 16)], (4, 8), ((32,), (64,)),
                                       (0.5, 1.0, 2.0))
    n = anchors.shape[0]
    obj = rng.normal(0, 3, (2, n)).astype(np.float32)
    deltas = rng.normal(0, 0.2, (2, n, 4)).astype(np.float32)
    hw = np.array([[96, 128], [60, 70]], np.int32)
    got = rpn.select_proposals(torch.from_numpy(obj), torch.from_numpy(deltas), anchors,
                               counts, torch.from_numpy(hw), pre_nms_top_n=300,
                               post_nms_top_n=100)
    want = jax.vmap(lambda o, d, h: jselect_proposals(
        o, d, jnp.asarray(to_np(anchors)), counts, h, pre_nms_top_n=300,
        post_nms_top_n=100))(obj, deltas, hw)
    np.testing.assert_array_equal(to_np(got[2]), np.asarray(want[2]))
    np.testing.assert_allclose(to_np(got[0]), np.asarray(want[0]), atol=1e-4, rtol=0)
    assert to_np(got[0])[1, :, 2].max() <= 70 and to_np(got[0])[1, :, 3].max() <= 60
