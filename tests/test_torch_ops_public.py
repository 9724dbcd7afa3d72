"""The public box helpers and the single-level RoIAlign of the port
(``cald_tpu_torch.ops``) against the JAX package's on the CPU in float32,
from the same numpy inputs, and the package's public names against
``cald_tpu.ops``'s."""

import numpy as np
import pytest
import torch

import cald_tpu.ops as jops
from cald_tpu.ops import boxes as jboxes
from cald_tpu.ops.roi_align import roi_align as jroi_align
import cald_tpu_torch.ops as ops
from cald_tpu_torch.ops import boxes
from tests.test_ops_boxes import random_boxes
from tests.torch_helpers import to_np

T = torch.from_numpy


def _close(got, want, atol):
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=atol, rtol=0)


def test_public_names_match_jax():
    assert sorted(ops.__all__) == sorted(jops.__all__)
    for name in ops.__all__:
        assert hasattr(ops, name), name


def test_intersect_and_iou_one_vs_many(rng):
    """atol 1e-4 (areas of up to ~1e4 px^2) and 1e-6 (IoU); touching and
    disjoint boxes give 0."""
    b1 = np.stack([random_boxes(rng, 9) for _ in range(2)])
    b2 = np.stack([random_boxes(rng, 13) for _ in range(2)])
    b2[0, 0] = [b1[0, 0, 2], b1[0, 0, 1], b1[0, 0, 2] + 5, b1[0, 0, 3]]     # touching
    _close(boxes.intersect(T(b1), T(b2)), jboxes.intersect(b1, b2), 1e-4)
    one = b1[:, 0]
    want = np.asarray(jboxes.iou_one_vs_many(one, b2))
    _close(boxes.iou_one_vs_many(T(one), T(b2)), want, 1e-6)
    assert want[0, 0] == 0.0
    np.testing.assert_allclose(to_np(ops.iou_one_vs_many(T(one[0]), T(b2[0]))), want[0],
                               atol=1e-6)


@pytest.mark.parametrize("min_size", [0.0, 8.0, 30.0])
def test_remove_small_boxes_mask(rng, min_size):
    b = random_boxes(rng, 50)
    b[0] = [10, 10, 10 + min_size, 40]                 # exactly min_size wide: kept
    np.testing.assert_array_equal(to_np(boxes.remove_small_boxes_mask(T(b), min_size)),
                                  np.asarray(jboxes.remove_small_boxes_mask(b, min_size)))


@pytest.mark.parametrize("from_hw, to_hw", [((375, 500), (600, 800)), ((480, 640), (240, 320))])
def test_resize_boxes(rng, from_hw, to_hw):
    b = np.stack([random_boxes(rng, 7) for _ in range(3)])
    _close(boxes.resize_boxes(T(b), from_hw, to_hw), jboxes.resize_boxes(b, from_hw, to_hw), 1e-4)


@pytest.mark.parametrize("n, chunk, scale", [(5, 256, 0.25), (300, 64, 0.125)])
def test_roi_align_single_level(rng, n, chunk, scale):
    """(N, 7, 7, C) against the JAX roi_align, rois partly outside the
    level: atol 1e-5."""
    feat = rng.normal(0, 1, (24, 32, 8)).astype(np.float32)
    rois = random_boxes(rng, n, size=256.0)
    rois[0] = [-40.0, -30.0, 20.0, 10.0]
    got = ops.roi_align.roi_align(T(feat), T(rois), spatial_scale=scale, chunk_size=chunk)
    want = jroi_align(feat, rois, spatial_scale=scale, chunk_size=chunk)
    assert got.shape == (n, 7, 7, 8)
    _close(got, want, 1e-5)
