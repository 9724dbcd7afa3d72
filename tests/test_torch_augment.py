"""The port's CALD augmentations against the JAX package's, on the CPU in
float32: flip, resize, rotation (the two-pass shear) and cutout with the JAX
draws injected, then the whole augmented batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cald_tpu.augment.cutout import cutout as jcutout
from cald_tpu.augment.geometry import horizontal_flip as jflip
from cald_tpu.augment.geometry import resize_image_boxes as jresize
from cald_tpu.augment.geometry import rotate_image_boxes as jrotate
from cald_tpu.augment.suite import build_aug_batch as jbuild_aug_batch
from cald_tpu_torch.augment import cutout, geometry, suite
from tests.torch_helpers import to_np

T = torch.from_numpy
# pixel values are 0..255: the matmul passes sum in another order
PIX_ATOL = 1e-3


@pytest.fixture
def batch(rng):
    """Two images on a 96x128 canvas (the second padded) with boxes."""
    images = rng.uniform(0, 255, (2, 96, 128, 3)).astype(np.float32)
    hw = np.array([[96, 128], [70, 100]], np.int32)
    images[1, 70:] = 0.0
    images[1, :, 100:] = 0.0
    xy = rng.uniform(0, 60, (2, 6, 2))
    wh = rng.uniform(8, 40, (2, 6, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.ones((2, 6), bool)
    valid[1, 4:] = False
    return images, boxes, valid, hw


def _check(got, want, atol=PIX_ATOL):
    (gi, gb, gh), (wi, wb, wh) = got, want
    np.testing.assert_allclose(to_np(gi), np.asarray(wi), atol=atol, rtol=0)
    np.testing.assert_allclose(to_np(gb), np.asarray(wb), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(to_np(gh), np.asarray(wh))


def test_flip(batch):
    images, boxes, _, hw = batch
    _check(geometry.horizontal_flip(T(images), T(boxes), T(hw)),
           jax.vmap(jflip)(images, boxes, hw), atol=0)


@pytest.mark.parametrize("ratio", [0.8, 0.7])
def test_resize(batch, ratio):
    images, boxes, _, hw = batch
    _check(geometry.resize_image_boxes(T(images), T(boxes), T(hw), ratio),
           jax.vmap(lambda i, b, h: jresize(i, b, h, ratio))(images, boxes, hw))


@pytest.mark.parametrize("angle", [5.0, -10.0])
def test_rotation(batch, angle):
    images, boxes, _, hw = batch
    _check(geometry.rotate_image_boxes(T(images), T(boxes), T(hw), angle),
           jax.vmap(lambda i, b, h: jrotate(i, b, h, angle))(images, boxes, hw))


def test_rotation_odd_canvas(rng):
    """A canvas whose sides are not multiples of 16 takes the per-line path."""
    images = rng.uniform(0, 255, (1, 90, 120, 3)).astype(np.float32)
    boxes = np.array([[[10.0, 12.0, 50.0, 60.0]]], np.float32)
    hw = np.array([[90, 120]], np.int32)
    _check(geometry.rotate_image_boxes(T(images), T(boxes), T(hw), 5.0),
           jax.vmap(lambda i, b, h: jrotate(i, b, h, 5.0))(images, boxes, hw))


@pytest.mark.parametrize("cut_num", [1, 2, 4])
def test_cutout_with_jax_draws(batch, cut_num):
    images, boxes, valid, hw = batch
    keys = jax.random.split(jax.random.key(5), 2)
    u = np.array(jax.vmap(lambda k: jax.random.uniform(k, (50, 4)))(keys))
    want = jax.vmap(lambda i, b, v, h, k: jcutout(i, b, v, h, k, cut_num=cut_num))(
        images, boxes, valid, hw, keys)
    got = cutout.cutout(T(images), T(boxes), T(valid), T(hw), T(u), cut_num=cut_num)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    assert ((to_np(got) != images).reshape(2, -1).sum(1) > 0).all(), "nothing was cut"


def test_build_aug_batch_fcdr(batch):
    images, boxes, valid, hw = batch
    key = jax.random.key(11)
    names = suite.expand_aug_string("FCDR")

    def draw(i, shape):
        keys = jax.random.split(jax.random.fold_in(key, i), shape[0])
        return T(np.array(jax.vmap(lambda k: jax.random.uniform(k, shape[1:]))(keys)))

    got = suite.build_aug_batch(T(images), T(boxes), T(valid), T(hw), names, draw)
    want = jbuild_aug_batch(jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(valid),
                            jnp.asarray(hw), key, names)
    assert names == ["flip", "cut_out", "smaller_resize", "rotation"]
    assert got[0].shape == (2, 4, 96, 128, 3)
    _check(got, want)
