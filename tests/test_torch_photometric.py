"""The port's photometric augmentations and the rest of the aug protocol
against the JAX package's, on the CPU in float32, with the JAX draws
injected: gaussian noise, salt-pepper, color swap and color adjust, every
name ``_aug_fn`` accepts, the ``multi_*`` families, and the whole augmented
batch of 'FCDRGS'."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cald_tpu.augment import photometric as jphoto
from cald_tpu.augment.suite import build_aug_batch as jbuild_aug_batch
from cald_tpu.augment.suite import expand_aug_string as jexpand_aug_string
from cald_tpu.augment.suite import expand_multi as jexpand_multi
from cald_tpu_torch.augment import photometric, suite
from tests.test_torch_augment import PIX_ATOL, _check
from tests.torch_helpers import to_np

T = torch.from_numpy


@pytest.fixture
def batch(rng):
    """Two images on a 96x128 canvas (the second padded) with boxes; pixels
    in 10..245, so the padding's 0 is below every valid pixel."""
    images = rng.uniform(10, 245, (2, 96, 128, 3)).astype(np.float32)
    hw = np.array([[96, 128], [70, 100]], np.int32)
    images[1, 70:] = 0.0
    images[1, :, 100:] = 0.0
    xy = rng.uniform(0, 60, (2, 6, 2))
    wh = rng.uniform(8, 40, (2, 6, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.ones((2, 6), bool)
    valid[1, 4:] = False
    return images, boxes, valid, hw


def _keys(seed, n=2):
    return jax.random.split(jax.random.key(seed), n)


def _padding_untouched(got, images):
    np.testing.assert_array_equal(to_np(got)[1, 70:], images[1, 70:])
    np.testing.assert_array_equal(to_np(got)[1, :, 100:], images[1, :, 100:])


@pytest.mark.parametrize("std", [8.0, 16.0, 48.0])
def test_gaussian_noise_with_jax_normals(batch, std):
    """atol 1e-4: the same normals times std added to 0..255 pixels."""
    images, _, _, hw = batch
    keys = _keys(1)
    normals = np.array(jax.vmap(lambda k: jax.random.normal(k, images.shape[1:]))(keys))
    want = jax.vmap(lambda i, h, k: jphoto.gaussian_noise(i, h, k, std))(images, hw, keys)
    got = photometric.gaussian_noise(T(images), T(hw), T(normals), std)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4, rtol=0)
    _padding_untouched(got, images)
    assert to_np(got).max() > 255.0, "the noise is not clamped"


@pytest.mark.parametrize("prob", [0.1, 0.3])
def test_salt_pepper_with_jax_uniforms(batch, prob):
    """Exact. Salt and pepper are the max and min of each image's valid
    region: the padding's 0 never becomes the pepper value."""
    images, _, _, hw = batch
    keys = _keys(2)
    u = np.array(jax.vmap(lambda k: jax.random.uniform(k, images.shape[1:]))(keys))
    want = jax.vmap(lambda i, h, k: jphoto.salt_pepper_noise(i, h, k, prob))(images, hw, keys)
    got = photometric.salt_pepper_noise(T(images), T(hw), T(u), prob)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    _padding_untouched(got, images)
    valid1 = images[1, :70, :100]
    pepper = (u[1, :70, :100] > 1 - prob / 2)
    assert pepper.any()
    np.testing.assert_array_equal(to_np(got)[1, :70, :100][pepper], valid1.min())
    assert valid1.min() >= 10.0


def test_color_swap_with_jax_index(batch):
    """Exact, for JAX's randint index and for every one of the 6 orders."""
    images, _, _, hw = batch
    keys = _keys(3)
    idx = np.array(jax.vmap(lambda k: jax.random.randint(k, (), 0, 6))(keys))
    want = jax.vmap(jphoto.color_swap)(images, hw, keys)
    got = photometric.color_swap(T(images), T(hw), T(idx))
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    _padding_untouched(got, images)
    for i, perm in enumerate(photometric.PERMS):
        got = to_np(photometric.color_swap(T(images), T(hw), torch.tensor([i, i])))
        np.testing.assert_array_equal(got[0], images[0][..., list(perm)])


def _color_adjust_f64(images, hw, f):
    """The JAX package's color_adjust transcribed in float64 NumPy."""
    gray_w = np.array([0.2989, 0.587, 0.114])
    out = np.empty(images.shape)
    for b, (h, w) in enumerate(hw):
        im = images[b].astype(np.float64)
        x = np.clip(im * f, 0, 255)
        mean = (x[:h, :w] @ gray_w).mean()
        x = np.clip(f * x + (1 - f) * mean, 0, 255)
        x = np.clip(f * x + (1 - f) * (x @ gray_w)[..., None], 0, 255)
        out[b] = im
        out[b, :h, :w] = x[:h, :w]
    return out


def color_atol(factor: float) -> float:
    """The JAX package sums the contrast mean's grays in float32 in an order
    of its own (1.4e-3 from the exact mean at factor 5 on this batch; the
    port's sum 7e-5), and the contrast and saturation blends scale a mean's
    error by f (f - 1): PIX_ATOL * max(1, 2 f (f - 1))."""
    return PIX_ATOL * max(1.0, 2 * factor * (factor - 1))


@pytest.mark.parametrize("factor", [0.5, 1.5, 2.0, 3.0, 4.0, 5.0])
def test_color_adjust(batch, factor):
    """Against the JAX package and a float64 transcription of its formula,
    at ``color_atol``: JAX is 2.5e-2 from the port at factor 5 and 4.4e-4
    at factor 2, the float64 values 1.5e-3 and 1e-4."""
    images, _, _, hw = batch
    want = jax.vmap(lambda i, h: jphoto.color_adjust(i, h, factor))(images, hw)
    got = photometric.color_adjust(T(images), T(hw), factor)
    np.testing.assert_allclose(to_np(got), _color_adjust_f64(images, hw, factor),
                               atol=color_atol(factor), rtol=0)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=color_atol(factor), rtol=0)
    _padding_untouched(got, images)


def jax_draw(key):
    """A port ``Draw`` that gives JAX's draws of augmentation i: one per
    image, from ``split(fold_in(key, i), B)`` as ``build_aug_batch`` splits
    them; a (B,) request is color swap's, answered with the uniform whose
    floor(6u) is JAX's randint index."""
    def draw(i, shape, kind="uniform"):
        keys = jax.random.split(jax.random.fold_in(key, i), shape[0])
        if len(shape) == 1:
            idx = np.array(jax.vmap(lambda k: jax.random.randint(k, (), 0, 6))(keys))
            return T(((idx + 0.5) / 6).astype(np.float32))
        fn = jax.random.normal if kind == "normal" else jax.random.uniform
        return T(np.array(jax.vmap(lambda k: fn(k, shape[1:]))(keys)))
    return draw


def _both(batch, names, seed=11):
    images, boxes, valid, hw = batch
    key = jax.random.key(seed)
    got = suite.build_aug_batch(T(images), T(boxes), T(valid), T(hw), names, jax_draw(key))
    want = jbuild_aug_batch(jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(valid),
                            jnp.asarray(hw), key, names)
    return got, want


@pytest.mark.parametrize("name", [
    "flip", "cut_out", "cut_out:3", "smaller_resize", "smaller_resize:0.7", "larger_resize",
    "resize:0.7", "rotation", "rotation:10", "ga", "ga:24", "sp", "sp:0.15", "color_adjust",
    "color_adjust:2", "color_swap"])
def test_every_aug_name_matches_jax(batch, name):
    """Each name of the JAX package's ``_aug_fn``, with its default or its
    parameter, alone through build_aug_batch with JAX's draws: pixels at
    PIX_ATOL (1e-4 for the noise, exact for the rest of the photometric
    ones through their unit tests above), boxes 1e-4, valid sizes exact."""
    got, want = _both(batch, [name])
    _check(got, want)


def test_multi_names_raise_and_unknown_names_raise(batch):
    images, boxes, valid, hw = batch
    for name, match in (("multi_ga", "expand_multi"), ("blur", "unknown")):
        with pytest.raises(ValueError, match=match):
            suite.build_aug_batch(T(images), T(boxes), T(valid), T(hw), [name],
                                  jax_draw(jax.random.key(0)))


@pytest.mark.parametrize("family", ["multi_ga", "multi_sp", "multi_cut_out", "multi_resize",
                                    "multi_color_adjust"])
def test_expand_multi_matches_jax(batch, family):
    """The family's names equal JAX's, and the expanded batch matches."""
    names = suite.expand_multi(family)
    assert names == jexpand_multi(family)
    got, want = _both(batch, names)
    _check(got, want, atol=color_atol(5.0) if family == "multi_color_adjust" else PIX_ATOL)


def test_expand_multi_unknown_raises():
    with pytest.raises(ValueError):
        suite.expand_multi("multi_blur")


def test_build_aug_batch_fcdrgs_order_and_draws(batch):
    """The full protocol: 'G' runs between flip and cut_out, 'S' last, each
    with JAX's draws of its index; a wrong order would change the augs
    (and CALD's consistency) without any error."""
    names = suite.expand_aug_string("FCDRGS")
    assert names == jexpand_aug_string("FCDRGS") == [
        "flip", "ga", "cut_out", "smaller_resize", "rotation", "sp"]
    got, want = _both(batch, names)
    assert got[0].shape == (2, 6, 96, 128, 3)
    _check(got, want)
    # the noise differs from aug to aug: each index has draws of its own
    assert not torch.equal(got[0][:, 1], got[0][:, 5])
