"""The whole scoring slice: the port's CALD score fn against
``cald_tpu.strategies.make_cald_score_fn`` on the tiny model, with the JAX
package's cutout draws injected, then the selection; plus the pieces around
it (subsampling, score_pool, the NumPy selectors)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cald_tpu.strategies import cald as jcald
from cald_tpu_torch.strategies import cald
from tests.torch_helpers import TINY, tiny_images, tiny_models, to_np

KEY_SEED = 3


def jax_draw(key):
    """The uniforms ``build_aug_batch`` derives for augmentation i: one
    ``uniform(shape[1:])`` per image on ``split(fold_in(key, i), b)``."""
    def draw(i, shape):
        keys = jax.random.split(jax.random.fold_in(key, i), shape[0])
        return torch.from_numpy(np.array(jax.vmap(
            lambda k: jax.random.uniform(k, shape[1:]))(keys)))
    return draw


@pytest.fixture(scope="module")
def scored():
    jmodel, variables, tmodel = tiny_models()
    images, valid_hw = tiny_images()
    key = jax.random.key(KEY_SEED)
    jfn = jcald.make_cald_score_fn(jmodel, jcald.CALDConfig(k_ref=8), TINY["num_classes"])
    cj, rj = jfn(variables, jnp.asarray(images), jnp.asarray(valid_hw), key)
    tfn = cald.make_cald_score_fn(tmodel, cald.CALDConfig(k_ref=8), TINY["num_classes"])
    ct, rt = tfn(torch.from_numpy(images), torch.from_numpy(valid_hw), jax_draw(key))
    return (np.asarray(cj), np.asarray(rj)), (to_np(ct), to_np(rt)), tfn


def test_consistency_matches(scored):
    (cj, _), (ct, _), _ = scored
    assert (cj > 0).all(), "degenerate fixture"
    np.testing.assert_allclose(ct, cj, atol=1e-4, rtol=0)


def test_cls_corrs_match(scored):
    (_, rj), (_, rt), _ = scored
    np.testing.assert_allclose(rt, rj, atol=1e-3, rtol=0)


@pytest.mark.parametrize("mutual", [True, False])
def test_selection_matches(scored, mutual):
    """The port's cald_select on the port's scores picks what the JAX
    package's picks on its own scores (a pool of 4: the two images twice,
    the copies nudged so no consistency ties)."""
    (cj, rj), (ct, rt), _ = scored
    nudge = np.array([0.0, 0.0, 0.01, 0.01])
    labeled = np.array([1.0, 0.5, 2.0])
    cfg_j = jcald.CALDConfig(no_mutual=not mutual)
    cfg_t = cald.CALDConfig(no_mutual=not mutual)
    want = jcald.cald_select(np.tile(cj, 2) + nudge, np.tile(rj, (2, 1)), labeled, 2, cfg_j)
    got = cald.cald_select(np.tile(ct, 2) + nudge, np.tile(rt, (2, 1)), labeled, 2, cfg_t)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 5, 41, 100])
def test_subsample_reference(rng, n):
    k, c = 100, 4
    boxes = rng.uniform(0, 50, (1, k, 4)).astype(np.float32)
    scores = np.sort(rng.uniform(size=(1, k)).astype(np.float32))[:, ::-1].copy()
    labels = rng.integers(1, c, (1, k)).astype(np.int32)
    scls = rng.uniform(size=(1, k, c)).astype(np.float32)
    pm = rng.uniform(size=(1, k)).astype(np.float32)
    valid = np.arange(k)[None] < n
    args = (boxes, scores, labels, scls, pm, valid)
    got = cald.subsample_reference(*map(torch.from_numpy, args), k_ref=50, threshold=40)
    want = jax.vmap(lambda *a: jcald.subsample_reference(*a, k_ref=50, threshold=40))(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


def test_score_pool_dedups_and_aligns(scored):
    """score_pool drives the score fn over batches with numpy fields and maps
    results back to pool positions; a padded duplicate entry is harmless."""
    _, (ct, rt), tfn = scored
    images, valid_hw = tiny_images()
    batches = [types.SimpleNamespace(images=images, valid_hw=valid_hw,
                                     image_idx=np.array([11, 12])),
               types.SimpleNamespace(images=images[::-1].copy(),
                                     valid_hw=valid_hw[::-1].copy(),
                                     image_idx=np.array([13, 13]))]
    gen = torch.Generator().manual_seed(0)
    cons, corrs = cald.score_pool(tfn, batches, [13, 11, 12], gen)
    assert cons.shape == (3,) and corrs.shape == (3, TINY["num_classes"] - 1)
    assert np.isfinite(cons).all() and (cons >= 0).all() and (cons <= 1).all()
    with pytest.raises(RuntimeError):
        cald.score_pool(tfn, batches[:1], [11, 12, 99], gen)


@pytest.mark.parametrize("uniform", [False, True])
def test_cls_kldiv_rank_matches(rng, uniform):
    corrs = rng.uniform(size=(12, 5))
    corrs[3] = 0.0
    labeled = rng.uniform(0, 3, 5)
    np.testing.assert_array_equal(
        cald.cls_kldiv_rank(corrs, labeled, 6, uniform=uniform),
        jcald.cls_kldiv_rank(corrs, labeled, 6, uniform=uniform))
