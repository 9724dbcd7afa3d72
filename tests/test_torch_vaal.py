"""The port's VAAL (``models/vae.py``, ``strategies/vaal.py``) against the
JAX package's on the CPU in float32, at small widths (base 8, z 16, 64x64
inputs): the VAE forward with the JAX normals injected, ``vae_loss``, the
discriminator, ``resize_for_vaal`` against ``jax.image.resize``, one
``VAALTrainer`` step pair (VAE then discriminator, SGD on the warmup +
multistep schedule) against the JAX trainer given optax SGD, the scores and
the selection. Each comparison states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cald_tpu.engine.optim import make_sgd as jmake_sgd
from cald_tpu.engine.schedules import multistep_with_warmup as jschedule
from cald_tpu.models.vae import VAAL_VAE as JVAE
from cald_tpu.models.vae import VAALDiscriminator as JDisc
from cald_tpu.models.vae import vae_loss as jvae_loss
from cald_tpu.strategies import vaal as jvaal
from cald_tpu_torch.convert.from_flax import VAE_TRANSPOSED, module_state_dict
from cald_tpu_torch.engine.optim import make_sgd
from cald_tpu_torch.engine.schedules import lr_scheduler, multistep_with_warmup
from cald_tpu_torch.models.vae import VAAL_VAE, VAALDiscriminator, vae_loss
from cald_tpu_torch.strategies.vaal import VAALTrainer, resize_for_vaal, vaal_select
from tests.torch_helpers import to_np

T = torch.from_numpy
Z, BASE, SIZE = 16, 8, 64


def _perturb_norms(params, rng):
    """GroupNorm scale/bias away from 1/0, so that the bridge's norm mapping
    is exercised."""
    out = {}
    for name, leaves in params.items():
        leaves = dict(leaves)
        if "norm" in name:
            leaves["scale"] = rng.uniform(0.7, 1.3, leaves["scale"].shape).astype(np.float32)
            leaves["bias"] = rng.normal(0, 0.1, leaves["bias"].shape).astype(np.float32)
        out[name] = leaves
    return out


@pytest.fixture(scope="module")
def vae_pair():
    rng = np.random.default_rng(4)
    jv = JVAE(z_dim=Z, base_width=BASE, start_hw=SIZE // 32)
    x = rng.uniform(0, 255, (3, SIZE, SIZE, 3)).astype(np.float32)
    params = jax.tree.map(np.asarray, jax.jit(jv.init)(jax.random.key(0), x,
                                                       jax.random.key(1))["params"])
    params = _perturb_norms(params, rng)
    tv = VAAL_VAE(z_dim=Z, base_width=BASE, start_hw=SIZE // 32)
    tv.load_state_dict(module_state_dict(params, transposed=VAE_TRANSPOSED), strict=True)
    return jv, params, tv, x


def test_vae_forward(vae_pair):
    """recon, z, mu and logvar with JAX's normals injected: atol 5e-5 on
    values of order 1-10 (the convolutions sum in another order)."""
    jv, params, tv, x = vae_pair
    key = jax.random.key(7)
    want = jv.apply({"params": params}, x, key)
    eps = np.array(jax.random.normal(key, want[2].shape))
    got = tv(T(x), T(eps))
    for name, g, w in zip(("recon", "z", "mu", "logvar"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=5e-5, err_msg=name)
    assert np.abs(np.asarray(want[0])).max() > 0.5


def test_vae_loss(rng):
    """rtol 1e-5; the KLD is the raw batch sum."""
    recon, x = (rng.normal(0, 50, (3, 8, 8, 3)).astype(np.float32) for _ in range(2))
    mu, logvar = (rng.normal(0, 1, (3, Z)).astype(np.float32) for _ in range(2))
    for beta in (1.0, 0.5):
        np.testing.assert_allclose(
            float(vae_loss(T(recon), T(x), T(mu), T(logvar), beta)),
            float(jvae_loss(recon, x, mu, logvar, beta)), rtol=1e-5)


def test_discriminator(rng):
    """Logits, atol 1e-5."""
    jd = JDisc()
    zs = rng.normal(0, 1, (5, Z)).astype(np.float32)
    params = jax.tree.map(np.asarray, jd.init(jax.random.key(2), zs)["params"])
    params = jax.tree.map(lambda p: p + np.float32(0.03) if p.ndim == 1 else p, params)
    td = VAALDiscriminator(z_dim=Z)
    td.load_state_dict(module_state_dict(params), strict=True)
    np.testing.assert_allclose(to_np(td(T(zs))), np.asarray(jd.apply({"params": params}, zs)),
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 640, 1024), (1, 203, 317), (2, 100, 150)],
                         ids=["canvas", "odd", "upsampled"])
def test_resize_for_vaal(rng, shape):
    """Against jax.image.resize (bilinear, antialiased when it shrinks) on
    0..255 images: atol 1e-3 (float32 sums of up to 9 taps a side)."""
    images = rng.uniform(0, 255, shape + (3,)).astype(np.float32)
    want = np.asarray(jvaal.resize_for_vaal(jnp.asarray(images)))
    got = resize_for_vaal(T(images))
    assert got.shape == (shape[0], 256, 256, 3)
    np.testing.assert_allclose(to_np(got), want, atol=1e-3)


# --------------------------------------------------------------------------
# one trainer step pair against the JAX trainer
# --------------------------------------------------------------------------

VAE_LR, D_LR, STEPS_PER_EPOCH = 1e-4, 1e-3, 2


def _trainers():
    jt = jvaal.VAALTrainer(
        z_dim=Z, base_width=BASE, image_size=SIZE, seed=3,
        vae_tx=jmake_sgd(jschedule(VAE_LR, STEPS_PER_EPOCH)),
        d_tx=jmake_sgd(jschedule(D_LR, STEPS_PER_EPOCH)))
    jt.vae_params = _perturb_norms(jax.tree.map(np.asarray, jt.vae_params),
                                   np.random.default_rng(5))

    def optimizers(vae, disc):
        vo, do = make_sgd(vae, VAE_LR), make_sgd(disc, D_LR)
        return (vo, lr_scheduler(vo, multistep_with_warmup(VAE_LR, STEPS_PER_EPOCH)),
                do, lr_scheduler(do, multistep_with_warmup(D_LR, STEPS_PER_EPOCH)))

    tt = VAALTrainer(optimizers, z_dim=Z, base_width=BASE, image_size=SIZE, device="cpu")
    tt.vae.load_state_dict(module_state_dict(jt.vae_params, transposed=VAE_TRANSPOSED),
                           strict=True)
    tt.disc.load_state_dict(module_state_dict(jax.tree.map(np.asarray, jt.d_params)),
                            strict=True)
    return jt, tt


class JaxNormals:
    """The trainer's ``Draw``: the normals the JAX step draws from
    ``split(key)`` (k1 for the labeled batch, k2 for the unlabeled one)."""

    def __init__(self, key):
        self.keys = jax.random.split(key)

    def __call__(self, i, shape, kind="uniform"):
        assert kind == "normal"
        return T(np.array(jax.random.normal(self.keys[i], shape)))


def _canvases(rng, b):
    images = np.zeros((b, 96, 128, 3), np.float32)
    images[:, :80, :110] = rng.uniform(0, 255, (b, 80, 110, 3))
    return images


def test_trainer_steps_match_jax(rng):
    """Two steps (warmup, then the full rate; momentum from the first):
    losses rtol 1e-4, and every parameter's change within 2e-3 of the
    largest change of its tensor (the gradients sum in another order)."""
    jt, tt = _trainers()
    before = {**{f"vae.{k}": v.clone() for k, v in tt.vae.state_dict().items()},
              **{f"d.{k}": v.clone() for k, v in tt.disc.state_dict().items()}}
    for step in range(2):
        lab, unlab = _canvases(rng, 3), _canvases(rng, 2)
        key = jax.random.key(10 + step)
        want = jt.train_step(lab, unlab, key)
        got = tt.train_step(T(lab), T(unlab), JaxNormals(key))
        np.testing.assert_allclose([float(g) for g in got], want, rtol=1e-4)
    want_sd = {**{f"vae.{k}": v for k, v in module_state_dict(
        jax.tree.map(np.asarray, jt.vae_params), transposed=VAE_TRANSPOSED).items()},
        **{f"d.{k}": v for k, v in module_state_dict(
            jax.tree.map(np.asarray, jt.d_params)).items()}}
    got_sd = {**{f"vae.{k}": v for k, v in tt.vae.state_dict().items()},
              **{f"d.{k}": v for k, v in tt.disc.state_dict().items()}}
    assert set(got_sd) == set(want_sd)
    for name, b in before.items():
        dw, dg = want_sd[name] - b, got_sd[name] - b
        assert dw.abs().max() > 0, name
        err = (dg - dw).abs().max()
        assert err <= 2e-3 * dw.abs().max() + 1e-9, (name, float(err), float(dw.abs().max()))
    assert [g["lr"] for g in tt.vae_opt.param_groups] == [pytest.approx(VAE_LR)]

    images = _canvases(rng, 4)
    want = jt.unlabeled_scores(images, jax.random.key(0))
    got = tt.unlabeled_scores(T(images))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got.min() >= -1.0 and got.max() <= 0.0


def test_vaal_select_matches_jax(rng):
    scores = -rng.integers(0, 4, 25) / 4.0                    # ties: stable order
    for budget in (0, 6, 25):
        np.testing.assert_array_equal(vaal_select(scores, budget),
                                      jvaal.vaal_select(scores, budget))
