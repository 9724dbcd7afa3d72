"""The port's LL4AL CIFAR demo (``cald_tpu_torch.cifar``) against the JAX
package's on the CPU in float32: counterparts of tests/test_cifar.py (the
forward contract, BatchNorm statistics in train mode, augmentation, the
normalisation constants, the pickle reader and the slow learning test), and
parity on the same numpy inputs: synthetic data byte for byte, the pickle
reader, ``augment_batch`` with the JAX draws injected, the forward pass on
bridged weights, the BatchNorm running statistics and one joint step
against Flax + optax. Each comparison states its tolerance."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cald_tpu.cifar import CifarALConfig as JConfig
from cald_tpu.cifar import CifarLL4AL as JModel
from cald_tpu.cifar import CifarResNet18 as JResNet
from cald_tpu.cifar import augment_batch as jaugment
from cald_tpu.cifar import load_cifar10 as jload
from cald_tpu.cifar import normalize as jnormalize
from cald_tpu.cifar import synthetic_cifar as jsynthetic
from cald_tpu_torch.cifar import (
    CifarALConfig, CifarLL4AL, CifarResNet18, al_cifar_loop, augment_batch, augment_draws,
    load_cifar10, normalize, synthetic_cifar,
)
from cald_tpu_torch.convert.from_flax import module_state_dict
from tests.torch_helpers import to_np

T = torch.from_numpy


def _jax_draws(key, b):
    """The flips and crop offsets JAX's augment_batch draws from ``key``."""
    kf, kc = jax.random.split(key)
    return (T(np.array(jax.random.bernoulli(kf, 0.5, (b,)))),
            T(np.array(jax.random.randint(kc, (b, 2), 0, 9))).long())


def _bridge(params, batch_stats) -> dict:
    """Flax ``params`` + ``batch_stats`` of the CIFAR ResNet -> the port's
    state_dict."""
    sd = module_state_dict(params)

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, prefix + (k,))
            else:
                name = {"mean": "running_mean", "var": "running_var"}[k]
                yield ".".join(prefix + (name,)), T(np.array(v, np.float32))

    sd.update(walk(jax.tree.map(np.asarray, batch_stats), ()))
    return sd


def _port_resnet(params, batch_stats, **kw):
    model = CifarResNet18(**kw)
    missing, unexpected = model.load_state_dict(_bridge(params, batch_stats), strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing), missing
    return model


# --------------------------------------------------------------------------
# counterparts of tests/test_cifar.py
# --------------------------------------------------------------------------

def test_forward_contract():
    m = CifarResNet18(num_classes=10, width=8).eval()
    logits, feats = m(torch.zeros(2, 32, 32, 3))
    assert logits.shape == (2, 10)
    assert [tuple(f.shape[1:]) for f in feats] == [(8, 32, 32), (16, 16, 16), (32, 8, 8),
                                                   (64, 4, 4)]


def test_bn_stats_update_in_train_mode():
    m = CifarResNet18(num_classes=10, width=8)
    before = {k: v.clone() for k, v in m.state_dict().items() if "running" in k}
    m.train()(torch.ones(4, 32, 32, 3) * 100.0)
    after = m.state_dict()
    assert any(not torch.allclose(v, after[k]) for k, v in before.items())


def test_augment_shapes_and_range(rng):
    x = T(rng.uniform(0, 255, (4, 32, 32, 3)).astype(np.float32))
    out = augment_batch(x, *augment_draws(torch.Generator().manual_seed(0), 4))
    assert out.shape == x.shape
    assert float(out.min()) >= 0.0 and float(out.max()) <= 255.0


def test_normalize_reference_constants():
    n = to_np(normalize(torch.full((1, 2, 2, 3), 255.0)))
    want = (1.0 - np.array([0.4914, 0.4822, 0.4465])) / np.array([0.2023, 0.1994, 0.2010])
    np.testing.assert_allclose(n[0, 0, 0], want, rtol=1e-5)


def test_load_cifar10_batch_format(tmp_path):
    """The batch files written here read back as the JAX reader reads them."""
    d = tmp_path / "cifar-10-batches-py"
    os.makedirs(d)
    rng = np.random.default_rng(0)
    for name, n in [(f"data_batch_{i}", 4) for i in range(1, 6)] + [("test_batch", 6)]:
        payload = {b"data": rng.integers(0, 256, (n, 3072), np.uint8),
                   b"labels": list(rng.integers(0, 10, n))}
        with open(d / name, "wb") as f:
            pickle.dump(payload, f)
    got, want = load_cifar10(str(tmp_path)), jload(str(tmp_path))
    xtr, ytr, xte, yte = got
    assert xtr.shape == (20, 32, 32, 3) and ytr.shape == (20,)
    assert xte.shape == (6, 32, 32, 3) and yte.shape == (6,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------
# parity with the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"num_train": 40, "num_test": 12, "num_classes": 3,
                                     "seed": 5}])
def test_synthetic_cifar_byte_for_byte(kw):
    for g, w in zip(synthetic_cifar(**kw), jsynthetic(**kw)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_augment_and_normalize_match_jax(rng, seed):
    """The JAX flips and offsets injected: the crops exactly equal; the
    normalisation within 1e-6."""
    x = rng.uniform(0, 255, (6, 32, 32, 3)).astype(np.float32)
    key = jax.random.key(seed)
    got = augment_batch(T(x), *_jax_draws(key, 6))
    np.testing.assert_array_equal(to_np(got), np.asarray(jaugment(jnp.asarray(x), key)))
    np.testing.assert_allclose(to_np(normalize(got)), np.asarray(jnormalize(jnp.asarray(
        to_np(got)))), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def flax_resnet():
    jm = JResNet(num_classes=10, width=8)
    x = np.random.default_rng(3).normal(0, 1, (8, 32, 32, 3)).astype(np.float32)
    v = jax.jit(lambda k, x: jm.init(k, x, train=False))(jax.random.key(0), x)
    # non-trivial norms, so the bridge's mapping is exercised
    r = np.random.default_rng(4)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (r.uniform(0.7, 1.3, a.shape).astype(np.float32) if p[-1].key == "scale"
                      else r.normal(0, 0.1, a.shape).astype(np.float32) if p[-1].key == "bias"
                      else np.asarray(a)), v["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (r.uniform(0.5, 1.5, a.shape) if p[-1].key == "var"
                      else r.normal(0, 0.2, a.shape)).astype(np.float32), v["batch_stats"])
    return jm, params, stats, x


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_flax(flax_resnet, train):
    """Logits and the four stage outputs within 1e-4 of their largest
    magnitude; in train mode the running statistics after the update within
    1e-5 (Flax keeps 0.9 of the old value and takes the biased batch
    variance)."""
    jm, params, stats, x = flax_resnet
    if train:
        (jl, jf), upd = jm.apply({"params": params, "batch_stats": stats}, x, train=True,
                                 mutable=["batch_stats"])
    else:
        jl, jf = jm.apply({"params": params, "batch_stats": stats}, x, train=False)
    model = _port_resnet(params, stats, width=8).train(train)
    with torch.no_grad():
        tl, tf = model(T(x))
    for g, w in zip([tl] + [f.permute(0, 2, 3, 1) for f in tf], [jl] + list(jf)):
        w = np.asarray(w)
        np.testing.assert_allclose(to_np(g), w, atol=1e-4 * np.abs(w).max(), rtol=0)
    if train:
        want = _bridge(params, upd["batch_stats"])
        got = model.state_dict()
        n = 0
        for k, w in want.items():
            if "running" in k:
                n += 1
                np.testing.assert_allclose(to_np(got[k]), to_np(w), atol=1e-5, rtol=0,
                                           err_msg=k)
        assert n == 2 * 20


def test_joint_step_matches_flax_optax():
    """One CifarLL4AL step (width 8, interm 16, batch 8) against the JAX
    package's jitted step on the same weights, images, labels and
    augmentation draws: losses rtol 1e-5; every parameter's change within
    1e-4 of the largest change of its network (the two agree to 2e-5 of
    it; the gradients reach the stem through eight BatchNorm backwards,
    whose float32 sums lose more in small tensors such as the stem's
    biases); the running statistics within 1e-5."""
    cfg = dict(batch=8, width=8, interm_dim=16, lr=0.05, epochs=2, milestones=(1,))
    jmodel = JModel(JConfig(**cfg), steps_per_epoch=1)
    model = CifarLL4AL(CifarALConfig(**cfg), steps_per_epoch=1, device="cpu")
    model.backbone.load_state_dict(_bridge(jax.tree.map(np.asarray, jmodel.params),
                                           jmodel.bn_stats), strict=False)
    model.lossnet.load_state_dict(module_state_dict(jax.tree.map(np.asarray,
                                                                 jmodel.ll_params)))
    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (8, 32, 32, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, 8).astype(np.int32)
    key = jax.random.key(9)
    out = jmodel._train_step(jmodel.params, jmodel.ll_params, jmodel.bn_stats, jmodel.opt,
                             jmodel.ll_opt, jnp.asarray(images), jnp.asarray(labels), key,
                             detach=False)
    params, ll_params, bn_stats, metrics = out[0], out[1], out[2], out[5]
    got = model.train_step(T(images), T(labels), *_jax_draws(key, 8), detach=False)
    for k in ("loss", "ce", "module"):
        np.testing.assert_allclose(float(got[k]), float(metrics[k]), rtol=1e-5, err_msg=k)
    before = (_bridge(jax.tree.map(np.asarray, jmodel.params), jmodel.bn_stats),
              module_state_dict(jax.tree.map(np.asarray, jmodel.ll_params)))
    for net, b, want in ((model.backbone, before[0],
                          _bridge(jax.tree.map(np.asarray, params), bn_stats)),
                         (model.lossnet, before[1],
                          module_state_dict(jax.tree.map(np.asarray, ll_params)))):
        sd = net.state_dict()
        scale = max(float((w - b[k]).abs().max()) for k, w in want.items() if "running" not in k)
        assert scale > 0
        for k, w in want.items():
            tol = 1e-5 if "running" in k else 1e-4 * scale
            np.testing.assert_allclose(to_np(sd[k]), to_np(w), atol=tol, rtol=0, err_msg=k)
    assert model.opt.param_groups[0]["lr"] == pytest.approx(0.005)     # the milestone


def test_al_cifar_loop_grows_by_addendum():
    """Two cycles of one epoch at a tiny width on the CPU: the labeled set
    grows by ``addendum`` from the JAX loop's permutation, accuracy is a
    percentage, and the loop refuses the card where there is none."""
    xtr, ytr, xte, yte = synthetic_cifar(num_train=64, num_test=16, seed=1)
    cfg = CifarALConfig(num_train=64, batch=16, subset=32, addendum=16, cycles=2, epochs=1,
                        width=4, interm_dim=8, seed=2)
    lines = []
    hist = al_cifar_loop(cfg, xtr, ytr, xte, yte, print_fn=lines.append, device="cpu")
    assert [h["labeled"] for h in hist] == [16, 32]
    assert all(0.0 <= h["acc"] <= 100.0 for h in hist) and len(lines) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            al_cifar_loop(cfg, xtr, ytr, xte, yte, print_fn=lines.append)


@pytest.mark.slow
def test_al_cifar_loop_learns_and_selects():
    """tests/test_cifar.py's mini end-to-end: 2 cycles on trivially
    learnable synthetic data; the labeled set grows by ADDENDUM and test
    accuracy beats 50% after cycle 2."""
    xtr, ytr, xte, yte = synthetic_cifar(num_train=512, num_test=128, seed=0)
    cfg = CifarALConfig(num_train=512, batch=64, subset=256, addendum=128, trials=1, cycles=2,
                        epochs=8, milestones=(6,), epoch_loss=4, width=16, interm_dim=16,
                        lr=0.05, seed=0)
    hist = al_cifar_loop(cfg, xtr, ytr, xte, yte, print_fn=lambda *a: None, device="cpu")
    assert [h["labeled"] for h in hist] == [128, 256]
    assert hist[-1]["acc"] > 50.0
