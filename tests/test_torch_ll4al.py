"""The port's LL4AL (``models/lossnet.py``, ``strategies/ll4al.py``) against
the JAX package's on the CPU in float32: LossNet's forward, the ranking loss,
the joint detector + LossNet step with the JAX package's sampling draws
injected (losses and every gradient against ``jax.grad`` of the step's loss,
with and without detached features), the scoring function and the selection.
Each comparison states its tolerance."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cald_tpu.engine.state import TrainState
from cald_tpu.models.lossnet import LossNet as JLossNet
from cald_tpu.models.lossnet import loss_pred_loss as jloss_pred_loss
from cald_tpu.strategies import ll4al as jll4al
from cald_tpu_torch.convert.from_flax import flax_to_state_dict, module_state_dict
from cald_tpu_torch.models.faster_rcnn import FasterRCNN, FasterRCNNConfig
from cald_tpu_torch.models.lossnet import LossNet, loss_pred_loss
from cald_tpu_torch.strategies.ll4al import (
    ll_select, make_ll_score_fn, make_ll_train_step,
)
from tests.test_torch_train import JaxDraws, _gt
from tests.torch_helpers import TINY, TINY_TRAIN, tiny_images, tiny_models, to_np

T = torch.from_numpy
LL_WEIGHT = 0.5                      # the CLI's --ll-weight default


def _levels(rng, b, shapes, c):
    return [rng.normal(0, 1, (b, h, w, c)).astype(np.float32) for h, w in shapes]


def _lossnet_pair(feats_nhwc, interm=8, seed=0):
    jnet = JLossNet(num_levels=len(feats_nhwc), interm_dim=interm)
    params = jax.tree.map(np.asarray, jnet.init(jax.random.key(seed), feats_nhwc)["params"])
    # non-zero biases, so that the bridge's bias mapping is exercised
    params = jax.tree.map(lambda p: p + np.float32(0.05) if p.ndim == 1 else p, params)
    tnet = LossNet(num_levels=len(feats_nhwc), interm_dim=interm,
                   in_channels=feats_nhwc[0].shape[-1])
    tnet.load_state_dict(module_state_dict(params), strict=True)
    return jnet, params, tnet


def _nchw(f):
    return T(np.ascontiguousarray(np.asarray(f).transpose(0, 3, 1, 2)))


def test_lossnet_forward(rng):
    """float32 levels: atol 1e-5."""
    feats = _levels(rng, 4, [(16, 16), (8, 8), (4, 4), (2, 2)], 16)
    jnet, params, tnet = _lossnet_pair(feats)
    want = jnet.apply({"params": params}, feats)
    got = tnet([_nchw(f) for f in feats])
    assert got.shape == (4,)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)


def test_lossnet_forward_bf16_pools_then_promotes(rng):
    """bf16 levels: the pool rounds to bf16 and the Dense layers run in
    float32 on both sides; atol 1e-5 (the pooled bf16 values agree)."""
    feats = [f.astype(jnp.bfloat16) for f in _levels(rng, 4, [(16, 16), (8, 8)], 16)]
    jnet, params, tnet = _lossnet_pair(feats)
    want = jnet.apply({"params": params}, feats)
    got = tnet([_nchw(f.astype(np.float32)).to(torch.bfloat16) for f in feats])
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)


def test_loss_pred_loss_reference_values():
    """The JAX test's hand-computed value (tests/test_models.py), rtol 1e-6."""
    pred = torch.tensor([10.0, 8.0, 0.0, -10.0])
    target = torch.tensor([5.0, 4.0, 1.0, 0.0])
    pdiff = np.array([10.0 - (-10.0), 8.0 - 0.0])
    tdiff = np.array([5.0 - 0.0, 4.0 - 1.0])
    expect = np.clip(1.0 - np.where(tdiff > 0, 1, -1) * pdiff, 0, None).sum() / 2
    np.testing.assert_allclose(float(loss_pred_loss(pred, target)), expect, rtol=1e-6)


@pytest.mark.parametrize("b", [1, 5, 6])
def test_loss_pred_loss_matches_jax(rng, b):
    """Even and odd batches (the odd one leaves its last entry out): atol 1e-6."""
    pred = rng.normal(0, 1, b).astype(np.float32)
    target = rng.uniform(0, 3, b).astype(np.float32)
    target[0] = target[-1]                        # a tie: sign -1, as in JAX
    for margin in (1.0, 0.3):
        np.testing.assert_allclose(
            float(loss_pred_loss(T(pred), T(target), margin=margin)),
            float(jloss_pred_loss(pred, target, margin=margin)), atol=1e-6)


def test_loss_pred_loss_target_gets_no_gradient():
    pred = torch.tensor([1.0, 0.5, -0.2, 0.3], requires_grad=True)
    target = torch.tensor([2.0, 1.0, 0.5, 3.0], requires_grad=True)
    loss_pred_loss(pred, target).backward()
    assert target.grad is None and pred.grad.abs().sum() > 0


# --------------------------------------------------------------------------
# the joint step, tiny detector with the JAX CLI's tiny training counts
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def joint():
    jm, variables, _ = tiny_models(**TINY_TRAIN)
    images, hw = tiny_images()
    gt, gl, gv = _gt(np.random.default_rng(11), g=8)
    rng_key = jax.random.key(5)
    key = jm.apply(variables, method=lambda m: m.make_rng("sampling"),
                   rngs={"sampling": rng_key})
    draws = JaxDraws({0: jax.random.split(jax.random.fold_in(key, 0), 2),
                      2: jax.random.split(jax.random.fold_in(key, 1), 2)})
    jnet = JLossNet(num_levels=4)
    feats = jm.apply(variables, jnp.asarray(images), jnp.asarray(hw),
                     method="extract_features")
    ll_params = jax.tree.map(np.asarray, jnet.init(jax.random.key(1), feats[:4])["params"])
    j = types.SimpleNamespace(jm=jm, variables=variables, images=images, hw=hw,
                              gt=(gt, gl, gv), rng_key=rng_key, draws=draws, jnet=jnet,
                              ll_params=ll_params, grads={})

    def value_and_grad(detach: bool):
        """((total, aux), (task grads, LossNet grads)) of the JAX loss, once."""
        if detach not in j.grads:
            j.grads[detach] = jax.jit(jax.value_and_grad(
                _jax_loss(j, detach), argnums=(0, 1), has_aux=True))(
                j.variables["params"], j.ll_params)
        return j.grads[detach]

    j.value_and_grad = value_and_grad
    return j


def _jax_loss(j, detach: bool):
    """The loss of ``cald_tpu.strategies.ll4al.make_ll_train_step``."""
    def loss_fn(task_params, ll_params):
        losses, pyramid = j.jm.apply(
            {"params": task_params, "frozen": j.variables["frozen"]}, jnp.asarray(j.images),
            jnp.asarray(j.hw), *j.gt, method="loss", per_image=True,
            rngs={"sampling": j.rng_key})
        per_image = sum(losses.values())
        feats = pyramid[:4]
        if detach:
            feats = [jax.lax.stop_gradient(f) for f in feats]
        ll = jloss_pred_loss(j.jnet.apply({"params": ll_params}, feats), per_image)
        task_loss = jnp.mean(per_image)
        return task_loss + LL_WEIGHT * ll, {"task_loss": task_loss, "ll_loss": ll}
    return loss_fn


def _port_step(j, detach: bool, ll_weight: float = LL_WEIGHT):
    model = FasterRCNN(FasterRCNNConfig(**TINY, **TINY_TRAIN))
    model.load_state_dict(flax_to_state_dict(j.variables), strict=True)
    lossnet = LossNet(num_levels=4)
    lossnet.load_state_dict(module_state_dict(j.ll_params), strict=True)
    # lr 0: the step leaves the parameters as they are and their .grad set
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    ll_opt = torch.optim.SGD(lossnet.parameters(), lr=0.0)
    step = make_ll_train_step(model, lossnet, opt, ll_opt, ll_weight=ll_weight)
    batch = [T(a) for a in (j.images, j.hw, *j.gt)]
    metrics = step(*batch, j.draws, detach_features=detach)
    return model, lossnet, metrics


def _close_grads(module, want: dict):
    """Every gradient within 5e-4 of its tensor's largest entry, as
    tests/test_torch_train.py holds FasterRCNN.loss's."""
    names = [n for n, _ in module.named_parameters()]
    assert set(want) == set(names)
    for name, p in module.named_parameters():
        w = want[name].numpy()
        err = np.abs(to_np(p.grad) - w).max()
        assert err <= 5e-4 * np.abs(w).max() + 1e-9, (name, err, np.abs(w).max())


@pytest.mark.parametrize("detach", [False, True], ids=["joint", "detached"])
def test_joint_step_losses_and_gradients(joint, detach):
    """Losses rtol 1e-5; every detector and LossNet gradient against
    jax.grad (5e-4 of the tensor's largest entry). Detached, the detector's
    gradient is that of the task loss alone."""
    (total, aux), (g_task, g_ll) = joint.value_and_grad(detach)
    model, lossnet, metrics = _port_step(joint, detach)
    np.testing.assert_allclose(float(metrics["loss"]), float(total), rtol=1e-5)
    for k in ("task_loss", "ll_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(aux[k]), rtol=1e-5, atol=1e-7)
    assert float(aux["ll_loss"]) > 0
    _close_grads(model, flax_to_state_dict({"params": g_task}))
    _close_grads(lossnet, module_state_dict(g_ll))

    if detach:
        alone, _, _ = _port_step(joint, detach, ll_weight=0.0)
        for (name, p), q in zip(model.named_parameters(), alone.parameters()):
            torch.testing.assert_close(p.grad, q.grad, rtol=0, atol=0, msg=name)


def test_joint_step_is_the_jax_step(joint):
    """The loss above is make_ll_train_step's: its metrics on the same
    inputs (rtol 1e-5)."""
    step = jll4al.make_ll_train_step(joint.jm, joint.jnet, ll_weight=LL_WEIGHT)
    tx = optax.sgd(0.0)

    def state(params, frozen):
        return TrainState(step=jnp.zeros((), jnp.int32), params=params, frozen=frozen,
                          opt_state=tx.init(params), tx=tx)

    _, _, metrics = step(state(joint.variables["params"], joint.variables["frozen"]),
                         state(joint.ll_params, {}), jnp.asarray(joint.images),
                         jnp.asarray(joint.hw), *joint.gt, joint.rng_key,
                         detach_features=False)
    (total, aux), _ = joint.value_and_grad(False)
    np.testing.assert_allclose(float(metrics["loss"]), float(total), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ll_loss"]), float(aux["ll_loss"]), rtol=1e-5)


def test_ll_score_fn_matches_jax(joint):
    """LossNet on the eval-mode pyramid, no RoI work: atol 1e-4 (the tiny
    backbone's float32 rounding, pooled)."""
    want = jll4al.make_ll_score_fn(joint.jm, joint.jnet)(
        joint.variables, joint.ll_params, jnp.asarray(joint.images), jnp.asarray(joint.hw))
    _, tm = tiny_models(**TINY_TRAIN)[1:]
    lossnet = LossNet(num_levels=4)
    lossnet.load_state_dict(module_state_dict(joint.ll_params), strict=True)
    got = make_ll_score_fn(tm, lossnet)(T(joint.images), T(joint.hw))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4)


def test_ll_select_matches_jax(rng):
    pred = rng.integers(0, 5, 30).astype(np.float64)       # ties: stable order
    for budget in (0, 7, 30):
        np.testing.assert_array_equal(ll_select(pred, budget), jll4al.ll_select(pred, budget))
