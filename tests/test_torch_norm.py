"""``--norm group`` in the port against the JAX package, on the CPU: the
group rule, GroupNorm against ``flax.linen.GroupNorm`` in float32 and
bfloat16, the seeded init and the weight bridge of GroupNorm leaves, then
the tiny Faster R-CNN with group norms and the same weights in both
packages: ``detect`` slot for slot, ``loss``, every gradient and one SGD
step (nothing frozen, weight decay on every leaf). Each comparison states
its tolerance.

The group-norm detector's pyramid is about twice the frozen one's (its
norms rescale every block to unit variance), and the JAX package reduces
the group statistics E[x^2] - E[x]^2 in float32 in an order of its own, a
few 1e-5 of the pyramid away from the exact sums; the detect fixture scales
the FPN outputs by 1/2, back to the frozen model's size, so that the
amplified heads do not turn those rounding differences into box
differences beyond ``test_torch_detect.py``'s tolerances.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cald_tpu.engine.optim import make_sgd as jmake_sgd
from cald_tpu.models.layers import make_norm as jmake_norm
from cald_tpu_torch.cli import config, driver
from cald_tpu_torch.convert.from_flax import flax_to_state_dict
from cald_tpu_torch.engine.optim import make_sgd
from cald_tpu_torch.engine.train import make_train_step
from cald_tpu_torch.models import resnet
from cald_tpu_torch.models.faster_rcnn import FasterRCNN, FasterRCNNConfig
from cald_tpu_torch.models.init import random_init_
from cald_tpu_torch.models.layers import GroupNorm, group_count, make_norm
from tests.test_torch_detect import FIELDS_ATOL
from tests.test_torch_train import LOSS_NAMES, JaxDraws, _gt
from tests.torch_helpers import (
    TINY, TINY_TRAIN, scale_pyramid, tiny_images, tiny_models, to_np,
)

T = torch.from_numpy


@pytest.mark.parametrize("width", [16, 64, 72, 120, 256, 960])
def test_group_rule_matches_jax(width):
    """32 groups, or gcd(C, 32) where 32 does not divide C."""
    want = jmake_norm("group")(width).num_groups
    assert group_count(width) == want == make_norm("group")(width).num_groups
    assert width % want == 0


def _flax_group_norm(x, scale, bias, groups, dtype):
    m = fnn.GroupNorm(num_groups=groups, dtype=dtype)
    return np.asarray(jax.jit(m.apply)({"params": {"scale": scale, "bias": bias}},
                                       jnp.asarray(x, dtype)).astype(jnp.float32))


@pytest.mark.parametrize("width", [16, 72, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_flax(rng, width, dtype):
    """f32: atol 1e-5 (the same statistics summed in another order); bf16:
    both reduce in f32 and round the result once, so at most one bf16 step
    apart (rtol 2^-7). The port's input is channels-last NCHW, as the
    backbone's convolutions give it."""
    x = rng.normal(0.0, 1.5, (2, 12, 16, width)).astype(np.float32)
    scale = rng.uniform(0.7, 1.3, width).astype(np.float32)
    bias = rng.normal(0.0, 0.05, width).astype(np.float32)
    groups = group_count(width)
    want = _flax_group_norm(x, scale, bias, groups, jnp.dtype(dtype))
    norm = GroupNorm(width, groups)
    with torch.no_grad():
        norm.weight.copy_(T(scale))
        norm.bias.copy_(T(bias))
        xt = T(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        got = norm(xt.to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    got = to_np(got.float().permute(0, 2, 3, 1))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=2 ** -7)


def test_group_norm_constant_groups_match_flax():
    """Constant groups: E[x^2] - E[x]^2 rounds to about 0 (clamped where
    negative), and Flax's epsilon 1e-6 (torch's default is 1e-5) sets how
    far x - mean is amplified: atol 1e-4 against Flax, and the bias."""
    x = np.broadcast_to(np.array([0.1, 0.1, 7.0, 7.0], np.float32), (1, 3, 3, 4)).copy()
    bias = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    want = _flax_group_norm(x, np.ones(4, np.float32), bias, 2, jnp.float32)
    norm = GroupNorm(4, 2)
    with torch.no_grad():
        norm.bias.copy_(T(bias))
        got = to_np(norm(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    assert norm.eps == 1e-6
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, np.broadcast_to(bias, got.shape), atol=1e-4, rtol=0)
    with pytest.raises(ValueError):
        GroupNorm(6, 4)


def test_random_init_keeps_the_conv_draws_and_sets_group_norms():
    """random_init_ gives the GroupNorms Flax's scale 1 and bias 0 and every
    other leaf the draws of the frozen-norm model."""
    models = {}
    for norm in ("frozen", "group"):
        m = FasterRCNN(FasterRCNNConfig(norm=norm, **TINY))
        for p in m.parameters():
            p.data.fill_(0.5)
        random_init_(m, 3)
        models[norm] = m
    gn = [m for m in models["group"].modules() if isinstance(m, GroupNorm)]
    assert len(gn) == 1 + 4 * 3 + 4                 # stem, 3 per block, 4 downsamples
    for m in gn:
        assert torch.equal(m.weight, torch.ones_like(m.weight))
        assert torch.equal(m.bias, torch.zeros_like(m.bias))
    frozen = dict(models["frozen"].named_parameters())
    for name, p in models["group"].named_parameters():
        if name in frozen:
            assert torch.equal(p, frozen[name]), name


@pytest.fixture(scope="module")
def group_models():
    jm, variables, tm = tiny_models(norm="group", **TINY_TRAIN)
    assert "frozen" not in variables
    return jm, variables, tm


def test_bridge_maps_group_norm_leaves(group_models):
    """Every Flax leaf lands on one port parameter: GroupNorm_i takes
    FrozenBatchNorm_i's name and its ``scale`` becomes ``weight``."""
    _, variables, tm = group_models
    sd = flax_to_state_dict(variables)
    assert len(sd) == len(jax.tree_util.tree_leaves(variables))
    assert set(sd) == set(tm.state_dict())
    p = variables["params"]["backbone"]
    np.testing.assert_array_equal(sd["backbone.layer2_0.downsample_bn.weight"].numpy(),
                                  np.asarray(p["layer2_0"]["GroupNorm_3"]["scale"]))
    np.testing.assert_array_equal(sd["backbone.bn1.bias"].numpy(),
                                  np.asarray(p["GroupNorm_0"]["bias"]))


@pytest.fixture(scope="module")
def detections(group_models):
    jm, variables, _ = group_models
    variables = scale_pyramid(variables, 1 / 2)
    tm = FasterRCNN(FasterRCNNConfig(norm="group", **TINY, **TINY_TRAIN))
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    tm.eval()
    images, valid_hw = tiny_images()
    det_j = jax.jit(lambda v, i, h: jm.apply(v, i, h, method="detect"))(
        variables, jnp.asarray(images), jnp.asarray(valid_hw))
    with torch.inference_mode():
        det_t = tm.detect(T(images), T(valid_hw))
    return det_j, det_t, tm


@pytest.mark.parametrize("field", ["valid", "labels"])
def test_detect_exact_fields(detections, field):
    det_j, det_t, _ = detections
    assert int(np.asarray(det_j.valid).sum()) > 10, "degenerate fixture"
    np.testing.assert_array_equal(to_np(getattr(det_t, field)),
                                  np.asarray(getattr(det_j, field)))


@pytest.mark.parametrize("field", sorted(FIELDS_ATOL))
def test_detect_slot_for_slot(detections, field):
    det_j, det_t, _ = detections
    np.testing.assert_allclose(to_np(getattr(det_t, field)),
                               np.asarray(getattr(det_j, field)),
                               atol=FIELDS_ATOL[field], rtol=0)


@pytest.mark.parametrize("mode", ["1", "stage"])
def test_fused_gate_is_ignored_under_group_norm(detections, monkeypatch, mode):
    """CALD_TPU_PALLAS_BNECK set: a group-norm backbone still runs its plain
    blocks (nothing to fold) and detect gives the same tensors."""
    _, det_t, tm = detections

    def no_fold(self):
        raise AssertionError("folded() called under group norm")

    monkeypatch.setattr(resnet.Bottleneck, "folded", no_fold)
    monkeypatch.setenv("CALD_TPU_PALLAS_BNECK", mode)
    images, valid_hw = tiny_images()
    with torch.inference_mode():
        again = tm.detect(T(images), T(valid_hw))
    for field in ("boxes", "scores", "valid", "labels"):
        assert torch.equal(getattr(again, field), getattr(det_t, field)), field


@pytest.fixture(scope="module")
def trained(group_models):
    """The JAX package's per-image losses and gradients of the group-norm
    tiny model, with the sampling draws the port gets injected."""
    jm, variables, _ = group_models
    images, hw = tiny_images()
    gt, gl, gv = _gt(np.random.default_rng(11), g=8)
    rng_key = jax.random.key(5)
    key = jm.apply(variables, method=lambda m: m.make_rng("sampling"),
                   rngs={"sampling": rng_key})
    draws = JaxDraws({0: jax.random.split(jax.random.fold_in(key, 0), 2),
                      2: jax.random.split(jax.random.fold_in(key, 1), 2)})

    def total(params):
        ls, _ = jm.apply({"params": params}, jnp.asarray(images), jnp.asarray(hw), gt, gl,
                         gv, method="loss", per_image=True, rngs={"sampling": rng_key})
        return sum(jnp.mean(v) for v in ls.values()), ls

    (_, per_image), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        variables["params"])
    batch = tuple(T(a) for a in (images, hw, gt, gl, gv))

    def fresh():
        model = FasterRCNN(FasterRCNNConfig(norm="group", **TINY, **TINY_TRAIN))
        model.load_state_dict(flax_to_state_dict(variables), strict=True)
        return model

    return variables, batch, draws, per_image, grads, fresh


def test_loss_matches_jax(trained):
    """rtol 1e-5, as test_torch_train.py's frozen-norm losses, except the
    classifier loss: rtol 3e-4. Its logits come from the head amplified 35x
    (``torch_helpers._amplify``), which turns the JAX package's float32
    group statistics (a few 1e-5 of the pyramid from the exact sums, where
    the port's are within 2e-6) into 1.3e-4 of the loss."""
    _, batch, draws, per_image, _, fresh = trained
    got, _ = fresh().loss(*batch, draws, per_image=True)
    for k in LOSS_NAMES:
        want = np.asarray(per_image[k])
        assert want.min() > 0, k
        rtol = 3e-4 if k == "loss_classifier" else 1e-5
        np.testing.assert_allclose(to_np(got[k]), want, atol=1e-5, rtol=rtol)


def test_gradients_match_jax(trained):
    """Every gradient, the GroupNorms' weight and bias included, within 5e-4
    of the tensor's largest entry (test_torch_train.py's bound)."""
    _, batch, draws, _, grads, fresh = trained
    model = fresh()
    losses_, _ = model.loss(*batch, draws)
    sum(losses_.values()).backward()
    want = flax_to_state_dict({"params": grads})
    names = [n for n, _ in model.named_parameters()]
    assert set(want) == set(names)
    assert sum(n.endswith("bn1.weight") for n in names) == 5
    for name, p in model.named_parameters():
        w = want[name].numpy()
        err = np.abs(to_np(p.grad) - w).max()
        assert err <= 5e-4 * np.abs(w).max() + 1e-9, (name, err, np.abs(w).max())
        assert np.abs(w).max() > 0, name


def test_sgd_step_matches_optax_with_nothing_frozen(trained):
    """One make_train_step step at lr 0.01 with no frozen prefix against the
    JAX package's make_sgd update: every parameter, the GroupNorms' included
    (weight decay reaches them as optax's add_decayed_weights does), changed
    and within the lr times the gradient bound above (test_torch_train.py's
    rule: 1e-6 there)."""
    variables, batch, draws, _, grads, fresh = trained
    model = fresh()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    make_train_step(model, make_sgd(model, 0.01))(*batch, draws)
    params = variables["params"]
    tx = jmake_sgd(0.01, params=params)
    new = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        grads, params)
    want = flax_to_state_dict({"params": new})
    grad_max = {k: np.abs(v.numpy()).max() for k, v in flax_to_state_dict(
        {"params": grads}).items()}
    for name, p in model.named_parameters():
        assert p.requires_grad, name
        np.testing.assert_allclose(to_np(p), want[name].numpy(),
                                   atol=0.01 * 5e-4 * grad_max[name] + 1e-6, rtol=0)
        assert not torch.equal(p, before[name]), name


@pytest.mark.parametrize("tiny", [True, False])
def test_build_model_freezes_nothing_under_group_norm(tiny):
    cfg = config.ALConfig(tiny=tiny, norm="group").resolve()
    model, frozen = driver.build_model(cfg, 21)
    assert frozen == ()
    assert model.cfg.norm == "group"
    assert isinstance(model.backbone.layer1_0.bn1, GroupNorm)
    assert model.backbone.layer1_0.bn1.num_groups == (16 if tiny else 32)
