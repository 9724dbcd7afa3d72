"""The port's training path against the JAX package's, on the CPU in float32:
losses, matcher and sampler (with the JAX package's Gumbel draws injected),
the RPN and box-head losses, ``FasterRCNN.loss`` and its gradients on the tiny
model with the JAX CLI's tiny training counts, SGD with warmup and frozen
prefixes, the train step and the epoch loop. Each comparison states its
tolerance."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cald_tpu.engine.optim import RESNET_FROZEN_L3 as JAX_FROZEN
from cald_tpu.engine.optim import make_sgd as jmake_sgd
from cald_tpu.engine.schedules import multistep_with_warmup as jschedule
from cald_tpu.models import matcher as jmatcher
from cald_tpu.models.roi_heads import fastrcnn_loss as jfastrcnn_loss
from cald_tpu.models.roi_heads import select_training_samples as jselect_training_samples
from cald_tpu.models.rpn import rpn_loss as jrpn_loss
from cald_tpu.ops import losses as jlosses
from cald_tpu_torch.convert.from_flax import flax_to_state_dict
from cald_tpu_torch.engine.logging import MetricLogger
from cald_tpu_torch.engine.optim import RESNET_FROZEN_L3, make_sgd
from cald_tpu_torch.engine.schedules import lr_scheduler, multistep_with_warmup
from cald_tpu_torch.engine.train import make_train_step, train_one_epoch
from cald_tpu_torch.models import matcher
from cald_tpu_torch.models.faster_rcnn import FasterRCNN, FasterRCNNConfig
from cald_tpu_torch.models.matcher import generator_gumbel
from cald_tpu_torch.models.roi_heads import fastrcnn_loss, select_training_samples
from cald_tpu_torch.models.rpn import rpn_loss
from cald_tpu_torch.ops import losses
from tests.test_ops_boxes import random_boxes
from tests.torch_helpers import TINY, TINY_TRAIN, tiny_images, tiny_models, to_np

T = torch.from_numpy
LOSS_NAMES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg")


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=atol, rtol=rtol)


class JaxDraws:
    """The Gumbel noise the JAX samplers draw from per-image keys: for each
    stream pair (s, s + 1) the (kp, kn) = split(key_i) of every image, as
    ``cald_tpu/models/matcher.py::balanced_sample`` splits them. Used as a
    port ``Draw``; the sizes come from the requested shapes."""

    def __init__(self, keys_by_stream: dict):
        self.keys = {}
        for stream, keys in keys_by_stream.items():
            pairs = [jax.random.split(k) for k in keys]
            self.keys[stream] = [p[0] for p in pairs]
            self.keys[stream + 1] = [p[1] for p in pairs]

    def __call__(self, stream, shape):
        ks = self.keys[stream]
        assert len(ks) == shape[0]
        return T(np.stack([np.asarray(jax.random.gumbel(k, (shape[1],))) for k in ks]))


def _gt(rng, b=2, g=6, img=(96, 128)):
    boxes = np.zeros((b, g, 4), np.float32)
    labels = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    for i, k in enumerate(rng.integers(1, g, b)):
        xy = rng.uniform(0, [img[1] - 40, img[0] - 40], (k, 2))
        wh = rng.uniform(12, 40, (k, 2))
        boxes[i, :k] = np.concatenate([xy, xy + wh], -1)
        labels[i, :k] = rng.integers(1, 4, k)
        valid[i, :k] = True
    return boxes, labels, valid


# --------------------------------------------------------------------------
# losses, matcher, sampler: atol 1e-5 (f32), indices exact
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["bce_with_logits", "sigmoid_focal_loss",
                                  "smooth_l1_loss", "softmax_cross_entropy"])
def test_losses(rng, name):
    x = rng.normal(0, 4, (6, 5)).astype(np.float32)
    if name == "softmax_cross_entropy":
        y = rng.integers(0, 5, (6,)).astype(np.int32)
    elif name == "smooth_l1_loss":
        y = (x + rng.normal(0, 0.2, x.shape)).astype(np.float32)
    else:
        y = (rng.uniform(size=x.shape) > 0.5).astype(np.float32)
    _close(getattr(losses, name)(T(x), T(y)), getattr(jlosses, name)(x, y), 1e-5)


@pytest.mark.parametrize("low_quality", [True, False])
def test_match_anchors(rng, low_quality):
    gt = np.stack([random_boxes(rng, 5), random_boxes(rng, 5)])
    gv = np.array([[1, 1, 1, 0, 0], [0, 0, 0, 0, 0]], bool)
    anchors = random_boxes(rng, 300)
    anchors[:5] = gt[0]                          # exact best matches and ties
    got = matcher.match_anchors(T(gt), T(gv), T(anchors), high=0.5, low=0.3,
                                allow_low_quality=low_quality)
    want = jax.vmap(lambda g, v: jmatcher.match_anchors(
        g, v, anchors, high=0.5, low=0.3, allow_low_quality=low_quality))(gt, gv)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    assert (to_np(got)[0] >= 0).any() and (to_np(got)[1] == matcher.BELOW).all()


@pytest.mark.parametrize("n_pos", [3, 200])
def test_balanced_sample_slot_for_slot(rng, n_pos):
    """Positives short (negatives fill in) and plentiful; BETWEEN never taken."""
    n, b = 600, 2
    matches = np.full((b, n), matcher.BELOW, np.int32)
    for i in range(b):
        matches[i, rng.choice(n, n_pos, replace=False)] = rng.integers(0, 4, n_pos)
        matches[i, rng.choice(n, 100, replace=False)] = matcher.BETWEEN
    keys = jax.random.split(jax.random.key(3), b)
    draws = JaxDraws({0: keys})
    got = matcher.balanced_sample(T(matches), draws, num_samples=64, positive_fraction=0.25)
    want = jax.vmap(lambda m, k: jmatcher.balanced_sample(
        m, k, num_samples=64, positive_fraction=0.25))(matches, keys)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


def test_rpn_loss(rng):
    anchors = random_boxes(rng, 400, size=128.0)
    gt, _, gv = _gt(rng)
    obj = rng.normal(0, 2, (2, 400)).astype(np.float32)
    deltas = rng.normal(0, 0.3, (2, 400, 4)).astype(np.float32)
    keys = jax.random.split(jax.random.key(1), 2)
    got = rpn_loss(T(obj), T(deltas), T(anchors), T(gt), T(gv), JaxDraws({0: keys}),
                   batch_size_per_image=64)
    want = jax.jit(jax.vmap(lambda o, d, g, v, k: jrpn_loss(
        o, d, jnp.asarray(anchors), g, v, k, batch_size_per_image=64)))(
        obj, deltas, gt, gv, keys)
    for g, w in zip(got, want):
        assert np.asarray(w).min() > 0
        _close(g, w, 1e-5, 1e-5)


def test_select_training_samples_and_fastrcnn_loss(rng):
    gt, gl, gv = _gt(rng)
    props = np.stack([random_boxes(rng, 50, size=128.0) for _ in range(2)])
    pv = rng.uniform(size=(2, 50)) > 0.2
    props[0, :4] = gt[0, :4] + rng.normal(0, 2, (4, 4))    # positives besides the gt
    keys = jax.random.split(jax.random.key(2), 2)
    kw = dict(batch_size_per_image=32, positive_fraction=0.25)
    got = select_training_samples(T(props), T(pv), T(gt), T(gl), T(gv),
                                  JaxDraws({2: keys}), **kw)
    want = jax.jit(jax.vmap(lambda p, v, g, l, gvv, k: jselect_training_samples(
        p, v, g, l, gvv, k, **kw)))(props, pv, gt, gl, gv, keys)
    for name, g, w in zip(("rois", "labels", "reg_targets", "is_pos", "valid"), got, want):
        if name in ("labels", "is_pos", "valid"):
            np.testing.assert_array_equal(to_np(g), np.asarray(w), err_msg=name)
        else:
            pos = np.array(want[3])[..., None]               # targets of positives
            _close(g * T(pos) if name == "reg_targets" else g,
                   np.asarray(w) * pos if name == "reg_targets" else w, 1e-4)

    logits = rng.normal(0, 2, (2, 32, 4)).astype(np.float32)
    reg = rng.normal(0, 0.5, (2, 32, 16)).astype(np.float32)
    targets = np.array(want[2])
    got_l = fastrcnn_loss(T(logits), T(reg), got[1], T(targets), got[3], got[4])
    want_l = jax.jit(jax.vmap(jfastrcnn_loss))(logits, reg, want[1], targets, want[3],
                                               want[4])
    for g, w in zip(got_l, want_l):
        _close(g, w, 1e-5, 1e-5)


# --------------------------------------------------------------------------
# FasterRCNN.loss and its gradients, tiny model, the JAX CLI's tiny counts
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jm, variables, tm = tiny_models(**TINY_TRAIN)
    images, hw = tiny_images()
    gt, gl, gv = _gt(np.random.default_rng(11), g=8)
    rng_key = jax.random.key(5)
    # the key FasterRCNN.loss draws with make_rng('sampling'); the samplers
    # fold it with 0 (RPN) and 1 (box head), then split it per image
    key = jm.apply(variables, method=lambda m: m.make_rng("sampling"),
                   rngs={"sampling": rng_key})
    draws = JaxDraws({0: jax.random.split(jax.random.fold_in(key, 0), 2),
                      2: jax.random.split(jax.random.fold_in(key, 1), 2)})

    def total(params):
        ls, _ = jm.apply({"params": params, "frozen": variables["frozen"]},
                         jnp.asarray(images), jnp.asarray(hw), gt, gl, gv, method="loss",
                         per_image=True, rngs={"sampling": rng_key})
        return sum(jnp.mean(v) for v in ls.values()), ls

    (_, per_image), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        variables["params"])
    batch = tuple(T(a) for a in (images, hw, gt, gl, gv))

    def fresh():
        """A new port model with the same weights."""
        model = FasterRCNN(FasterRCNNConfig(**TINY, **TINY_TRAIN))
        model.load_state_dict(flax_to_state_dict(variables), strict=True)
        return model

    return types.SimpleNamespace(jm=jm, variables=variables, tm=tm, batch=batch,
                                 draws=draws, per_image=per_image, grads=grads, fresh=fresh)


def test_loss_per_image_and_mean(tiny):
    """rtol 1e-5: f32 sums of the same terms in another order."""
    per_image, _ = tiny.tm.loss(*tiny.batch, tiny.draws, per_image=True)
    mean, pyramid = tiny.tm.loss(*tiny.batch, tiny.draws)
    assert len(pyramid) == 5
    for k in LOSS_NAMES:
        want = np.asarray(tiny.per_image[k])
        assert want.shape == (2,) and want.min() > 0, k
        _close(per_image[k], want, 1e-5, 1e-5)
        _close(mean[k], want.mean(), 1e-5, 1e-5)


def test_loss_gradients(tiny):
    """Every trainable gradient against jax.grad, mapped through the weight
    bridge; max abs error within 5e-4 of the tensor's largest entry (the
    backward sums over the batch, the pyramid and the RoIAlign scatter in
    another order)."""
    model = tiny.tm
    model.zero_grad()
    losses_, _ = model.loss(*tiny.batch, tiny.draws)
    sum(losses_.values()).backward()
    want = flax_to_state_dict({"params": tiny.grads})
    names = [n for n, _ in model.named_parameters()]
    assert set(want) == set(names)
    for name, p in model.named_parameters():
        w = want[name].numpy()
        err = np.abs(to_np(p.grad) - w).max()
        assert err <= 5e-4 * np.abs(w).max() + 1e-9, (name, err, np.abs(w).max())
        assert np.abs(w).max() > 0, name


def test_train_step_matches_optax_update(tiny):
    """One make_train_step step (lr 0.01, frozen stem + layer1) against the
    JAX package's make_sgd update on the JAX gradients: parameters within
    1e-6 (the lr times the gradient tolerance above), frozen ones bit-equal."""
    variables, model = tiny.variables, tiny.fresh()
    opt = make_sgd(model, 0.01, frozen_prefixes=RESNET_FROZEN_L3)
    step = make_train_step(model, opt)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = step(*tiny.batch, tiny.draws)
    assert set(metrics) == set(LOSS_NAMES) | {"loss"}
    assert all(not v.requires_grad for v in metrics.values())

    params = variables["params"]
    tx = jmake_sgd(0.01, params=params, frozen_prefixes=JAX_FROZEN)
    new_params = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        tiny.grads, params)
    want = flax_to_state_dict({"params": new_params})
    for name, p in model.named_parameters():
        if name.startswith(RESNET_FROZEN_L3):
            assert not p.requires_grad and torch.equal(p, before[name]), name
        else:
            _close(p, want[name], 1e-6)
            assert not torch.equal(p, before[name]), name


def test_anchor_cache_after_inference_detect(tiny):
    """A model that scores under inference mode and then trains: the anchors
    cached by detect are inference tensors, which autograd cannot save, so
    training builds its own."""
    model = tiny.fresh()
    images, hw = tiny.batch[:2]
    with torch.inference_mode():
        model.detect(images, hw)
    losses_, _ = model.loss(*tiny.batch, tiny.draws)
    sum(losses_.values()).backward()
    assert model.box_head.fc6.weight.grad is not None
    assert sorted(k[-1] for k in model._anchor_cache) == [False, True]


# --------------------------------------------------------------------------
# optimizer, schedule, epoch loop
# --------------------------------------------------------------------------

def test_schedule_matches():
    """Warmup inside epoch 0, decays at the milestones; rtol 1e-6 (the JAX
    schedule computes in f32)."""
    got = multistep_with_warmup(0.02, 5, milestones=(3, 6), warmup_iters=4)
    want = jschedule(0.02, 5, milestones=(3, 6), warmup_iters=4)
    for step in range(40):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


def test_two_sgd_steps_with_warmup_and_frozen_prefix(rng, tiny):
    """Two steps of make_sgd + multistep_with_warmup on the same gradients as
    the JAX package's chain: parameters and momentum within 1e-6, frozen
    parameters unchanged and without momentum."""
    params, model = tiny.variables["params"], tiny.fresh()
    grads = [jax.tree.map(lambda p: rng.normal(0, 1, np.shape(p)).astype(np.float32), params)
             for _ in range(2)]
    schedule_args = (0.01, 3)                           # warmup over 2 iterations
    tx = jmake_sgd(jschedule(*schedule_args), params=params, frozen_prefixes=JAX_FROZEN)
    state = tx.init(params)
    opt = make_sgd(model, 0.01, frozen_prefixes=RESNET_FROZEN_L3)
    sched = lr_scheduler(opt, multistep_with_warmup(*schedule_args))
    before = {k: v.clone() for k, v in model.state_dict().items()}

    @jax.jit
    def update(g, state, params):
        upd, state = tx.update(g, state, params)
        return optax.apply_updates(params, upd), state

    for g in grads:
        params, state = update(g, state, params)
        sd = flax_to_state_dict({"params": g})
        for name, p in model.named_parameters():
            if p.requires_grad:
                p.grad = sd[name].clone()
        opt.step()
        sched.step()

    want = flax_to_state_dict({"params": params})
    trace = state.inner_states["train"].inner_state[1][0].trace
    trace = jax.tree.map(lambda t, p: np.zeros(np.shape(p), np.float32)
                         if isinstance(t, optax.MaskedNode) else t, trace, params,
                         is_leaf=lambda t: isinstance(t, optax.MaskedNode))
    momentum = flax_to_state_dict({"params": trace})
    n_frozen = 0
    for name, p in model.named_parameters():
        if name.startswith(RESNET_FROZEN_L3):
            n_frozen += 1
            assert torch.equal(p, before[name]) and p not in opt.state, name
        else:
            _close(p, want[name], 1e-6)
            _close(opt.state[p]["momentum_buffer"], momentum[name], 1e-6)
    assert n_frozen > 0
    assert opt.param_groups[0]["lr"] == pytest.approx(0.01)   # warmup over: step 2


def test_train_one_epoch(tiny):
    """The epoch loop over a numpy loader: finite metrics of the last step,
    and FloatingPointError on a non-finite loss."""
    model = tiny.fresh()
    images, hw, gt, gl, gv = (to_np(t) for t in tiny.batch)
    batch = types.SimpleNamespace(images=images, valid_hw=hw, boxes=gt, labels=gl,
                                  box_valid=gv)
    opt = make_sgd(model, 0.001, frozen_prefixes=RESNET_FROZEN_L3)
    step = make_train_step(model, opt, lr_scheduler(opt, multistep_with_warmup(0.001, 2)))
    draw = generator_gumbel(torch.Generator().manual_seed(0))
    lines = []
    metrics = train_one_epoch(step, [batch, batch], draw, device="cpu", epoch=0,
                              print_freq=1, logger=MetricLogger(print_fn=lines.append))
    assert set(metrics) == set(LOSS_NAMES) | {"loss"}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert any("Epoch: [0]" in line for line in lines)
    bad = types.SimpleNamespace(**{**vars(batch), "images": np.full_like(images, np.nan)})
    with pytest.raises(FloatingPointError):
        train_one_epoch(step, [bad], draw, device="cpu", epoch=1, print_freq=1,
                        logger=MetricLogger(print_fn=lines.append))
