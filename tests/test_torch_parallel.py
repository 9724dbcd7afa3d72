"""The port's multi-process data parallelism (``cald_tpu_torch.parallel``,
the driver's DP structure) on the CPU: the helpers as exact identities at one
process; on two gloo ranks (subprocesses of ``tests/torch_dp_worker.py``) the
helpers against their definitions, one training step of ``faster`` and of
``retina``, the LL4AL joint step and the VAAL VAE + discriminator step
against the JAX package's step on the concatenated global batch (float32,
the JAX draws injected), and the tiny ``al_loop`` (every strategy of the JAX
package's test) and ``cli.train`` giving identical results on both ranks.
Each comparison states its tolerance."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cald_tpu.engine.optim import RESNET_FROZEN_L3 as JAX_FROZEN
from cald_tpu.engine.optim import make_sgd as jmake_sgd
from cald_tpu.engine.state import TrainState
from cald_tpu.engine.train import make_train_step as jmake_train_step
from cald_tpu.models.lossnet import LossNet as JLossNet
from cald_tpu.strategies import ll4al as jll4al
from cald_tpu.strategies import vaal as jvaal
from cald_tpu_torch import parallel
from cald_tpu_torch.cli import driver
from cald_tpu_torch.convert.from_flax import VAE_TRANSPOSED, flax_to_state_dict, module_state_dict
from cald_tpu_torch.data.synthetic import make_learnable_voc
from cald_tpu_torch.engine.optim import RESNET_FROZEN_L3, make_sgd
from cald_tpu_torch.models.lossnet import LossNet
from cald_tpu_torch.strategies.vaal import VAALTrainer
from tests import torch_dp_worker as worker
from tests.test_torch_train import JaxDraws, _gt
from tests.torch_helpers import CANVAS, TINY_TRAIN, retina_models, tiny_models, to_np

T = torch.from_numpy
WORLD = 2
LR = 0.01


# --------------------------------------------------------------------------
# one process: exact identities
# --------------------------------------------------------------------------

def test_helpers_are_identities_at_one_process(monkeypatch):
    for var in ("WORLD_SIZE", "JAX_COORDINATOR_ADDRESS", "CALD_TPU_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.initialize_distributed() is False
    assert (parallel.process_count(), parallel.process_index()) == (1, 0)
    idx = [5, 3, 9]
    for pad in (True, False):
        np.testing.assert_array_equal(parallel.process_shard(idx, pad=pad), idx)
    obj = {"a": np.arange(3)}
    assert parallel.all_gather_objects(obj)[0] is obj
    x = np.arange(4.0)
    assert parallel.process_merge_sum(x) is not None
    np.testing.assert_array_equal(parallel.process_merge_sum(x), x)
    t = torch.arange(3.0, requires_grad=True)
    assert parallel.gather_cat(t) is t and parallel.process_mean(t) is t
    draw = lambda i, shape: torch.ones(shape)  # noqa: E731
    assert parallel.process_draw(draw) is draw
    assert driver._sync_len(7) == 7 and len(list(driver._Lockstep(range(4)))) == 4
    model = torch.nn.Linear(2, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    parallel.broadcast_module_(model)
    model(torch.ones(1, 2)).sum().backward()
    grads = [p.grad.clone() for p in model.parameters()]
    parallel.reduce_gradients_(torch.optim.SGD(model.parameters(), lr=0.1))
    assert all(torch.equal(a, b) for a, b in zip(grads, [p.grad for p in model.parameters()]))
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


# --------------------------------------------------------------------------
# two ranks over gloo
# --------------------------------------------------------------------------

def test_helpers_on_two_ranks(tmp_path):
    """process_shard wraps to a multiple of the ranks and strides; without
    pad it strides; the gathered objects come in rank order; the merge is
    the sum; _sync_len and _Lockstep give the least length; gather_cat
    concatenates in rank order."""
    out = worker.launch({"task": "helpers", "n": 7}, str(tmp_path))
    idx = np.arange(7)
    padded = np.concatenate([idx, idx[:1]])
    for r, res in enumerate(out):
        np.testing.assert_array_equal(res["shard"], padded[r::WORLD])
        np.testing.assert_array_equal(res["shard_nopad"], idx[r::WORLD])
        assert res["objects"] == [{"rank": k, "items": list(range(k + 1))} for k in range(WORLD)]
        np.testing.assert_array_equal(res["merge"], np.arange(6.0) * sum(range(1, WORLD + 1)))
        assert res["sync_len"] == 3 and res["lockstep"] == 3
        assert res["gather"] == [0.0, 0.0, 1.0, 1.0]


class Recorder:
    """A draw that records what it returns, by stream."""

    def __init__(self, draw):
        self.draw, self.arrays = draw, {}

    def __call__(self, stream, shape, **kw):
        out = self.draw(stream, shape, **kw)
        self.arrays[stream] = to_np(out)
        return out


def _global_batch(seed=11, b=2 * WORLD):
    """b images on the tiny canvas, some padded, with 1-7 gt boxes each."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (b, *CANVAS, 3)).astype(np.float32)
    hw = np.array([[96, 128], [80, 100], [96, 112], [72, 128]][:b], np.int32)
    for i, (h, w) in enumerate(hw):
        images[i, h:] = 0.0
        images[i, :, w:] = 0.0
    return (images, hw, *_gt(rng, b=b, g=8))


def _jax_key_draws(jm, variables, rng_key, b):
    """The JAX loss's sampling draws for a batch of b (tests/test_torch_train.py)."""
    key = jm.apply(variables, method=lambda m: m.make_rng("sampling"),
                   rngs={"sampling": rng_key})
    return JaxDraws({0: jax.random.split(jax.random.fold_in(key, 0), b),
                     2: jax.random.split(jax.random.fold_in(key, 1), b)})


def _jax_state(variables, tx):
    params = variables["params"]
    return TrainState(step=jnp.zeros((), jnp.int32), params=params,
                      frozen=variables.get("frozen", {}), opt_state=tx.init(params), tx=tx)


def _close_params(got: dict, want: dict, atol: float, frozen=()):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(to_np(got[name]), to_np(w), atol=atol, rtol=0, err_msg=name)


def _same_on_every_rank(results, key):
    for res in results[1:]:
        for name, v in results[0][key].items():
            assert torch.equal(res[key][name], v), name


@pytest.mark.parametrize("model_kind", ["faster", "retina"])
def test_dp_train_step_matches_jax_global_batch(tmp_path, model_kind):
    """Two ranks at B=2 against the JAX make_train_step on the concatenated
    batch of 4 (SGD lr 0.01, stem and layer1 frozen): losses rtol 1e-5 (the
    global mean of per-image losses, RetinaNet's normalised by each image's
    num_fg), parameters after the step within 2e-6 (lr times the gradient
    tolerance of tests/test_torch_train.py, the two ranks' sums added in
    another order), frozen parameters unchanged, both ranks bit-equal."""
    if model_kind == "faster":
        jm, variables, tm = tiny_models(**TINY_TRAIN)
    else:
        jm, variables, tm = retina_models()
    spec = {"kind": model_kind, "cfg": tm.cfg, "state_dict": tm.state_dict()}
    batch = _global_batch()
    rng_key = jax.random.key(5)
    recorder = Recorder(_jax_key_draws(jm, variables, rng_key, len(batch[0])))
    tm.loss(*(T(a) for a in batch), recorder)
    tm.zero_grad(set_to_none=True)

    tx = jmake_sgd(LR, params=variables["params"], frozen_prefixes=JAX_FROZEN)
    new_state, jmetrics = jmake_train_step(jm)(_jax_state(variables, tx),
                                               *(jnp.asarray(a) for a in batch), rng_key)
    want = flax_to_state_dict({"params": jax.tree.map(np.asarray, new_state.params)})

    out = worker.launch({"task": "step", "model": spec, "batch": batch,
                         "draws": recorder.arrays, "lr": LR, "frozen": RESNET_FROZEN_L3},
                        str(tmp_path))
    _same_on_every_rank(out, "params")
    for res in out:
        assert set(res["metrics"]) == set(jmetrics)
        for k, v in jmetrics.items():
            np.testing.assert_allclose(res["metrics"][k], float(v), rtol=1e-5, err_msg=k)
    before = flax_to_state_dict(variables)
    n_frozen = 0
    for name, p in out[0]["params"].items():
        if name.startswith(RESNET_FROZEN_L3):
            n_frozen += 1
            assert torch.equal(p, before[name]), name
    assert n_frozen > 0
    _close_params(out[0]["params"], {k: v for k, v in want.items() if k in out[0]["params"]},
                  2e-6)


def test_dp_ll4al_joint_step_matches_jax_global_batch(tmp_path):
    """Two ranks at B=2 against the JAX make_ll_train_step on the batch of 4:
    the ranking loss pairs image i of rank 0 with image 3 - i of rank 1
    (half = 2 pairs over the global batch). Losses rtol 1e-5, detector and
    LossNet parameters after the step within 2e-6, both ranks bit-equal."""
    jm, variables, tm = tiny_models(**TINY_TRAIN)
    batch = _global_batch()
    rng_key = jax.random.key(5)
    recorder = Recorder(_jax_key_draws(jm, variables, rng_key, len(batch[0])))
    tm.loss(*(T(a) for a in batch), recorder)
    tm.zero_grad(set_to_none=True)

    jnet = JLossNet(num_levels=4)
    feats = jm.apply(variables, jnp.asarray(batch[0]), jnp.asarray(batch[1]),
                     method="extract_features")
    ll_params = jax.tree.map(np.asarray, jnet.init(jax.random.key(1), feats[:4])["params"])
    lossnet = LossNet(num_levels=4)
    lossnet.load_state_dict(module_state_dict(ll_params), strict=True)

    tx = jmake_sgd(LR, params=variables["params"], frozen_prefixes=JAX_FROZEN)
    ll_tx = jmake_sgd(LR)
    ll_state = TrainState(step=jnp.zeros((), jnp.int32), params=ll_params, frozen={},
                          opt_state=ll_tx.init(ll_params), tx=ll_tx)
    step = jll4al.make_ll_train_step(jm, jnet, ll_weight=0.5)
    task_state, ll_state, jmetrics = step(_jax_state(variables, tx), ll_state,
                                          *(jnp.asarray(a) for a in batch), rng_key,
                                          detach_features=False)

    spec = {"kind": "faster", "cfg": tm.cfg, "state_dict": tm.state_dict()}
    out = worker.launch({"task": "ll4al", "model": spec, "lossnet": lossnet,
                         "batch": batch, "draws": recorder.arrays, "lr": LR,
                         "frozen": RESNET_FROZEN_L3, "ll_weight": 0.5, "detach": False},
                        str(tmp_path))
    _same_on_every_rank(out, "params")
    _same_on_every_rank(out, "ll_params")
    for res in out:
        for k, v in jmetrics.items():
            np.testing.assert_allclose(res["metrics"][k], float(v), rtol=1e-5, err_msg=k)
    want = flax_to_state_dict({"params": jax.tree.map(np.asarray, task_state.params)})
    _close_params(out[0]["params"], {k: v for k, v in want.items() if k in out[0]["params"]},
                  2e-6)
    _close_params(out[0]["ll_params"],
                  module_state_dict(jax.tree.map(np.asarray, ll_state.params)), 2e-6)


def test_dp_vaal_step_matches_jax_global_batch(tmp_path):
    """Two ranks with 2 labeled and 2 unlabeled images each against the JAX
    trainer's step on 4 + 4 (the KLD a sum over the global batch, the BCE
    terms means over it): losses rtol 1e-4; each parameter's change within
    1e-2 of the largest change of its network (one process of the port
    lands 3e-3 from JAX here: the raw KLD sum's large gradients in float32,
    and the biases ahead of GroupNorm, whose gradient is zero but for
    rounding); against one process of the port on the global batch, within
    1e-4 of that largest change (the ranks' sums in another order); both
    ranks bit-equal."""
    z, base, size, vae_lr, d_lr = 16, 8, 64, 1e-4, 1e-3
    jt = jvaal.VAALTrainer(z_dim=z, base_width=base, image_size=size, seed=3,
                           vae_tx=jmake_sgd(vae_lr), d_tx=jmake_sgd(d_lr))
    rng = np.random.default_rng(6)
    lab, unlab = (rng.uniform(0, 255, (2 * WORLD, 96, 128, 3)).astype(np.float32)
                  for _ in range(2))
    key = jax.random.key(12)
    keys = jax.random.split(key)
    draws = {i: np.array(jax.random.normal(keys[i], (2 * WORLD, z))) for i in range(2)}
    sizes = dict(z_dim=z, base_width=base, image_size=size)
    before = (module_state_dict(jax.tree.map(np.asarray, jt.vae_params),
                                transposed=VAE_TRANSPOSED),
              module_state_dict(jax.tree.map(np.asarray, jt.d_params)))
    want_losses = jt.train_step(lab, unlab, key)
    want = (module_state_dict(jax.tree.map(np.asarray, jt.vae_params), transposed=VAE_TRANSPOSED),
            module_state_dict(jax.tree.map(np.asarray, jt.d_params)))

    one = VAALTrainer(lambda v, d: (make_sgd(v, vae_lr), None, make_sgd(d, d_lr), None), **sizes)
    one.vae.load_state_dict(before[0])
    one.disc.load_state_dict(before[1])
    one.train_step(T(lab), T(unlab), worker.replay(draws))

    out = worker.launch({"task": "vaal", "sizes": sizes, "vae": before[0], "disc": before[1],
                         "images": (lab, unlab), "draws": draws, "lrs": (vae_lr, d_lr)},
                        str(tmp_path))
    _same_on_every_rank(out, "vae")
    _same_on_every_rank(out, "disc")
    np.testing.assert_allclose(out[0]["losses"], want_losses, rtol=1e-4)
    for key_, b, w, net in (("vae", before[0], want[0], one.vae),
                            ("disc", before[1], want[1], one.disc)):
        got, single = out[0][key_], dict(net.named_parameters())
        assert set(got) <= set(w) and set(got) == set(single)
        scale = max(float((w[n] - b[n]).abs().max()) for n in got)
        assert scale > 0
        for name, g in got.items():
            err = float(((g - b[name]) - (w[name] - b[name])).abs().max())
            assert err <= 1e-2 * scale, (name, err, scale)
            err = float((g - single[name].detach()).abs().max())
            assert err <= 1e-4 * scale, (name, err, scale)


@pytest.fixture(scope="module")
def voc_npy(tmp_path_factory):
    return make_learnable_voc(tmp_path_factory.mktemp("voc") / "npy", num_images=12,
                              hw=(60, 80), seed=3, image_format="npy")


def _cfg(root, **kw):
    return {**dict(dataset="voc2007", data_path=str(root), model="faster", strategy="cald",
                   tiny=True, norm="frozen", cycles=2, epochs=1, batch_size=2, init_num=4,
                   budget_num=3, score_batch_size=2, workers=0, min_size=96, max_size=128,
                   max_boxes=8, print_freq=100, aspect_ratio_group_factor=0, device="cpu"),
            **kw}


@pytest.mark.parametrize("strategy", ["cald", "ll4al", "vaal", "ssm", "ltc", "lsc"])
def test_two_rank_al_loop_histories_agree(tmp_path, voc_npy, strategy):
    """The tiny al_loop on two ranks (the JAX package's test strategies;
    VAAL's VAE at small widths): both ranks give the same history (labeled
    digests, evaluation), the labeled set grows 4 -> 7, the training epochs
    take the agreed step count, rank 0 alone writes the checkpoints."""
    cfg = _cfg(voc_npy, strategy=strategy, output_dir=str(tmp_path / "out"))
    out = worker.launch({"task": "al_loop", "cfg": cfg,
                         "vaal_sizes": dict(z_dim=8, base_width=8, image_size=64)},
                        str(tmp_path / "run"))
    strip = [[{k: v for k, v in h.items() if k not in ("time_s", "split_s")}
              for h in res["history"]] for res in out]
    assert strip[0] == strip[1]
    assert [h["labeled"] for h in out[0]["history"]] == [7, 7]
    assert out[0]["steps"] == out[1]["steps"] == out[0]["steps_run"] == out[1]["steps_run"]
    # 4 then 7 labeled images, each rank's stride of 2 and 4 at batch 2
    assert out[0]["steps"] in ([1, 2], [])
    assert out[0]["saves"] >= 2 and out[1]["saves"] == 0
    assert os.path.isdir(tmp_path / "out" / "cycle_1")


def test_two_rank_train_cli(tmp_path, voc_npy):
    """cli.train on two ranks for 2 epochs: the same losses, evaluation and
    parameters on both ranks, finite losses, ``last/`` written by rank 0
    alone (once an epoch)."""
    cfg = _cfg(voc_npy, epochs=2, output_dir=str(tmp_path / "out"))
    out = worker.launch({"task": "train", "cfg": cfg}, str(tmp_path / "run"))
    assert out[0]["losses"] == out[1]["losses"] and out[0]["eval"] == out[1]["eval"]
    assert all(np.isfinite(v) for v in out[0]["losses"].values())
    _same_on_every_rank(out, "params")
    assert (out[0]["saves"], out[1]["saves"]) == (2, 0)
    assert os.path.isfile(tmp_path / "out" / "last" / "model.pt")
