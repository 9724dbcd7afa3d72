"""The port's plain supervised trainer (``cald_tpu_torch.cli.train``) on
the CPU, on a tiny COCO tree and a tiny VOC tree: train with checkpoints,
evaluate with the dataset's protocol, and ``--resume`` from the last epoch's
checkpoint, which repeats the uninterrupted run bit for bit. Then the same
argv through the JAX package's ``cli.train.main`` and the port's, in
float32, with the JAX trainer's initial weights and sampling noise: every
epoch's batches, every step's losses and the weights after it, the epoch
carried across ``--resume``, the final detections and the evaluation held
against the JAX trainer's."""

import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cald_tpu import native as jnative
from cald_tpu.cli import train as jtrain
from cald_tpu.data.synthetic import make_learnable_voc as jmake_learnable_voc
from cald_tpu.engine.checkpoint import peek_checkpoint as jpeek_checkpoint
from cald_tpu_torch import native as tnative
from cald_tpu_torch.cli import config, driver
from cald_tpu_torch.cli import train as train_cli
from cald_tpu_torch.convert.from_flax import flax_to_state_dict
from cald_tpu_torch.data.synthetic import make_coco, make_learnable_voc
from cald_tpu_torch.engine.checkpoint import peek_checkpoint
from tests.test_torch_al_loop import BATCH_FIELDS
from tests.test_torch_train import LOSS_NAMES, JaxDraws

REPO = Path(__file__).resolve().parent.parent
# the modules: both packages' ``engine/__init__`` export the function as ``evaluate``
jevaluate_mod = importlib.import_module("cald_tpu.engine.evaluate")
evaluate_mod = importlib.import_module("cald_tpu_torch.engine.evaluate")
ARGS = ["--tiny", "--device", "cpu", "-b", "2", "--score-batch-size", "2", "--min-size", "96",
        "--max-size", "128", "--max-boxes", "8", "--aspect-ratio-group-factor", "0",
        "--print-freq", "100", "-j", "2"]


@pytest.fixture(scope="module", params=["coco", "voc2007"])
def runs(request, tmp_path_factory):
    """Two epochs uninterrupted; one epoch through ``main`` with
    ``--output-dir``, then ``--resume`` from its ``last/`` for the second."""
    dataset = request.param
    base = tmp_path_factory.mktemp(dataset)
    if dataset == "coco":
        for split, n, seed in (("train", 8, 1), ("val", 4, 2)):
            make_coco(base / "data", num_images=n, hw=[(60, 80), (80, 60)], num_classes=3,
                      seed=seed, split=split, image_format="npy")
    else:
        make_learnable_voc(base / "data", 8, (60, 80), seed=3, image_format="npy")
    argv = ARGS + ["--dataset", dataset, "--data-path", str(base / "data")]
    full = train_cli.main(argv + ["--epochs", "2", "--output-dir", str(base / "full")])
    first = train_cli.main(argv + ["--epochs", "1", "--output-dir", str(base / "part")])
    last = str(base / "part" / "last")
    meta_first = peek_checkpoint(last)[2]
    resumed = train_cli.main(argv + ["--epochs", "2", "--output-dir", str(base / "part"),
                                     "--resume", last])
    return dataset, full, first, resumed, meta_first, peek_checkpoint(last)[2]


def test_train_evaluates_with_the_datasets_protocol(runs):
    dataset, full, first, _, _, _ = runs
    assert full["start_epoch"] == 0 and sorted(full["losses"]) == [0, 1]
    assert all(np.isfinite(v) for v in full["losses"].values())
    for run in (full, first):
        if dataset == "coco":
            assert len(run["eval"]) == 12 and all(np.isfinite(v) for v in run["eval"].values())
        else:
            assert np.isfinite(run["eval"]["mAP"])
    assert first["losses"] == {0: full["losses"][0]}


def test_resume_repeats_the_uninterrupted_run(runs):
    """The epoch counter carries across the resume (meta epoch 0, then 1);
    the second epoch's loss, the weights and the evaluation equal the
    uninterrupted run's exactly."""
    _, full, _, resumed, meta_first, meta_last = runs
    assert (meta_first["epoch"], meta_last["epoch"]) == (0, 1)
    assert resumed["start_epoch"] == 1 and resumed["losses"] == {1: full["losses"][1]}
    got, want = resumed["model"].state_dict(), full["model"].state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert resumed["eval"] == full["eval"]


def test_multi_process_launch_raises_before_any_work(monkeypatch):
    def no_work(*_):
        raise AssertionError("train started work")

    monkeypatch.setattr(train_cli, "build_datasets", no_work)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    # a multi-process launch joins its process group first: here torchrun's
    # WORLD_SIZE without its MASTER_ADDR, so the rendezvous fails
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        train_cli.train(config.ALConfig(dataset="coco", device="cpu"))
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(AssertionError, match="train started work"):
        train_cli.train(config.ALConfig(dataset="coco", device="cpu"))


def test_refuses_without_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "cald_tpu_torch.cli.train", "--dataset", "coco"],
                         capture_output=True, text=True, timeout=120, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode != 0
    assert "pass --device cpu" in out.stderr


# --------------------------------------------------------------------------
# the same argv through the JAX package's trainer
# --------------------------------------------------------------------------

class JaxStepDraws:
    """The JAX trainer's sampling noise from global step ``start`` on, as a
    port ``Draw``: step s folds s into ``key(seed)`` (``train_one_epoch``),
    ``FasterRCNN.loss`` takes ``make_rng("sampling")`` from it and the
    samplers fold in 0 (RPN, streams 0/1) and 1 (box head, streams 2/3).
    A request for stream 0 starts the next step."""

    def __init__(self, jmodel, variables, seed, start):
        self.jmodel, self.variables, self.seed, self.step = jmodel, variables, seed, start - 1

    def __call__(self, stream, shape):
        if stream == 0:
            self.step += 1
            rng = jax.random.fold_in(jax.random.key(self.seed), self.step)
            key = self.jmodel.apply(self.variables, method=lambda m: m.make_rng("sampling"),
                                    rngs={"sampling": rng})
            self.draws = JaxDraws({0: jax.random.split(jax.random.fold_in(key, 0), shape[0]),
                                   2: jax.random.split(jax.random.fold_in(key, 1), shape[0])})
        return self.draws(stream, shape)


class OneDevice:
    """``jax`` as the JAX trainer sees it with one device: the test session
    asks XLA for 8 host devices, and 8-way data parallelism does not take
    the tiny runs' batch of 2."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def device_count():
        return 1


def _resolving_parser(make_parser):
    """The shared parser with ``conflict_handler="resolve"``: the JAX
    trainer adds a second ``--resume``, which the default handler refuses."""
    def make():
        parser = make_parser()
        for container in (parser, *parser._action_groups):  # noqa: SLF001
            container.conflict_handler = "resolve"
        return parser
    return make


def _host(variables):
    return flax_to_state_dict(jax.tree.map(np.array, variables))


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def _recording(mp, pkg, log):
    """Patch the trainer's ``_loaders``, ``make_train_step`` and
    ``evaluate``'s ``run_inference`` to record every loader's batches, every
    step's losses and the weights after it (as port state dicts), the
    detections and the stats."""
    module, ev = (jtrain, jevaluate_mod) if pkg == "jax" else (train_cli, evaluate_mod)
    loaders, make_step = module._loaders, module.make_train_step
    evaluate, run_inference = module.evaluate, ev.run_inference

    def rec_loaders(*a, **kw):
        batches = list(loaders(*a, **kw))
        log["batches"].append((kw["train"], batches))
        return batches

    def jax_make_step(model):
        step = make_step(model)

        def rec_step(state, *args):
            state, metrics = step(state, *args)
            log["after"].append(_host(state.variables))
            log["steps"].append(_floats(metrics))
            return state, metrics
        return rec_step

    def port_make_step(model, *a, **kw):
        step = make_step(model, *a, **kw)

        def rec_step(*args):
            metrics = step(*args)
            log["after"].append({k: v.clone() for k, v in model.state_dict().items()})
            log["steps"].append(_floats(metrics))
            return metrics
        return rec_step

    def rec_inference(*a, **kw):
        log["dets"] = run_inference(*a, **kw)
        return log["dets"]

    def rec_evaluate(*a, **kw):
        log["eval"] = evaluate(*a, **kw)
        return log["eval"]

    mp.setattr(module, "_loaders", rec_loaders)
    mp.setattr(module, "make_train_step", jax_make_step if pkg == "jax" else port_make_step)
    mp.setattr(module, "evaluate", rec_evaluate)
    mp.setattr(ev, "run_inference", rec_inference)


def _float32(build_model, rebuild):
    """``build_model`` with the model's compute dtype float32: the tiny
    CLI model computes in bf16, whose roundings differ between XLA's fused
    CPU programs and PyTorch's op-by-op kernels (bf16 parity is held block
    by block in tests/test_torch_mobilenet.py), and a training run turns
    them into other proposals within a step."""
    def build(cfg, num_classes):
        model, frozen = build_model(cfg, num_classes)
        return rebuild(model, dataclasses.replace(model.cfg, compute_dtype="float32")), frozen
    return build


@pytest.fixture(scope="module", params=["coco", "voc2007"])
def jax_runs(request, tmp_path_factory):
    """One epoch with ``--output-dir``, then ``--resume`` for the second,
    through the JAX trainer and then the port's, on one JPEG tree read by
    Pillow in both, with both models in float32 (``_float32``). The port
    starts from the JAX trainer's initial weights (``random_init_`` patched
    to load them) and draws its sampling noise (``stream_generator`` and
    ``generator_gumbel`` patched)."""
    dataset = request.param
    base = tmp_path_factory.mktemp(f"jax_{dataset}")
    if dataset == "coco":
        for split, n, seed in (("train", 8, 1), ("val", 4, 2)):
            make_coco(base / "data", num_images=n, hw=[(60, 80), (80, 60)], num_classes=3,
                      seed=seed, split=split)
    else:
        jmake_learnable_voc(base / "data", 8, (60, 80), seed=3)
    argv = ARGS + ["--dataset", dataset, "--data-path", str(base / "data")]
    logs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        mp.setattr(tnative, "available", lambda: False)
        mp.setattr(jtrain, "jax", OneDevice())
        mp.setattr(jtrain, "make_parser", _resolving_parser(jtrain.make_parser))
        mp.setattr(jtrain, "build_model", _float32(
            jtrain.build_model, lambda m, cfg: m.clone(cfg=cfg)))
        mp.setattr(driver, "build_model", _float32(
            driver.build_model, lambda m, cfg: type(m)(cfg)))
        fresh, init = jtrain._fresh_state, {}

        def rec_fresh(cfg, model, *a, **kw):
            state = fresh(cfg, model, *a, **kw)
            init.setdefault("model", model)
            init.setdefault("variables", jax.tree.map(np.array, state.variables))
            return state

        mp.setattr(jtrain, "_fresh_state", rec_fresh)
        for pkg in ("jax", "port"):
            if pkg == "port":
                steps = len(logs["jax"][0]["batches"][0][1])
                mp.setattr(driver, "random_init_", lambda model, seed: model.load_state_dict(
                    flax_to_state_dict(init["variables"]), strict=True))
                mp.setattr(driver, "stream_generator", lambda device, a, epoch: (a, epoch))
                mp.setattr(driver, "generator_gumbel", lambda seed_epoch: JaxStepDraws(
                    init["model"], init["variables"], seed_epoch[0], seed_epoch[1] * steps))
            out, main = str(base / pkg), (jtrain if pkg == "jax" else train_cli).main
            logs[pkg] = []
            for extra in (["--epochs", "1"], ["--epochs", "2", "--resume", out + "/last"]):
                log = {"batches": [], "after": [], "steps": []}
                with pytest.MonkeyPatch.context() as rec:
                    _recording(rec, pkg, log)
                    # the JAX parser has no --device: it runs where JAX does
                    main([a for a in argv if pkg == "port" or a not in ("--device", "cpu")]
                         + ["--output-dir", out] + extra)
                logs[pkg].append(log)
    return dataset, logs, base


def test_train_batches_match_jax(jax_runs):
    """Every loader of both runs, in order (the epoch's training batches
    over the whole split, shuffled by ``seed + epoch`` and flipped, then the
    test split's), equals the JAX trainer's field for field."""
    _, logs, _ = jax_runs
    for got, want in zip(logs["port"], logs["jax"]):
        assert [(t, len(b)) for t, b in got["batches"]] == \
            [(t, len(b)) for t, b in want["batches"]]
        assert [(t, len(b)) for t, b in got["batches"]][0] == (True, 4)
        for (_, tb), (_, jb) in zip(got["batches"], want["batches"]):
            for a, b in zip(tb, jb):
                for f in BATCH_FIELDS:
                    np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    train_idx = [np.sort(np.concatenate([b.image_idx for b in run["batches"][0][1]]))
                 for run in logs["port"]]
    for idx in train_idx:
        np.testing.assert_array_equal(idx, np.arange(8))


def test_train_steps_match_jax(jax_runs):
    """Every step of epoch 0, and of epoch 1 after ``--resume`` from the
    epoch-0 checkpoint: its four losses and their sum at
    test_torch_train.py's tolerance for one loss (rtol and atol 1e-5), the
    weights after it within 1e-6 (its tolerance for one SGD step). Both
    ``last`` checkpoints carry epoch 1."""
    _, logs, base = jax_runs
    for got, want in zip(logs["port"], logs["jax"]):
        assert len(got["steps"]) == len(want["steps"]) == 4
        for g, w in zip(got["steps"], want["steps"]):
            assert set(g) == set(w) == set(LOSS_NAMES) | {"loss"}
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-5, err_msg=k)
        for g, w in zip(got["after"], want["after"]):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_allclose(g[k].numpy(), w[k].numpy(), atol=1e-6, err_msg=k)
    for pkg, peek in (("port", peek_checkpoint), ("jax", jpeek_checkpoint)):
        assert peek(str(base / pkg / "last"))[2]["epoch"] == 1, pkg


def test_train_eval_matches_jax(jax_runs):
    """The evaluation after each run with the dataset's protocol: the
    detections at test_torch_al_loop.py's tolerances (labels exact, scores
    1e-3, boxes 1e-2), then every metric within 1e-6 of the JAX trainer's."""
    dataset, logs, _ = jax_runs
    for got, want in zip(logs["port"], logs["jax"]):
        assert [r["dataset_index"] for r in got["dets"]] == \
            [r["dataset_index"] for r in want["dets"]]
        for a, b in zip(got["dets"], want["dets"]):
            np.testing.assert_array_equal(a["labels"], np.asarray(b["labels"]))
            np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-3)
            np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-2)
        assert got["eval"].keys() == want["eval"].keys()
        assert dataset != "coco" or len(want["eval"]) == 12
        for k, w in want["eval"].items():
            g = got["eval"][k]
            if isinstance(w, dict):          # VOC's per_class_ap50
                assert g.keys() == w.keys(), k
                g, w = list(g.values()), list(w.values())
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
    # the first run's detector (one epoch) still finds boxes above 0.05
    assert sum(len(r["scores"]) for r in logs["jax"][0]["dets"]) > 0
