"""The port's active-learning loop (``cald_tpu_torch.cli``, ``data``,
``engine.evaluate``/``checkpoint``) held against the JAX package piece by
piece on the CPU: configuration and flags, loader batches, pool bookkeeping
and random picks, VOC evaluation, evaluation of the tiny detector with
bridged weights; then the port's own ``al_loop`` on the tiny model
(``cald``, ``random``, ``--resume``; group norm with 'FCDRGS', ``ltc``,
``lsc``; ``ssm``, ``ll4al`` and ``vaal``, the last two resumed from a cycle
checkpoint with their carry-state), the RetinaNet models (tiny through
``cli.main`` with CALD, tiny with SSM, MobileNet with LL4AL) and
``cli.main``'s refusal to run on the CPU unasked."""

import dataclasses
import functools
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cald_tpu import native
from cald_tpu.cli import config as jconfig
from cald_tpu.data import batching as jbatching
from cald_tpu.data.loader import BatchLoader as JBatchLoader
from cald_tpu.data.pool import ALPoolState as JPool
from cald_tpu.data.synthetic import make_learnable_voc as jmake_learnable_voc
from cald_tpu.data.transforms import random_horizontal_flip as jflip
from cald_tpu.data.voc import get_voc2007 as jget_voc2007
from cald_tpu.engine.evaluate import evaluate as jevaluate
from cald_tpu.engine.voc_eval import voc_evaluate_detections as jvoc_eval
from cald_tpu.strategies.cald import labeled_class_counts as jlabeled_class_counts
from cald_tpu.strategies.random_strategy import random_select as jrandom_select
from cald_tpu_torch import native as tnative
from cald_tpu_torch.cli import config, driver, main
from cald_tpu_torch.data import batching
from cald_tpu_torch.data.loader import BatchLoader
from cald_tpu_torch.data.pool import ALPoolState
from cald_tpu_torch.data.synthetic import make_learnable_voc
from cald_tpu_torch.data.transforms import random_horizontal_flip
from cald_tpu_torch.data.voc import get_voc2007
from cald_tpu_torch.engine.checkpoint import load_extra, peek_checkpoint
from cald_tpu_torch.engine.evaluate import evaluate
from cald_tpu_torch.engine.voc_eval import voc_evaluate_detections
from cald_tpu_torch.strategies.cald import labeled_class_counts
from cald_tpu_torch.strategies.random_strategy import random_select
from cald_tpu_torch.models.retinanet import RetinaNet
from cald_tpu_torch.strategies.vaal import VAALTrainer
from tests.torch_helpers import tiny_models

BATCH_FIELDS = ("images", "valid_hw", "scale", "boxes", "labels", "box_valid", "image_idx")
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """One synthetic VOC tree written by the JAX generator (JPEG) and the
    same seed written by the port's (JPEG and .npy)."""
    base = tmp_path_factory.mktemp("voc")
    roots = {"jax": jmake_learnable_voc(base / "jax", num_images=12, hw=(60, 80), seed=3),
             "jpg": make_learnable_voc(base / "jpg", num_images=12, hw=(60, 80), seed=3),
             "npy": make_learnable_voc(base / "npy", num_images=12, hw=(60, 80), seed=3,
                                       image_format="npy")}
    return roots


@pytest.fixture
def pil_decode(monkeypatch):
    """Both loaders decode JPEGs with Pillow: their native decoders, where
    built, are another codec (tests/test_torch_native.py holds the two
    native paths against each other)."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def test_config_defaults_match_jax():
    for kw in ({}, {"dataset": "voc2012"}, {"strategy": "random"}, {"model": "retina"},
               {"dataset": "coco"}, {"score_rpn_post_nms": 768}):
        want = dataclasses.asdict(jconfig.ALConfig(**kw).resolve())
        got = dataclasses.asdict(config.ALConfig(**kw).resolve())
        assert got.pop("device") == "cuda"
        assert got == want


def test_parser_matches_jax():
    def actions(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.nargs)
                for a in p._actions if a.dest != "help"}

    got, want = actions(config.make_parser()), actions(jconfig.make_parser())
    assert got.pop("device")[:2] == (("--device",), "cuda")
    assert got == want
    argv = ["--tiny", "--strategy", "random", "--lr-steps", "3", "4", "-b", "2", "--no-eval",
            "--init-num", "5"]
    want_cfg = dataclasses.asdict(jconfig.build_config_from_args(argv))
    got_cfg = dataclasses.asdict(config.build_config_from_args(argv + ["--device", "cpu"]))
    assert got_cfg.pop("device") == "cpu"
    assert got_cfg == want_cfg


def test_synthetic_matches_jax(voc):
    """Same annotations; the JPEGs are byte for byte the JAX generator's and
    the .npy images its pixels before encoding."""
    jds = jget_voc2007(voc["jax"], "trainval")
    for fmt in ("jpg", "npy"):
        ds = get_voc2007(voc[fmt], "trainval")
        assert len(ds) == len(jds) == 12
        for i in range(len(ds)):
            a, b = ds.record(i), jds.record(i)
            assert (a.image_id, a.width, a.height) == (b.image_id, b.width, b.height)
            for f in ("boxes", "labels", "difficult"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            if fmt == "jpg":
                assert Path(a.image_path).read_bytes() == Path(b.image_path).read_bytes()
            else:
                img = np.load(a.image_path)
                assert img.dtype == np.uint8 and img.shape == (60, 80, 3)


@pytest.mark.parametrize("size", [(375, 500, 600, 800), (60, 80, 96, 128), (90, 60, 128, 85),
                                  (100, 100, 37, 53), (50, 60, 50, 120)])
def test_resize_is_pillow(rng, size):
    """The NumPy bilinear resize equals Pillow's, up- and down-scaling."""
    h, w, oh, ow = size
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    np.testing.assert_array_equal(batching.resize_image(img, oh, ow),
                                  jbatching.resize_image(img, oh, ow))


@pytest.mark.parametrize("train", [True, False])
def test_loader_batches_match_jax(voc, pil_decode, train):
    """Shuffled, grouped, flipped batches (a training epoch's) and the plain
    ones (evaluation's) equal the JAX loader's field for field."""
    jds, ds = jget_voc2007(voc["jax"], "trainval"), get_voc2007(voc["jpg"], "trainval")
    seed = 7 * 1000 + 1
    groups = batching.create_aspect_ratio_groups(ds.aspect_ratios(), 3)
    np.testing.assert_array_equal(groups, jbatching.create_aspect_ratio_groups(
        jds.aspect_ratios(), 3))
    idx = [0, 2, 3, 5, 7, 8, 9, 11, 4]
    rng = (lambda: np.random.default_rng(seed)) if train else (lambda: None)
    common = dict(min_size=96, max_size=128, max_boxes=8, num_workers=2, seed=seed)
    jl = JBatchLoader(jds, jbatching.grouped_batch_indices(idx, groups, 2, rng()),
                      canvases=jbatching.default_canvases(96, 128),
                      transform=jflip if train else None, **common)
    tl = BatchLoader(ds, batching.grouped_batch_indices(idx, groups, 2, rng()),
                     canvases=batching.default_canvases(96, 128),
                     transform=random_horizontal_flip if train else None, **common)
    jb, tb = list(jl), list(tl)
    assert len(jb) == len(tb) == 5
    for a, b in zip(tb, jb):
        for f in BATCH_FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_loader_reads_npy(voc):
    """The .npy tree gives the batches of the JPEG tree up to JPEG's loss."""
    ds, dj = get_voc2007(voc["npy"], "trainval"), get_voc2007(voc["jpg"], "trainval")
    args = dict(canvases=batching.default_canvases(96, 128), min_size=96, max_size=128,
                max_boxes=8, num_workers=0)
    a = next(iter(BatchLoader(ds, [[0, 1]], **args)))
    b = next(iter(BatchLoader(dj, [[0, 1]], **args)))
    for f in BATCH_FIELDS[1:]:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert np.abs(a.images - b.images).mean() < 8.0


def test_pool_and_random_picks_match_jax():
    for n, k, seed in ((40, 10, 0), (17, 5, 3)):
        want, got = JPool.initial(n, k, seed), ALPoolState.initial(n, k, seed)
        np.testing.assert_array_equal(got.labeled, want.labeled)
        np.testing.assert_array_equal(got.unlabeled, want.unlabeled)
        for cap in (4, 100):
            a = got.subsample_pool(cap, np.random.default_rng(seed + 100))
            b = want.subsample_pool(cap, np.random.default_rng(seed + 100))
            np.testing.assert_array_equal(a, b)
        picks = random_select(len(got.unlabeled), 3, np.random.default_rng(seed))
        np.testing.assert_array_equal(
            picks, jrandom_select(len(want.unlabeled), 3, np.random.default_rng(seed)))
        got, want = got.select(got.unlabeled[picks]), want.select(want.unlabeled[picks])
        for field in ("labeled", "unlabeled"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        back = ALPoolState.from_dict(got.to_dict())
        assert got.to_dict().keys() == want.to_dict().keys()
        assert (back.cycle, back.seed) == (got.cycle, got.seed) == (want.cycle, want.seed)
        np.testing.assert_array_equal(back.labeled, got.labeled)


def test_labeled_class_counts_match_jax(voc):
    ds = get_voc2007(voc["jpg"], "trainval")
    np.testing.assert_array_equal(labeled_class_counts(ds, [0, 3, 4, 9], 20),
                                  jlabeled_class_counts(ds, [0, 3, 4, 9], 20))


def test_voc_eval_matches_jax(voc, rng):
    ds = get_voc2007(voc["jpg"], "test")
    results = []
    for i in range(len(ds)):
        rec = ds.record(i)
        n = int(rng.integers(0, 6))
        jitter = rng.normal(0, 4, (n, 4)).astype(np.float32)
        src = rec.boxes[rng.integers(0, len(rec.boxes), n)] if n else np.zeros((0, 4))
        results.append({"image_id": rec.image_id, "boxes": src + jitter,
                        "scores": rng.uniform(0, 1, n), "labels": rng.integers(1, 4, n)})
    got = voc_evaluate_detections(results, ds, print_fn=lambda *_: None)
    want = jvoc_eval(results, ds, print_fn=lambda *_: None)
    assert got == want and got["mAP"] > 0


def test_evaluate_matches_jax(voc, pil_decode):
    """``evaluate`` of the tiny detector with bridged weights against the JAX
    package's: detections at tests/test_golden_parity.py's tolerances, then
    the same VOC metrics."""
    jmodel, variables, tmodel = tiny_models()
    ds = get_voc2007(voc["jpg"], "test")
    batches = [[0, 1, 2], [3, 4, 5]]
    args = dict(canvases=batching.default_canvases(96, 128), min_size=96, max_size=128,
                max_boxes=8, num_workers=0)
    from cald_tpu.engine.evaluate import run_inference as jrun
    from cald_tpu_torch.engine.evaluate import run_inference

    got = run_inference(tmodel, BatchLoader(ds, batches, **args), device="cpu")
    want = jrun(jmodel, variables, JBatchLoader(ds, batches, **args))
    assert [r["dataset_index"] for r in got] == [r["dataset_index"] for r in want]
    assert sum(len(r["scores"]) for r in got) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["labels"], np.asarray(b["labels"]))
        np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-3)
        np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-2)
    quiet = lambda *_: None  # noqa: E731
    m_got = evaluate(tmodel, BatchLoader(ds, batches, **args), ds, kind="voc", device="cpu",
                     print_fn=quiet)
    m_want = jevaluate(jmodel, variables, JBatchLoader(ds, batches, **args), ds, kind="voc",
                       print_fn=quiet)
    for k in ("mAP", "AP50", "AP75", "recall"):
        assert abs(m_got[k] - m_want[k]) < 1e-6, k
    # COCO runs (tests/test_torch_coco.py holds it against the JAX package):
    # its 12 stats over the VOC records
    m_coco = evaluate(tmodel, BatchLoader(ds, batches, **args), ds, kind="coco", device="cpu",
                      print_fn=quiet)
    assert len(m_coco) == 12 and all(np.isfinite(v) for v in m_coco.values())


def _cfg(root, **kw):
    base = dict(dataset="voc2007", data_path=root, model="faster", strategy="cald",
                tiny=True, norm="frozen", cycles=2, epochs=1, batch_size=2, init_num=4,
                budget_num=3, score_batch_size=2, workers=2, min_size=96, max_size=128,
                max_boxes=8, print_freq=100, aspect_ratio_group_factor=0, device="cpu")
    base.update(kw)
    return config.ALConfig(**base)


def _digest(labeled):
    return hashlib.sha1(np.sort(np.asarray(labeled)).tobytes()).hexdigest()[:12]


@pytest.fixture(scope="module")
def cald_run(voc, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("al_out"))
    return out, driver.al_loop(_cfg(voc["npy"], output_dir=out))


def test_al_loop_cald(cald_run):
    out, history = cald_run
    assert [h["cycle"] for h in history] == [0, 1]
    assert history[0]["labeled"] == 4 + 3 == history[1]["labeled"]
    for h in history:
        assert np.isfinite(h["eval"]["mAP"]) and set(h["split_s"]) == {"train", "eval", "score"}
    assert sorted(os.listdir(out)) == ["cycle_0", "cycle_1"]
    assert sorted(os.listdir(os.path.join(out, "cycle_0"))) == ["al.pt", "model.pt",
                                                                "optimizer.pt"]


def test_al_loop_resume_is_identical(cald_run, voc):
    """--resume from cycle_0: cycle 0's selection from the saved model, then
    cycle 1 retrained: the history equals the uninterrupted run's."""
    out, history = cald_run
    resumed = driver.al_loop(_cfg(voc["npy"], resume=os.path.join(out, "cycle_0")))
    assert resumed[0]["eval"] == {"resumed": True}
    assert resumed[0]["labeled_digest"] == history[0]["labeled_digest"]
    for key in ("labeled", "labeled_digest", "eval"):
        assert resumed[1][key] == history[1][key], key


def test_al_loop_random_matches_jax_picks(voc):
    """The random strategy's labeled sets are those of the JAX package's
    pool and random functions with ``al_loop``'s streams."""
    cfg = _cfg(voc["npy"], strategy="random", cycles=3, budget_num=2, eval_every_cycle=False)
    history = driver.al_loop(cfg)
    pool = JPool.initial(12, 4, 0)
    want = []
    for cycle in range(3):
        if cycle < 2:
            rng = np.random.default_rng(0 + 100 + cycle)
            subset = pool.unlabeled.copy()
            pool = pool.select(subset[jrandom_select(len(subset), 2, rng)])
        want.append(_digest(pool.labeled))
    assert [h["labeled_digest"] for h in history] == want
    assert [h["labeled"] for h in history] == [6, 8, 8]


def test_unported_options_raise(voc, monkeypatch):
    """The port runs every option of the JAX package: --score-shrink-slice
    passes the checks and COCO runs (its datasets are built, and read from
    the tree, which a VOC root lacks). A multi-process launch joins its
    process group before any work (here torchrun's WORLD_SIZE without its
    MASTER_ADDR: the rendezvous fails first). An unknown model is a
    ValueError."""
    with pytest.raises(FileNotFoundError, match="instances_train2017.json"):
        driver.build_datasets(_cfg(voc["npy"], dataset="coco").resolve())
    driver._check_supported(_cfg(voc["npy"], dataset="coco").resolve())
    driver._check_supported(_cfg(voc["npy"], score_shrink_slice=True).resolve())
    _no_work(monkeypatch)
    for kw in ({"dataset": "coco"}, {"score_shrink_slice": True}):
        with pytest.raises(AssertionError, match="al_loop started work"):
            driver.al_loop(_cfg(voc["npy"], **kw))
    with monkeypatch.context() as m:
        m.setenv("WORLD_SIZE", "2")
        m.delenv("MASTER_ADDR", raising=False)
        with pytest.raises(ValueError, match="MASTER_ADDR"):
            driver.al_loop(_cfg(voc["npy"]))
    with pytest.raises(ValueError, match="unknown model"):
        driver.al_loop(_cfg(voc["npy"], model="yolo"))
    with pytest.raises(ValueError, match="unknown model"):
        driver.build_model(_cfg(voc["npy"], model="yolo").resolve(), 21)


def _no_work(monkeypatch):
    def no_work(*_):
        raise AssertionError("al_loop started work")

    monkeypatch.setattr(driver, "build_datasets", no_work)


def test_pretrained_backbone_with_group_norm_raises_before_any_work(monkeypatch):
    """A group-norm backbone has no FrozenBatchNorm statistics to import:
    ValueError before any dataset is read (the JAX package fails later,
    in its importer)."""
    _no_work(monkeypatch)
    cfg = _cfg("unused", norm="group", pretrained_backbone="backbone.pt")
    with pytest.raises(ValueError, match="--norm group"):
        driver.al_loop(cfg)
    driver._check_supported(_cfg("unused", norm="group").resolve())
    driver._check_supported(_cfg("unused", augs="FCDRGS").resolve())


@pytest.mark.parametrize("kw", [dict(norm="group", strategy="cald", augs="FCDRGS"),
                                dict(strategy="ltc"), dict(strategy="lsc")],
                         ids=["group-cald-FCDRGS", "ltc", "lsc"])
def test_al_loop_new_options_grow_by_the_budget(voc, kw):
    """Two cycles of the tiny model with each option this slice adds:
    labeled 4 -> 7 (budget 3) and a finite mAP in each cycle."""
    history = driver.al_loop(_cfg(voc["npy"], **kw))
    assert [h["labeled"] for h in history] == [7, 7]
    assert all(np.isfinite(h["eval"]["mAP"]) for h in history)


# VAAL at small widths (the reference's 128..1024 at 256x256 runs on the card)
SMALL_VAAL = dict(z_dim=16, base_width=8, image_size=64)


@pytest.fixture(scope="module", params=["ssm", "ll4al", "vaal"])
def strategy_run(request, voc, tmp_path_factory):
    """Three cycles of the tiny model with one strategy (LL4AL's first epoch
    joint, its second detached), then a run resumed from the cycle_1
    checkpoint; the trainings of each run are counted."""
    strategy = request.param
    out = str(tmp_path_factory.mktemp(f"{strategy}_out"))
    kw = dict(strategy=strategy, cycles=3, epochs=2, task_epochs=1)
    trained = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(driver, "VAALTrainer", functools.partial(VAALTrainer, **SMALL_VAAL))
        for name in ("train_cycle", "_train_cycle_ll4al", "_train_cycle_vaal"):
            fn = getattr(driver, name)
            mp.setattr(driver, name, functools.partial(
                lambda fn, *a, **k: trained.append(k["cycle"]) or fn(*a, **k), fn))
        full = driver.al_loop(_cfg(voc["npy"], output_dir=out, **kw))
        trained_full, trained[:] = list(trained), []
        resumed = driver.al_loop(_cfg(voc["npy"], resume=os.path.join(out, "cycle_1"), **kw))
    return strategy, out, full, resumed, trained_full, list(trained)


def test_al_loop_strategies_grow_by_the_budget(strategy_run):
    """labeled 4 -> 7 -> 10 (budget 3), a finite mAP per cycle, every cycle
    trained once."""
    _, _, full, _, trained, _ = strategy_run
    assert [h["labeled"] for h in full] == [7, 10, 10]
    assert all(np.isfinite(h["eval"]["mAP"]) for h in full)
    assert trained == [0, 1, 2]


def test_al_loop_strategies_resume_bit_identical(strategy_run):
    """Resumed from cycle_1: cycle 1's selection from the restored model and
    carry-state without retraining it, then cycle 2 trained: labeled sets
    and cycle 2's evaluation equal the uninterrupted run's bit for bit."""
    strategy, out, full, resumed, _, trained = strategy_run
    assert resumed[0] == {"cycle": 0, "resumed": True}
    assert resumed[1]["eval"] == {"resumed": True}
    assert trained == [2]
    for c in (1, 2):
        assert resumed[c]["labeled_digest"] == full[c]["labeled_digest"], c
    assert resumed[2]["eval"] == full[2]["eval"]
    carry = load_extra(os.path.join(out, "cycle_1"))
    meta = peek_checkpoint(os.path.join(out, "cycle_1"))[2]
    want = {"ssm": set(), "ll4al": {"ll_params"}, "vaal": {"vaal_vae", "vaal_d"}}[strategy]
    assert set(carry) == want
    # SSM's adapted thresholds ride in meta from cycle 1 on (cycle 0 adapted them)
    assert ("ssm_gamma" in meta) == (strategy == "ssm")
    if strategy == "ssm":
        assert meta["ssm_gamma"] == pytest.approx(0.2)
        assert np.isfinite(np.asarray(meta["ssm_clslambda"])).all()


def test_al_loop_resume_without_carry_retrains(voc, tmp_path):
    """An ll4al checkpoint without ``extra`` (as one from the cald strategy):
    the cycle is retrained, and its selection is the uninterrupted run's."""
    out = str(tmp_path / "out")
    kw = dict(strategy="ll4al", cycles=2, task_epochs=0)
    full = driver.al_loop(_cfg(voc["npy"], output_dir=out, **kw))
    ckpt = os.path.join(out, "cycle_0")
    al = torch.load(os.path.join(ckpt, "al.pt"), weights_only=True)
    torch.save({**al, "extra": {}}, os.path.join(ckpt, "al.pt"))
    resumed = driver.al_loop(_cfg(voc["npy"], resume=ckpt, **kw))
    assert resumed[0]["eval"] == full[0]["eval"]
    assert resumed[0]["labeled_digest"] == full[0]["labeled_digest"]


def test_skip_runs_vaal_adversary_alone_and_refuses_ll4al(voc, tmp_path, monkeypatch):
    """--skip with vaal loads the first-cycle model and runs the adversary
    epochs alone (the reference's --skip path); with ll4al it raises
    ValueError, the checkpoint holding no LossNet."""
    monkeypatch.setattr(driver, "VAALTrainer", functools.partial(VAALTrainer, **SMALL_VAAL))
    kw = dict(strategy="vaal", cycles=1, epochs=2, first_checkpoint_path=str(tmp_path))
    trained = driver.al_loop(_cfg(voc["npy"], **kw))
    epochs = []
    adversary = driver._vaal_adversary_epoch
    monkeypatch.setattr(driver, "_vaal_adversary_epoch",
                        lambda *a, **k: epochs.append(k["epoch"]) or adversary(*a, **k))
    monkeypatch.setattr(driver, "_train_cycle_vaal", None)      # must not train
    skipped = driver.al_loop(_cfg(voc["npy"], skip=True, **kw))
    assert skipped[0]["eval"] == trained[0]["eval"] and epochs == [0, 1]
    with pytest.raises(ValueError, match="--skip with ll4al"):
        driver.al_loop(_cfg(voc["npy"], skip=True, **{**kw, "strategy": "ll4al"}))


@pytest.mark.parametrize("strategy", ["ltc", "lsc"])
def test_baseline_selection_is_the_stable_ascending_argsort(voc, monkeypatch, strategy):
    """score_and_select takes the budget lowest scores, ties in pool order
    (JAX's ``np.argsort(s, kind="stable")[:budget]``)."""
    cfg = _cfg(voc["npy"], strategy=strategy, budget_num=4).resolve()
    pool = ALPoolState.initial(12, 4, cfg.seed)
    scores = np.array([0.5, 0.25, 0.5, 0.25, 0.0, 0.25, 0.5, 0.0])
    name = "run_ltc" if strategy == "ltc" else "lsc_scores"
    monkeypatch.setattr(driver, name, lambda *a, **k: scores)
    ds = get_voc2007(voc["npy"], "trainval")
    chosen = driver.score_and_select(
        cfg, None, ds, pool, batching.default_canvases(96, 128),
        batching.create_aspect_ratio_groups(ds.aspect_ratios(), 0), cycle=0,
        device=torch.device("cpu"))
    np.testing.assert_array_equal(chosen, pool.unlabeled[[4, 7, 1, 3]])


def test_stream_generators_are_seeded():
    a = driver.stream_generator(torch.device("cpu"), 17, 1)
    b = driver.stream_generator(torch.device("cpu"), 17, 1)
    c = driver.stream_generator(torch.device("cpu"), 17, 2)
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    assert not torch.equal(torch.rand(4, generator=b), torch.rand(4, generator=c))


def test_main_refuses_cpu_unasked(voc):
    """Without CUDA and without --device cpu the entry point exits non-zero
    with a message and runs nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "cald_tpu_torch.cli.main", "--tiny",
                          "--data-path", voc["npy"], "--cycles", "1"], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode != 0
    assert "--device cpu" in out.stderr
    assert "cycle" not in out.stdout


def test_scoring_model_trims_share_the_weights():
    cfg = config.ALConfig(tiny=True, score_rpn_pre_nms=100, score_rpn_post_nms=32).resolve()
    model, frozen = driver.build_model(cfg, 21)
    assert frozen == ()
    variant = driver._scoring_model(cfg, model)
    assert (variant.cfg.rpn_pre_nms_top_n_test, variant.cfg.rpn_post_nms_top_n_test) == (100, 32)
    assert variant.cfg.rpn_post_nms_top_n_train == model.cfg.rpn_post_nms_top_n_train
    assert model.cfg.rpn_post_nms_top_n_test == 64
    assert variant.backbone.conv1.weight is model.backbone.conv1.weight
    assert driver._scoring_model(config.ALConfig(tiny=True).resolve(), model) is model
    r50, frozen = driver.build_model(config.ALConfig().resolve(), 21)
    assert frozen == ("backbone.conv1", "backbone.layer1")


def test_main_runs_tiny_retina_on_the_cpu(voc):
    """``cli.main`` with ``--model retina --tiny --device cpu``: two cycles
    of CALD, labeled 4 -> 7, a finite mAP per cycle."""
    history = main.main(["--model", "retina", "--tiny", "--device", "cpu", "--data-path",
                         voc["npy"], "--cycles", "2", "--epochs", "1", "-b", "2",
                         "--init-num", "4", "--budget-num", "3", "--score-batch-size", "2",
                         "--min-size", "96", "--max-size", "128", "--max-boxes", "8",
                         "--workers", "2", "--aspect-ratio-group-factor", "0"])
    assert [h["labeled"] for h in history] == [7, 7]
    assert all(np.isfinite(h["eval"]["mAP"]) for h in history)


@pytest.mark.parametrize("model,kw", [
    ("retina", dict(tiny=True, strategy="ssm")),
    ("retina_mobilenet", dict(tiny=False, strategy="ll4al", task_epochs=0)),
], ids=["retina-tiny-ssm", "retina_mobilenet-ll4al"])
def test_al_loop_retina_models_grow_by_the_budget(voc, monkeypatch, model, kw):
    """Two cycles of each RetinaNet on the 96x128 canvas: labeled 4 -> 7,
    finite mAP and losses. SSM detects the pool with the NMS-0.3 variant
    through RetinaNet's own postprocess (the weights shared); LL4AL's
    LossNet reads retina_mobilenet's one level."""
    seen = []
    pool_detections = driver._ssm_pool_detections
    monkeypatch.setattr(driver, "_ssm_pool_detections",
                        lambda m, *a: seen.append(m) or pool_detections(m, *a))
    history = driver.al_loop(_cfg(voc["npy"], model=model, **kw))
    assert [h["labeled"] for h in history] == [7, 7]
    assert all(np.isfinite(h["eval"]["mAP"]) for h in history)
    if kw["strategy"] == "ssm":
        (ssm_model,) = seen
        assert ssm_model.cfg.nms_thresh == 0.3 and not hasattr(ssm_model.cfg, "ssm_mode")
        assert isinstance(ssm_model, RetinaNet)


def test_build_model_frozen_prefixes_lossnet_levels_and_retina_trim():
    """The JAX driver's model table: conv1/layer1 frozen for the ResNet-50
    models under frozen norms, nothing for tiny, group-norm or MobileNet
    models; the tiny RetinaNet's counts; LossNet over the first 4 levels of
    each pyramid; ``--score-rpn-post-nms`` trims RetinaNet's
    ``topk_candidates`` (capped at the model's own) and shares the weights."""
    frozen = ("backbone.conv1", "backbone.layer1")
    table = {("retina", False, "frozen"): frozen, ("retina", True, "frozen"): (),
             ("retina", False, "group"): (), ("faster_mobilenet", False, "frozen"): (),
             ("retina_mobilenet", False, "frozen"): ()}
    levels = {"retina": 4, "faster_mobilenet": 3, "retina_mobilenet": 1, "faster": 4}
    for (name, tiny, norm), want in table.items():
        cfg = config.ALConfig(model=name, tiny=tiny, norm=norm, device="cpu").resolve()
        model, got = driver.build_model(cfg, 21)
        assert got == want, (name, tiny, norm)
        lossnet = driver._new_lossnet(model, cfg, "cpu")
        assert lossnet.num_levels == levels[name]
    cfg = config.ALConfig(model="retina", tiny=True, score_rpn_post_nms=32).resolve()
    model, _ = driver.build_model(cfg, 21)
    assert (model.cfg.topk_candidates, model.cfg.detections_per_img) == (64, 16)
    assert model.cfg.anchor_sizes == ((16, 20),) * 5
    variant = driver._scoring_model(cfg, model)
    assert variant.cfg.topk_candidates == 32 and model.cfg.topk_candidates == 64
    assert variant.head.cls_logits.weight is model.head.cls_logits.weight
    wide = dataclasses.replace(cfg, score_rpn_post_nms=100)
    assert driver._scoring_model(wide, model) is model
    mobile, _ = driver.build_model(config.ALConfig(model="faster_mobilenet").resolve(), 21)
    assert mobile.cfg.anchor_sizes == ((32, 64, 128, 256, 512),)
    assert mobile.cfg.strides == (32, 32, 64)


def _trace_spans(prof_dir) -> list[dict]:
    """The program's spans in a --profile-dir trace: the events of the
    process row named ``cald_tpu_torch spans``."""
    assert os.listdir(prof_dir) == ["cycle_0_trace.json"]
    with open(os.path.join(prof_dir, "cycle_0_trace.json")) as f:
        events = json.load(f)["traceEvents"]
    pid = next(e["pid"] for e in events if e.get("ph") == "M"
               and e.get("args", {}).get("name") == "cald_tpu_torch spans")
    return [e for e in events if e.get("pid") == pid and e.get("ph") == "X"]


def test_skip_reuses_the_first_cycle_and_profile_writes_a_trace(voc, tmp_path):
    """--first-checkpoint-path saves cycle 0's model with its split; --skip
    loads it instead of training (same evaluation); --profile-dir writes the
    first cycle's chrome trace, the program's spans (``al.*``, and with a
    selection ``score.*`` and the detectors') in a row of their own."""
    first = str(tmp_path / "first")
    kw = dict(cycles=1, first_checkpoint_path=first)
    trained = driver.al_loop(_cfg(voc["npy"], profile_dir=str(tmp_path / "prof"), **kw))
    assert os.path.isfile(os.path.join(first, "voc2007_faster_1st", "model.pt"))
    assert os.listdir(tmp_path / "prof") == ["cycle_0_trace.json"]
    rows = _trace_spans(tmp_path / "prof")
    al = {e["name"]: e for e in rows if e["name"].startswith("al.")}
    assert set(al) == {"al.cycle", "al.train", "al.eval", "al.score"}
    split = trained[0]["split_s"]
    for phase in ("train", "eval", "score"):
        assert al[f"al.{phase}"]["args"]["parent"] == al["al.cycle"]["args"]["id"]
        assert al[f"al.{phase}"]["dur"] == pytest.approx(split[phase] * 1e6, abs=1e-3)
    skipped = driver.al_loop(_cfg(voc["npy"], skip=True, seed=5, **kw))
    assert skipped[0]["eval"] == trained[0]["eval"]
    assert skipped[0]["labeled_digest"] == trained[0]["labeled_digest"]

    # a profiled cycle that scores the pool: the score batches' spans under al.score
    driver.al_loop(_cfg(voc["npy"], skip=True, first_checkpoint_path=first,
                        profile_dir=str(tmp_path / "prof_score")))
    rows = _trace_spans(tmp_path / "prof_score")
    ids = {e["args"]["id"]: e for e in rows}
    names = {e["name"] for e in rows}
    assert {"al.cycle", "al.train", "al.eval", "al.score", "score.batch", "score.base_detect",
            "score.reference", "score.augment", "score.aug_detect", "score.consistency",
            "score.to_host", "detect.trunk", "detect.rpn", "detect.box_head",
            "detect.postprocess", "nms", "loader.build"} <= names
    for e in rows:
        if e["name"] == "score.batch":
            assert ids[e["args"]["parent"]]["name"] == "al.score"
            assert ids[e["args"]["parent"]]["ts"] <= e["ts"]
        if e["name"] == "nms":
            assert e["args"]["nms.sweeps"] >= 1
