"""The selection experiments of the port against the JAX package's scripts
(``experiments/scoring_deviation.py``, ``experiments/consistency_separation.py``,
loaded by path): the scenes bit for bit, the separation statistics, and the
CPU half of the selection gate, in which both packages score one pool with
the same weights and the same augmentation draws in float32 and select
from it; then a run of each entry point at a tiny cut on the CPU."""

from __future__ import annotations

import importlib.util
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cald_tpu.strategies import cald as jcald
from cald_tpu_torch.experiments import consistency_separation as cs
from cald_tpu_torch.experiments import scoring_deviation as sd
from cald_tpu_torch.strategies import cald
from tests.test_torch_cald import jax_draw
from tests.torch_helpers import tiny_models

ROOT = Path(__file__).resolve().parent.parent
GATE_HW = (96, 128)
GATE_POOL = 32
GATE_BATCH = 8
GATE_BUDGET = 8
GATE_KEY = 7000
# the gate's limits on the CPU (f32 on both sides, the same weights and draws)
MAX_DC = 1e-4               # |consistency, port - JAX|, every image
MIN_JACCARD = 0.9           # selection Jaccard, port vs JAX
GATE_FPN = 32


def load_script(name: str):
    """The JAX package's experiment script ``experiments/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "experiments" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jsd():
    return load_script("scoring_deviation")


def test_scenes_match_at_full_size(jsd):
    """make_scene and batch_scenes at 600x1000 on the 640x1024 canvas."""
    want = jsd.make_scene(np.random.default_rng(4))
    got = sd.make_scene(np.random.default_rng(4))
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    want = jsd.batch_scenes(np.random.default_rng(11), 2)
    got = sd.batch_scenes(np.random.default_rng(11), 2)
    assert got[0].shape == (2, 640, 1024, 3)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_scenes_match_at_a_small_size(jsd, monkeypatch):
    """``hw`` gives the JAX script's scenes with its VALID (and CANVAS) set
    to that size; the labeled histogram draws as batch_scenes does."""
    monkeypatch.setattr(jsd, "VALID", GATE_HW)
    monkeypatch.setattr(jsd, "CANVAS", sd.canvas_for(GATE_HW))
    want = jsd.batch_scenes(np.random.default_rng(2), 12)
    got = sd.batch_scenes(np.random.default_rng(2), 12, GATE_HW)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    _, _, _, labels, valid = jsd.batch_scenes(rng_a, 30)
    counts = np.zeros((30, sd.NUM_CLASSES - 1))
    for i in range(30):
        for label in labels[i][valid[i]]:
            counts[i, label - 1] += 1
    np.testing.assert_array_equal(sd.labeled_class_mean(rng_b, 30, GATE_HW), counts.mean(0))
    assert rng_a.random() == rng_b.random()


def test_canvas_for():
    assert sd.canvas_for(sd.VALID) == sd.CANVAS
    assert sd.canvas_for((96, 128)) == (128, 128)


@pytest.mark.parametrize("seed", [0, 1])
def test_separation_matches(seed):
    """auc and the separation statistics against the JAX script's formulas
    on seeded scores (ties included)."""
    jcs = load_script("consistency_separation")
    rng = np.random.default_rng(seed)
    consistency = np.round(rng.uniform(0, 1, 60), 2)
    hard = rng.random(60) < 0.3
    assert cs.auc(consistency[hard], consistency[~hard]) == jcs.auc(consistency[hard],
                                                                     consistency[~hard])
    budget, sel_hard = 10, 0.5
    got = cs.separation(consistency, hard, sel_hard, budget)
    base = float(hard.mean())
    rand_std = float(np.sqrt(base * (1 - base) / budget * (60 - budget) / 59))
    assert got == {
        "auc_hard_vs_easy": round(jcs.auc(-consistency[hard], -consistency[~hard]), 4),
        "mean_consistency_hard": round(float(consistency[hard].mean()), 4),
        "mean_consistency_easy": round(float(consistency[~hard].mean()), 4),
        "sel_hard_frac": 0.5, "pool_hard_frac": round(base, 4),
        "rand_sel_std": round(rand_std, 4),
        "enrichment_sigma": round((sel_hard - base) / rand_std, 2)}


def jaccard(a, b) -> float:
    a, b = set(np.asarray(a).tolist()), set(np.asarray(b).tolist())
    return len(a & b) / len(a | b)


@pytest.fixture(scope="module")
def gate():
    """One pool of 32 scenes at 96x128 scored by both packages' CALD on the
    tiny detector (f32, heads amplified, one seeded Flax init carried across
    by the weight bridge), with JAX's draws for batch i being
    ``fold_in(key, i)`` as in the JAX script; JAX also with the second key,
    its re-roll floor. ``score`` scores the pool with another pair of
    models on the same weights and draws."""
    jmodel, variables, tmodel = tiny_models(num_classes=sd.NUM_CLASSES, fpn_channels=GATE_FPN)
    rng = np.random.default_rng(5)
    images, valid_hw, *_ = sd.batch_scenes(rng, GATE_POOL, GATE_HW)
    labeled_mean = sd.labeled_class_mean(rng, 100, GATE_HW)
    key = jax.random.key(GATE_KEY)

    def jax_scores(model, k):
        jfn = jcald.make_cald_score_fn(model, jcald.CALDConfig(), sd.NUM_CLASSES)
        out = [jfn(variables, jnp.asarray(images[i:i + GATE_BATCH]),
                   jnp.asarray(valid_hw[i:i + GATE_BATCH]), jax.random.fold_in(k, i))
               for i in range(0, GATE_POOL, GATE_BATCH)]
        return (np.concatenate([np.asarray(c, np.float64) for c, _ in out]),
                np.concatenate([np.asarray(r, np.float64) for _, r in out]))

    def port_scores(model):
        return sd.score_pool(model, images, valid_hw, rpn_pre=0, rpn_post=0, shrink=False,
                             score_batch=GATE_BATCH, key=GATE_KEY,
                             draw_at=lambda i: jax_draw(jax.random.fold_in(key, i)))

    ccfg = cald.CALDConfig()

    def select(scores, select_fn):
        return select_fn(*scores, labeled_mean, GATE_BUDGET, ccfg)

    def score(jax_model, port_model):
        j, p = jax_scores(jax_model, key), port_scores(port_model)
        return {"jax": j, "port": p, "sel_jax": select(j, jcald.cald_select),
                "sel_port": select(p, cald.cald_select)}

    j_b = jax_scores(jmodel, jax.random.fold_in(key, sd.ALT_KEY))
    return {**score(jmodel, tmodel), "jax_b": j_b, "sel_jax_b": select(j_b, jcald.cald_select),
            "score": score, "state_dict": tmodel.state_dict()}


def test_gate_fixture_is_not_degenerate(gate):
    for name in ("jax", "jax_b", "port"):
        c = gate[name][0]
        assert np.isfinite(c).all() and c.min() >= 0 and c.max() <= 1
        assert np.mean(c == 0) < 0.5, f"{name}: most images have no detection"
    assert np.ptp(gate["jax"][0]) > 0.05


def test_gate_scores_match(gate):
    np.testing.assert_allclose(gate["port"][0], gate["jax"][0], atol=MAX_DC, rtol=0)


def test_gate_selection_matches(gate):
    """The port's selection against JAX's on the same draws is at least
    MIN_JACCARD, and at or above JAX's own re-roll floor."""
    floor = jaccard(gate["sel_jax"], gate["sel_jax_b"])
    got = jaccard(gate["sel_port"], gate["sel_jax"])
    assert len(gate["sel_port"]) == GATE_BUDGET
    assert got >= MIN_JACCARD, (got, floor)
    assert got >= floor, (got, floor)


def test_gate_in_bf16(gate, capsys):
    """The same pool, weights and draws scored in bfloat16 by both packages
    (un-jitted Flax and the port: a rounding after every layer, in
    different places). The port's bf16 consistency differs from JAX's bf16
    by no more than twice what JAX's bf16 differs from its own float32:
    the packages' bf16 paths part by bf16 rounding, not by a difference of
    the scorers. Prints the selection Jaccards against JAX's float32
    re-roll floor."""
    from cald_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
    from cald_tpu.models.faster_rcnn import FasterRCNNConfig as JaxConfig
    from cald_tpu_torch.models.faster_rcnn import FasterRCNN, FasterRCNNConfig
    from tests.torch_helpers import TINY

    cfg = {**TINY, "num_classes": sd.NUM_CLASSES, "fpn_channels": GATE_FPN,
           "compute_dtype": "bfloat16"}
    tmodel = FasterRCNN(FasterRCNNConfig(**cfg))
    tmodel.load_state_dict(gate["state_dict"])
    bf16 = gate["score"](JaxFasterRCNN(JaxConfig(**cfg)), tmodel.eval())
    for c in (bf16["jax"][0], bf16["port"][0]):
        assert np.isfinite(c).all() and c.min() >= 0 and c.max() <= 1
    between = np.abs(bf16["port"][0] - bf16["jax"][0]).mean()
    jax_bf16 = np.abs(bf16["jax"][0] - gate["jax"][0]).mean()
    port_bf16 = np.abs(bf16["port"][0] - gate["port"][0]).mean()
    with capsys.disabled():
        print(f"\ngate in bf16: mean |dc| port-bf16 vs JAX-bf16 {between:.5f}, JAX bf16 vs "
              f"f32 {jax_bf16:.5f}, port bf16 vs f32 {port_bf16:.5f}; selection Jaccard "
              f"JAX bf16 vs f32 {jaccard(bf16['sel_jax'], gate['sel_jax']):.3f}, port bf16 "
              f"vs f32 {jaccard(bf16['sel_port'], gate['sel_port']):.3f}, port-bf16 vs "
              f"JAX-bf16 {jaccard(bf16['sel_port'], bf16['sel_jax']):.3f}; JAX f32 re-roll "
              f"floor {jaccard(gate['sel_jax'], gate['sel_jax_b']):.3f}")
    assert 0 < jax_bf16 and between <= 2 * jax_bf16, (between, jax_bf16)


def json_lines(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_scoring_deviation_entry_point(monkeypatch, capsys):
    """The gate set through ``main`` on the CPU at a tiny cut: a JSON line
    for each configuration but ``faithful`` with its keys, in range, and
    the summary."""
    monkeypatch.setenv("DEVIATION_CONFIGS", "gate")
    summary = sd.main(["--device", "cpu", "--tiny", "--hw", "64", "96", "--steps", "2",
                       "--bank", "4", "--pool", "3", "--budget", "2", "--seeds", "1",
                       "--score-batch", "3"])
    rows = json_lines(capsys.readouterr().out)
    names = [n for n in sd.CONFIG_SETS["gate"] if n != "faithful"]
    assert list(summary) == names
    assert [r["config"] for r in rows[:len(names)]] == names
    assert [r["config"] for r in rows[len(names):]] == names      # the summary block
    for r in rows[:len(names)]:
        assert r == summary[r["config"]][0]
        assert set(r) == {"seed", "config", "mean_abs_dc", "max_abs_dc", "spearman",
                          "stage1_overlap", "selection_jaccard"}
        assert 0 <= r["mean_abs_dc"] <= r["max_abs_dc"] <= 1
        assert 0 <= r["stage1_overlap"] <= 1 and 0 <= r["selection_jaccard"] <= 1
        assert math.isnan(r["spearman"]) or -1 <= r["spearman"] <= 1
    # the window path and the trims are exact on the tiny model's 64 proposals
    assert summary["window"][0]["max_abs_dc"] <= 1e-6


def test_consistency_separation_entry_point(capsys):
    # seed 1 of this cut leaves two easy and one hard image unlabeled
    rows = cs.main(["--device", "cpu", "--pool", "8", "--init", "5", "--epochs", "1",
                    "--budget", "2", "--test-images", "2", "--score-batch", "3", "--seed-start", "1",
                    "--seeds", "2"])
    out = json_lines(capsys.readouterr().out)
    assert out[0] == rows[0] and set(out[1]) == {"mean"}
    row = rows[0]
    assert set(row) == {"seed", "test_mAP", "test_AP50", "auc_hard_vs_easy",
                        "mean_consistency_hard", "mean_consistency_easy", "sel_hard_frac",
                        "pool_hard_frac", "rand_sel_std", "enrichment_sigma"}
    for k in ("test_mAP", "test_AP50", "auc_hard_vs_easy", "mean_consistency_hard",
              "mean_consistency_easy", "sel_hard_frac", "pool_hard_frac"):
        assert 0 <= row[k] <= 1, (k, row[k])
    assert math.isfinite(row["enrichment_sigma"])


@pytest.mark.parametrize("module", [sd, cs])
def test_entry_points_need_a_card_unless_told_cpu(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main(["--seeds", "1"])


def test_config_sets(monkeypatch):
    """Every JAX set by its name, the gate's six, RetinaNet's own set, and
    the refusals."""
    assert set(sd.CONFIG_SETS) == {"default", "gate", "mild", "mild640", "shrink", "flm",
                                   "r5", "retina"}
    assert list(sd.config_set("faster", "gate")) == [
        "faithful", "faithful(keyB)", "f32", "window", "mild(1000/768)", "faithful+slice"]
    assert sd.config_set("faster", None) is sd.CONFIG_SETS["default"]
    assert sd.config_set("retina", None) is sd.CONFIG_SETS["retina"]
    for model, name in (("retina", "mild"), ("faster", "nope"), ("faster", "retina")):
        with pytest.raises(SystemExit):
            sd.config_set(model, name)


def test_float32_copy():
    """The same weights, computing in float32 from the input on (dtype None:
    the input's, float32)."""
    from cald_tpu_torch.models.layers import Conv, Dense

    model, _ = sd.build_model(sd.detector_config(tiny=True, device="cpu"), sd.NUM_CLASSES)
    copy = sd.float32_copy(model)
    assert model.dtype == torch.bfloat16 and copy.dtype is None
    assert not copy.training
    for name, m in copy.named_modules():
        if isinstance(m, (Conv, Dense)):
            assert m.dtype is None, name
    for (k, a), b in zip(model.state_dict().items(), copy.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("allow", [True, False])
def test_score_pool_restores_tf32(allow, monkeypatch):
    """An ``f32`` configuration scores with TF32 off and leaves the
    process's settings as it found them."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", allow)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", allow)
    model, _ = sd.build_model(sd.detector_config(tiny=True, device="cpu"), sd.NUM_CLASSES)
    seen = []
    make = sd.make_cald_score_fn

    def recording(*a, **k):
        fn = make(*a, **k)

        def scored(*args):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            return fn(*args)
        return scored

    monkeypatch.setattr(sd, "make_cald_score_fn", recording)
    images, valid_hw, *_ = sd.batch_scenes(np.random.default_rng(0), 1, (64, 96))
    c, _ = sd.score_pool(model, images, valid_hw, rpn_pre=0, rpn_post=0, shrink=False,
                         score_batch=1, key=0, f32=True)
    assert c.shape == (1,) and seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 is allow
    assert torch.backends.cudnn.allow_tf32 is allow
