"""The AL-curve experiments of the port against the JAX package's scripts
(``experiments/selection_effectiveness.py`` and
``experiments/selection_effectiveness_hard.py``, loaded by path): both entry
points end to end on the CPU at a cut, ``random``'s rows against the JAX
script's (they do not depend on training: the initial pool and the random
picks are drawn alike in both packages, and the synthetic trees are byte
equal), and the hard fraction and seed statistics on fixed inputs."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cald_tpu_torch.data.synthetic import make_hard_easy_voc
from cald_tpu_torch.data.voc import get_voc2007
from cald_tpu_torch.experiments import selection_effectiveness as se
from cald_tpu_torch.experiments import selection_effectiveness_hard as seh

ROOT = Path(__file__).resolve().parent.parent
# the random-parity cut: 60 hard/easy images, 4 initial, the script's budget
# of 50, 2 cycles of 1 epoch, the test set cut to TEST_IMAGES
PARITY = dict(cycles=2, pool_n=60, epochs=1, init_n=4)
TEST_IMAGES = 4


def load_script(name: str):
    """The JAX package's experiment script ``experiments/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "experiments" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def json_lines(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def random_keys(rows: list[dict]) -> list[tuple]:
    """The rows' fields that do not depend on training under ``random``."""
    return [(r["cycle"], r["labeled"], r["hard_frac_selected"]) for r in rows]


def hard_count(root: str) -> int:
    ds = get_voc2007(root, "trainval")
    return sum(ds.record(i).image_id.startswith("h") for i in range(len(ds)))


def test_selection_effectiveness_entry_point(capsys):
    """Both strategies at a cut: 20 pool images (8 unlabeled after the 12
    initial), 4 test images, 2 cycles of 1 epoch: a row a cycle, in range,
    the labeled set grown by the budget of 6 (CALD: or 7), each run's time
    split, the
    summary lines."""
    out = se.main(["0", "--device", "cpu", "--pool", "20", "--test-images", "4", "--cycles",
                   "2", "--epochs", "1"])
    text = capsys.readouterr().out
    assert list(out) == ["cald", "random"]
    for strategy, per_seed in out.items():
        (rows,) = per_seed
        # an untrained detector finds nothing; CALD's stage 2 then takes
        # every zero-detection candidate, up to int(1.2 x budget)
        n = rows[0][0]
        assert [r[0] for r in rows] == [n, n] and n in ({18, 19} if strategy == "cald" else {18})
        for _, m, b in rows:
            assert 0 <= m <= 1 and 0 <= b <= 1
        assert f"== {strategy}: final mAP" in text
    splits = [r for r in json_lines(text) if "split_s" in r]
    assert [(r["strategy"], len(r["split_s"])) for r in splits] == [("cald", 2), ("random", 2)]
    assert set(splits[0]["split_s"][0]) == {"train", "eval", "score"}


def test_hard_entry_point(capsys, tmp_path):
    """Both strategies at a cut: 16 pool images, 8 initial (the budget of
    50 takes the other 8), 4 test images, 2 cycles of 1 epoch: the rows,
    their keys and ranges, the two batches' hard images adding up to the
    pool's, random's rows equal to the replay of its draws, the seed
    statistics a cycle."""
    summary = seh.main(["--device", "cpu", "--pool", "16", "--init", "8", "--cycles", "2",
                        "--epochs", "1", "--test-images", "4", "--seeds", "1"])
    lines = json_lines(capsys.readouterr().out)
    assert list(summary) == ["cald", "random"]
    root = make_hard_easy_voc(tmp_path / "train_0", num_images=16, hard_frac=0.3, seed=100)
    hard = hard_count(root)
    replay = seh.random_rows(get_voc2007(root, "trainval"), cycles=2, init_n=8, seed=0)
    assert random_keys(summary["random"][0]) == random_keys(replay)
    for per_seed in summary.values():
        (rows,) = per_seed
        assert [r["labeled"] for r in rows] == [16, 16]
        for r in rows:
            assert set(r) == {"cycle", "labeled", "mAP", "AP50", "hard_frac_selected"}
            assert all(0 <= r[k] <= 1 for k in ("mAP", "AP50", "hard_frac_selected"))
        assert round(8 * (rows[0]["hard_frac_selected"] + rows[1]["hard_frac_selected"])) == hard
    stats = [r for r in lines if "delta_mAP_per_seed" in r]
    assert [r["cycle"] for r in stats] == [0, 1]


def test_random_rows_match_the_jax_script(tmp_path, monkeypatch):
    """``random`` at the parity cut through the JAX script's ``run`` (its
    test set cut to TEST_IMAGES through its generator's name in the loaded
    module): ``labeled`` and ``hard_frac_selected`` equal the port's replay
    of the draws a cycle (the port's ``run`` equals its replay:
    ``test_hard_entry_point``)."""
    jseh = load_script("selection_effectiveness_hard")
    make = jseh.make_hard_easy_voc

    def small_test_set(root, num_images, **kw):
        test_set = os.path.basename(str(root)).startswith("test_")
        return make(root, num_images=TEST_IMAGES if test_set else num_images, **kw)

    monkeypatch.setattr(jseh, "make_hard_easy_voc", small_test_set)
    want = jseh.run("random", 0, str(tmp_path / "jax"), **PARITY)
    root = make_hard_easy_voc(tmp_path / "port", num_images=PARITY["pool_n"], hard_frac=0.3,
                              seed=100)
    got = seh.random_rows(get_voc2007(root, "trainval"), cycles=PARITY["cycles"],
                          init_n=PARITY["init_n"], seed=0)
    assert random_keys(got) == random_keys(want)
    assert [r["labeled"] for r in got] == [54, 54]


def jax_random_rows(dataset, *, cycles: int, init_n: int, seed: int) -> list[dict]:
    """``random_rows`` on the JAX driver's draws: its initial pool
    (``cald_tpu.data.pool.ALPoolState``) and its pick
    (``cald_tpu.strategies.random_strategy.random_select`` on
    ``default_rng(seed + 100 + cycle)``, ``cald_tpu/cli/driver.py``)."""
    from cald_tpu.data.pool import ALPoolState
    from cald_tpu.strategies.random_strategy import random_select

    jseh = load_script("selection_effectiveness_hard")
    pool = ALPoolState.initial(len(dataset), init_n, seed)
    rows, prev = [], None
    for cycle in range(cycles):
        labeled = set(pool.labeled.tolist())
        newly = labeled - prev if prev is not None else labeled
        prev = labeled
        if cycle < cycles - 1:
            subset = pool.unlabeled.copy()
            rng = np.random.default_rng(seed + 100 + cycle)
            pool = pool.select(subset[random_select(len(subset), seh.BUDGET, rng)])
        rows.append({"cycle": cycle, "labeled": int(len(pool.labeled)),
                     "hard_frac_selected": round(jseh.hard_fraction(dataset, newly), 3)})
    return rows


@pytest.mark.parametrize("seed", [0, 1])
def test_random_replay_matches_the_jax_package(tmp_path, seed):
    """The port's replay equals the JAX driver's draws on a 160-image tree,
    10 initial, 3 cycles."""
    ds = get_voc2007(make_hard_easy_voc(tmp_path / "t", num_images=160, hard_frac=0.3,
                                        seed=100 + seed), "trainval")
    got = seh.random_rows(ds, cycles=3, init_n=10, seed=seed)
    assert got == jax_random_rows(ds, cycles=3, init_n=10, seed=seed)
    assert [r["labeled"] for r in got] == [60, 110, 110]


def test_hard_fraction_matches(tmp_path):
    jseh = load_script("selection_effectiveness_hard")
    ds = get_voc2007(make_hard_easy_voc(tmp_path / "t", num_images=30, hard_frac=0.3, seed=7),
                     "trainval")
    for idx in ([], [0], list(range(30)), [3, 5, 8, 13, 21, 29]):
        assert seh.hard_fraction(ds, idx) == jseh.hard_fraction(ds, idx)
    assert 0 < seh.hard_fraction(ds, range(30)) < 1


# seed-level mAPs by (strategy, seed, cycle): ties (seed 1, cycle 0), wins
# and losses, equal deltas
MAPS = {"cald": [[0.05, 0.07], [0.04, 0.06], [0.03, 0.09], [0.05, 0.05], [0.06, 0.08],
                 [0.02, 0.04], [0.05, 0.05], [0.07, 0.09], [0.01, 0.03], [0.04, 0.1]],
        "random": [[0.04, 0.08], [0.04, 0.05], [0.02, 0.07], [0.05, 0.06], [0.05, 0.07],
                   [0.03, 0.04], [0.05, 0.04], [0.06, 0.08], [0.02, 0.03], [0.03, 0.09]]}


@pytest.mark.parametrize("n_seeds", [1, 2, 3, 5, 10])
def test_summary_and_seed_statistics_match_the_jax_script(n_seeds, monkeypatch, capsys):
    """Both ``main``s over fixed rows (``run`` replaced in each module):
    every printed summary and statistics line equal, at the seed counts that
    pick each CI constant (5 and 10 seeds, else 2.0; NaN for one)."""
    def fixed_run(strategy, seed, tmp, *, cycles, **kw):
        return [{"cycle": c, "labeled": 50 * (c + 1), "mAP": MAPS[strategy][seed][c],
                 "AP50": 2 * MAPS[strategy][seed][c], "hard_frac_selected": 0.1 * (seed % 4)}
                for c in range(cycles)]

    argv = ["--seeds", str(n_seeds), "--cycles", "2"]
    jseh = load_script("selection_effectiveness_hard")
    monkeypatch.setattr(jseh, "run", fixed_run)
    monkeypatch.setattr(sys, "argv", ["selection_effectiveness_hard.py", *argv])
    jseh.main()
    want = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(seh, "run", fixed_run)
    seh.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert sum("sign_test_p" in line for line in got) == 2


@pytest.mark.parametrize("retries", [0, 1])
@pytest.mark.parametrize("module", [se, seh])
def test_retries_rerun_a_run_that_stops_on_a_non_finite_loss(module, retries, monkeypatch,
                                                             capsys):
    """``--retries``: CALD's first attempt stops on a non-finite loss; with
    no retry ``main`` stops there, as the JAX script does, with one it runs
    the (strategy, seed) again and reports both strategies. Each stopped
    attempt prints a JSON line."""
    calls = []

    def flaky_run(strategy, seed, tmp, *, cycles, **kw):
        calls.append(strategy)
        if strategy == "cald" and calls.count("cald") == 1:
            raise FloatingPointError("Loss is nan, stopping")
        if module is se:
            return [(12 + 6 * c, 0.01 * c, 0.1 * c) for c in range(cycles)]
        return [{"cycle": c, "labeled": 50 * (c + 1), "mAP": MAPS[strategy][seed][c],
                 "AP50": 0.1, "hard_frac_selected": 0.3} for c in range(cycles)]

    monkeypatch.setattr(module, "run", flaky_run)
    argv = (["0"] if module is se else ["--seeds", "1"]) + [
        "--cycles", "2", "--device", "cpu", "--retries", str(retries)]
    if not retries:
        with pytest.raises(FloatingPointError):
            module.main(argv)
        assert calls == ["cald"]
        return
    summary = module.main(argv)
    assert calls == ["cald", "cald", "random"] and list(summary) == ["cald", "random"]
    stopped = [r for r in json_lines(capsys.readouterr().out) if "non_finite" in r]
    assert stopped == [{"strategy": "cald", "seed": 0, "attempt": 0,
                        "non_finite": "Loss is nan, stopping"}]


@pytest.mark.parametrize("module", [se, seh])
def test_entry_points_need_a_card_unless_told_cpu(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main(["0"] if module is se else ["--seeds", "1"])


if __name__ == "__main__":
    # random's rows replayed from the JAX driver's draws, without training, at
    # EXPERIMENTS.md's settings (round 3: --init 50; round 4: --init 120; pool
    # 400, 3 cycles): python tests/test_torch_selection_effectiveness.py
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        for init in (50, 120):
            per_seed = []
            for seed in range(3):
                root = make_hard_easy_voc(f"{tmp}/train_{seed}", num_images=400, hard_frac=0.3,
                                          seed=100 + seed)
                ds = get_voc2007(root, "trainval")
                rows = jax_random_rows(ds, cycles=3, init_n=init, seed=seed)
                assert rows == seh.random_rows(ds, cycles=3, init_n=init, seed=seed)
                per_seed.append(rows)
                print(json.dumps({"init": init, "seed": seed, "rows": rows}))
            print(json.dumps({"init": init, "mean_hard_frac_selected": [
                round(float(np.mean([rows[c]["hard_frac_selected"] for rows in per_seed])), 3)
                for c in range(3)]}))
