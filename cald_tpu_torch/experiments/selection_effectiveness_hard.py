"""Selection effectiveness on a hard/easy pool: CALD against random (port of
``experiments/selection_effectiveness_hard.py``).

A regime built so that consistency has something real to find:

  * pool images are 30% HARD (border truncation, occluder bars, small
    scale, crowding, class-coloured distractors: ``make_hard_easy_voc``),
    conditions under which detections are unstable under the CALD
    augmentations;
  * the test set is 50% hard, so labeling hard images is what moves mAP;
  * budget 50 over a 400-image pool: stage 1 keeps 60 candidates and stage
    2 has room to act.

Reports each cycle's mAP and the HARD FRACTION of each strategy's
selections, read back from the cycle checkpoints' pools: the enrichment is
the mechanism check, mAP the end-to-end one. Then, for each baseline, the
seeds' CALD-minus-baseline mAP deltas a cycle with their mean, a t-based
90% CI and the exact one-sided sign test over the seeds' wins.

    python -m cald_tpu_torch.experiments.selection_effectiveness_hard
        [--seeds 3] [--seed-start 0] [--cycles 3] [--pool 400] [--epochs 14]
        [--init 50] [--strategies cald,random] [--test-images 120]
        [--retries 0] [--device cuda|cpu]

``main`` returns {strategy: [rows of each seed]}; each run also prints
its seconds a cycle in training, evaluation and scoring. ``--test-images``
cuts the test set (tests, smoke runs); ``--retries`` reruns a (strategy,
seed) that stops on a non-finite loss, where the JAX script stops.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import tempfile
from math import comb

import numpy as np
import torch

from cald_tpu_torch.cli.config import ALConfig
from cald_tpu_torch.cli.driver import al_loop, run_device
from cald_tpu_torch.data.pool import ALPoolState
from cald_tpu_torch.data.synthetic import make_hard_easy_voc
from cald_tpu_torch.data.voc import get_voc2007
from cald_tpu_torch.engine.checkpoint import peek_checkpoint
from cald_tpu_torch.experiments.selection_effectiveness import run_retrying
from cald_tpu_torch.strategies.random_strategy import random_select

BUDGET = 50


def hard_fraction(dataset, indices) -> float:
    ids = [dataset.record(int(i)).image_id for i in indices]
    return sum(1 for s in ids if s.startswith("h")) / max(len(ids), 1)


def run(strategy: str, seed: int, tmp: str, *, cycles: int, pool_n: int, epochs: int,
        init_n: int = 50, test_n: int = 120, device: str = "cuda") -> list[dict]:
    train_root = make_hard_easy_voc(
        f"{tmp}/train_{seed}", num_images=pool_n, hard_frac=0.3, seed=100 + seed)
    test_root = make_hard_easy_voc(
        f"{tmp}/test_{seed}", num_images=test_n, hard_frac=0.5, seed=900 + seed)
    train_ds = get_voc2007(train_root, "trainval")
    test_ds = get_voc2007(test_root, "test")
    out_dir = f"{tmp}/ckpt_{strategy}_{seed}"
    cfg = ALConfig(
        dataset="voc2007", data_path=train_root, model="faster",
        strategy=strategy, tiny=True, norm="group", cycles=cycles,
        epochs=epochs, batch_size=8, init_num=init_n, budget_num=BUDGET,
        score_batch_size=16, workers=4, min_size=192, max_size=256,
        max_boxes=8, print_freq=100000, lr=0.005,
        lr_steps=(epochs - 4, epochs - 2), aspect_ratio_group_factor=0,
        seed=seed, output_dir=out_dir, device=device).resolve()
    hist = al_loop(cfg, datasets=(train_ds, test_ds))
    print(json.dumps({"strategy": strategy, "seed": seed, "split_s": [
        {k: round(v, 2) for k, v in h["split_s"].items()} for h in hist]}), flush=True)

    rows = []
    prev_labeled = None
    for h in hist:
        pool, _, _ = peek_checkpoint(os.path.join(out_dir, f"cycle_{h['cycle']}"))
        labeled = set(int(i) for i in pool.labeled)
        newly = labeled - prev_labeled if prev_labeled is not None else labeled
        prev_labeled = labeled
        rows.append({
            "cycle": h["cycle"], "labeled": h["labeled"],
            "mAP": round(float(h["eval"].get("mAP", 0.0)), 4),
            "AP50": round(float(h["eval"].get("AP50", 0.0)), 4),
            "hard_frac_selected": round(hard_fraction(train_ds, newly), 3),
        })
    return rows


def random_rows(dataset, *, cycles: int, init_n: int, seed: int) -> list[dict]:
    """The ``labeled`` and ``hard_frac_selected`` of each cycle of a
    ``random`` run on ``dataset``, replayed from its draws without training:
    the driver's initial pool and its ``default_rng(seed + 100 + cycle)``
    pick over the whole unlabeled pool (VOC has no pool cap)."""
    pool = ALPoolState.initial(len(dataset), init_n, seed)
    rows, prev = [], None
    for cycle in range(cycles):
        labeled = set(pool.labeled.tolist())
        newly = labeled - prev if prev is not None else labeled
        prev = labeled
        if cycle < cycles - 1:
            subset = pool.unlabeled.copy()
            rng = np.random.default_rng(seed + 100 + cycle)
            pool = pool.select(subset[random_select(len(subset), BUDGET, rng)])
        rows.append({"cycle": cycle, "labeled": int(len(pool.labeled)),
                     "hard_frac_selected": round(hard_fraction(dataset, newly), 3)})
    return rows


def seed_stats(d: np.ndarray) -> dict:
    """The seeds' CALD-minus-baseline deltas ``d`` of one cycle: their mean,
    the half-width of a t-based 90% CI (t at n-1 degrees of freedom for
    n = 10 and 5, else 2.0) and the exact one-sided sign test P(X >= wins |
    p = 0.5), ties dropped."""
    n = len(d)
    ci = (1.833 if n == 10 else 2.132 if n == 5 else 2.0) * d.std(
        ddof=1) / np.sqrt(n) if n > 1 else float("nan")
    wins = int((d > 0).sum())
    eff = int((d != 0).sum())
    p_sign = sum(comb(eff, k) for k in range(wins, eff + 1)) / 2 ** eff if eff else 1.0
    return {"delta_mAP_per_seed": [round(float(x), 4) for x in d],
            "mean_delta": round(float(d.mean()), 4), "ci90_halfwidth": round(float(ci), 4),
            "wins": f"{wins}/{n}", "sign_test_p": round(p_sign, 4)}


def report(summary: dict, cycles: int) -> None:
    """Print the means over the seeds a (strategy, cycle), then for each
    baseline the CALD-minus-baseline statistics a cycle (``seed_stats``);
    ``summary`` is {strategy: [rows of each seed]}, the seeds in one order."""
    print("== summary (mean over seeds) ==")
    for strategy, per_seed in summary.items():
        for c in range(len(per_seed[0])):
            m = np.mean([rows[c]["mAP"] for rows in per_seed])
            a = np.mean([rows[c]["AP50"] for rows in per_seed])
            hf = np.mean([rows[c]["hard_frac_selected"] for rows in per_seed])
            print(json.dumps({"strategy": strategy, "cycle": c,
                              "mean_mAP": round(float(m), 4),
                              "mean_AP50": round(float(a), 4),
                              "mean_hard_frac_selected": round(float(hf), 3)}))
    for baseline in summary:
        if baseline == "cald" or "cald" not in summary:
            continue
        print(f"== cald vs {baseline} ==")
        for c in range(cycles):
            d = np.asarray([cald[c]["mAP"] - base[c]["mAP"]
                            for cald, base in zip(summary["cald"], summary[baseline])])
            print(json.dumps({"cycle": c, **seed_stats(d)}))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--seed-start", type=int, default=0,
                    help="resume a sweep: run seeds [seed-start, seeds)")
    ap.add_argument("--cycles", type=int, default=3)
    ap.add_argument("--pool", type=int, default=400)
    ap.add_argument("--epochs", type=int, default=14)
    ap.add_argument("--init", type=int, default=50,
                    help="init labeled set (120 + --epochs 16 reproduces the "
                         "mechanism-isolation operating point)")
    ap.add_argument("--strategies", default="cald,random",
                    help="comma list; round-5 evidence run adds ll4al")
    ap.add_argument("--test-images", type=int, default=120)
    ap.add_argument("--retries", type=int, default=0,
                    help="rerun a (strategy, seed) that stops on a non-finite loss")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = run_device(ALConfig(device=args.device))

    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        for strategy in args.strategies.split(","):
            per_seed = []
            for seed in range(args.seed_start, args.seeds):
                rows = run_retrying(run, args.retries, strategy, seed, tmp, cycles=args.cycles,
                                    pool_n=args.pool, epochs=args.epochs, init_n=args.init,
                                    test_n=args.test_images, device=args.device)
                per_seed.append(rows)
                # a run's models and allocator blocks go before the next
                gc.collect()
                if device.type == "cuda":
                    torch.cuda.empty_cache()
                print(json.dumps({"strategy": strategy, "seed": seed, "rows": rows}),
                      flush=True)
            summary[strategy] = per_seed

    report(summary, args.cycles)
    return summary


if __name__ == "__main__":
    main()
