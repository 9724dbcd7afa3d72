"""Does CALD's consistency score find hard images? (port of
``experiments/consistency_separation.py``)

Isolates the claim the method stands on: a reasonably trained detector's
augmentation-consistency score separates hard-to-detect images from easy
ones. Per seed:
  1. a hard/easy pool (``make_hard_easy_voc``, 30% hard) and a held-out
     test set (50% hard);
  2. the tiny group-norm Faster R-CNN trained once, for many epochs, on a
     random initial set (the driver's ``train_cycle``);
  3. every unlabeled pool image CALD-scored on the reference-faithful path
     (``strategies.cald.score_pool``);
  4. reported: the AUC of (-consistency) ranking hard above easy (0.5 is
     blind), the mean consistency of hard and easy pool images, the hard
     fraction of the budget's two-stage CALD selection (the driver's
     ``score_and_select``) against the pool's base rate and a random draw's
     std, and the test mAP/AP50 at scoring time.

    python -m cald_tpu_torch.experiments.consistency_separation [--seeds 3]
        [--seed-start 0] [--pool 400] [--init 120] [--epochs 16]
        [--budget 50] [--test-images 120] [--score-batch 16] [--device cuda|cpu]

The scoring draws come from the stream the driver gives cycle 0's scoring
(``stream_generator(device, seed + 17, 0)``), so ``score_and_select``
scores the pool with the same draws again.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np

from cald_tpu_torch.augment.suite import expand_aug_string
from cald_tpu_torch.cli.config import ALConfig
from cald_tpu_torch.cli.driver import (
    _loaders, _scoring_model, run_device, score_and_select, stream_generator, train_cycle,
)
from cald_tpu_torch.data.batching import create_aspect_ratio_groups, default_canvases
from cald_tpu_torch.data.pool import ALPoolState
from cald_tpu_torch.data.synthetic import make_hard_easy_voc
from cald_tpu_torch.data.voc import get_voc2007
from cald_tpu_torch.engine.evaluate import evaluate
from cald_tpu_torch.strategies.cald import CALDConfig, make_cald_score_fn, score_pool


def is_hard(dataset, idx: int) -> bool:
    return dataset.record(int(idx)).image_id.startswith("h")


def auc(pos_scores: np.ndarray, neg_scores: np.ndarray) -> float:
    """P(random pos ranks above random neg), ties 0.5 (Mann-Whitney)."""
    pos = np.asarray(pos_scores)[:, None]
    neg = np.asarray(neg_scores)[None, :]
    return float(((pos > neg).sum() + 0.5 * (pos == neg).sum())
                 / (pos.size * neg.size))


def separation(consistency: np.ndarray, hard_mask: np.ndarray, sel_hard: float,
               budget: int) -> dict:
    """The separation statistics of one seed: the AUC of (-consistency)
    ranking hard above easy, the mean consistencies, and the selection's
    hard fraction against the pool's base rate in random-draw stds (the
    hypergeometric std of a ``budget`` draw from the pool)."""
    sep_auc = auc(-consistency[hard_mask], -consistency[~hard_mask])
    base = float(hard_mask.mean())
    n_u = len(consistency)
    rand_std = float(np.sqrt(base * (1 - base) / budget * (n_u - budget) / (n_u - 1)))
    return {
        "auc_hard_vs_easy": round(sep_auc, 4),
        "mean_consistency_hard": round(float(consistency[hard_mask].mean()), 4),
        "mean_consistency_easy": round(float(consistency[~hard_mask].mean()), 4),
        "sel_hard_frac": round(sel_hard, 4),
        "pool_hard_frac": round(base, 4),
        "rand_sel_std": round(rand_std, 4),
        "enrichment_sigma": round((sel_hard - base) / rand_std, 2),
    }


def run(seed: int, tmp: str, *, pool_n: int, init_n: int, epochs: int, budget: int,
        test_n: int = 120, score_batch: int = 16, device: str = "cuda") -> dict:
    train_root = make_hard_easy_voc(f"{tmp}/train_{seed}", num_images=pool_n,
                                    hard_frac=0.3, seed=100 + seed)
    test_root = make_hard_easy_voc(f"{tmp}/test_{seed}", num_images=test_n,
                                   hard_frac=0.5, seed=900 + seed)
    train_ds = get_voc2007(train_root, "trainval")
    test_ds = get_voc2007(test_root, "test")
    num_classes = len(train_ds.class_names)

    cfg = ALConfig(
        dataset="voc2007", data_path=train_root, model="faster",
        strategy="cald", tiny=True, norm="group", cycles=1, epochs=epochs,
        batch_size=8, init_num=init_n, budget_num=budget,
        score_batch_size=score_batch, workers=4, min_size=192, max_size=256,
        max_boxes=8, print_freq=100000, lr=0.005,
        lr_steps=(max(epochs - 4, 1), max(epochs - 2, 2)),
        aspect_ratio_group_factor=0, seed=seed, device=device).resolve()
    dev = run_device(cfg)

    canvases = default_canvases(cfg.min_size, cfg.max_size)
    group_ids = create_aspect_ratio_groups(train_ds.aspect_ratios(),
                                           cfg.aspect_ratio_group_factor)
    test_group_ids = create_aspect_ratio_groups(test_ds.aspect_ratios(),
                                                cfg.aspect_ratio_group_factor)
    pool = ALPoolState.initial(len(train_ds), cfg.init_num, cfg.seed)

    model, _, _ = train_cycle(cfg, num_classes, train_ds, pool, canvases, group_ids,
                              cycle=0, device=dev)
    model.eval()

    test_loader = _loaders(cfg, test_ds, range(len(test_ds)),
                           batch_size=cfg.score_batch_size, train=False,
                           canvases=canvases, group_ids=test_group_ids)
    ev = evaluate(model, test_loader, test_ds, kind="voc", device=dev)

    # raw consistency scores over the whole unlabeled pool (faithful path)
    ccfg = CALDConfig(aug_names=tuple(expand_aug_string(cfg.augs)),
                      base_point=cfg.bp, mutual_range=cfg.mr)
    score_fn = make_cald_score_fn(_scoring_model(cfg, model), ccfg, num_classes)
    subset = pool.unlabeled.copy()
    loader = _loaders(cfg, train_ds, subset, batch_size=cfg.score_batch_size,
                      train=False, canvases=canvases, group_ids=group_ids)
    consistency, _ = score_pool(score_fn, loader, subset,
                                stream_generator(dev, cfg.seed + 17, 0))

    # the actual two-stage selection (the driver's code path)
    picked = score_and_select(cfg, model, train_ds, pool, canvases, group_ids,
                              cycle=0, device=dev, strategy_state={})
    sel_hard = float(np.mean([is_hard(train_ds, i) for i in picked]))
    hard_mask = np.asarray([is_hard(train_ds, i) for i in subset])
    return {
        "seed": seed,
        "test_mAP": round(float(ev.get("mAP", 0.0)), 4),
        "test_AP50": round(float(ev.get("AP50", 0.0)), 4),
        **separation(consistency, hard_mask, sel_hard, budget),
    }


def main(argv=None) -> list[dict]:
    """Run the seeds; returns their rows."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--seed-start", type=int, default=0,
                    help="first seed (resume an interrupted sweep)")
    ap.add_argument("--pool", type=int, default=400)
    ap.add_argument("--init", type=int, default=120)
    ap.add_argument("--epochs", type=int, default=16)
    ap.add_argument("--budget", type=int, default=50)
    ap.add_argument("--test-images", type=int, default=120)
    ap.add_argument("--score-batch", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    run_device(ALConfig(device=args.device))

    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for seed in range(args.seed_start, args.seeds):
            row = run(seed, tmp, pool_n=args.pool, init_n=args.init,
                      epochs=args.epochs, budget=args.budget, test_n=args.test_images,
                      score_batch=args.score_batch, device=args.device)
            rows.append(row)
            print(json.dumps(row), flush=True)

    keys = [k for k in rows[0] if k != "seed"] if rows else []
    print(json.dumps({"mean": {k: round(float(np.mean([r[k] for r in rows])), 4)
                               for k in keys}}))
    return rows


if __name__ == "__main__":
    main()
