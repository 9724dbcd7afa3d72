"""Selection effectiveness: CALD against random on an imbalanced pool (port
of ``experiments/selection_effectiveness.py``).

The learnable synthetic VOC set with a skewed class mix (bird in about 10%
of the pool's objects) and a balanced test set: if CALD's consistency and
class-balance selection works, the rare class's AP50 should climb faster
than under random selection at the same label budget. Per strategy and
seed: a pool of 60 images, a test set of 36, the tiny group-norm Faster
R-CNN, 12 initial images and 6 more a cycle over 4 cycles of 16 epochs.

    python -m cald_tpu_torch.experiments.selection_effectiveness [seed ...]
        [--device cuda|cpu] [--pool 60] [--test-images 36] [--cycles 4]
        [--epochs 16] [--retries 0]

Prints each run's seconds a cycle in training, evaluation and scoring (a
JSON line as it ends), each (strategy, seed)'s rows (labeled, mAP, bird
AP50) and the final means over the seeds; ``main`` returns {strategy: [rows of each
seed]}. ``--pool``, ``--test-images``, ``--cycles`` and ``--epochs`` cut
the run (tests, smoke runs); ``--retries`` reruns a (strategy, seed) that
stops on a non-finite loss, where the JAX script stops.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np

from cald_tpu_torch.cli.config import ALConfig
from cald_tpu_torch.cli.driver import al_loop, run_device
from cald_tpu_torch.data.synthetic import make_learnable_voc
from cald_tpu_torch.data.voc import get_voc2007


def run(strategy: str, seed: int, tmp: str, *, device: str = "cuda", pool_n: int = 60,
        test_n: int = 36, cycles: int = 4, epochs: int = 16) -> list[tuple]:
    """One AL run; returns (labeled, mAP, bird AP50) a cycle."""
    train_root = make_learnable_voc(
        f"{tmp}/train_{seed}", num_images=pool_n, seed=100 + seed,
        class_probs=(0.55, 0.35, 0.10))
    test_root = make_learnable_voc(
        f"{tmp}/test_{seed}", num_images=test_n, seed=900 + seed,
        class_probs=(1 / 3, 1 / 3, 1 / 3))
    train_ds = get_voc2007(train_root, "trainval")
    test_ds = get_voc2007(test_root, "test")
    cfg = ALConfig(
        dataset="voc2007", data_path=train_root, model="faster",
        strategy=strategy, tiny=True, norm="group", cycles=cycles, epochs=epochs,
        batch_size=4, init_num=12, budget_num=6, score_batch_size=8, workers=4,
        min_size=96, max_size=128, max_boxes=8, print_freq=100000, lr=0.005,
        lr_steps=(12, 14), aspect_ratio_group_factor=0, seed=seed, device=device).resolve()
    hist = al_loop(cfg, datasets=(train_ds, test_ds))
    print(json.dumps({"strategy": strategy, "seed": seed, "split_s": [
        {k: round(v, 2) for k, v in h["split_s"].items()} for h in hist]}), flush=True)
    return [(h["labeled"], float(h["eval"].get("mAP", 0.0)),
             float(h["eval"].get("per_class_ap50", {}).get("bird", 0.0))) for h in hist]


def run_retrying(run, retries: int, strategy: str, seed: int, *args, **kw):
    """``run(strategy, seed, *args, **kw)``, started again up to ``retries``
    times when it stops on a non-finite loss (``FloatingPointError``); each
    stopped attempt prints a JSON line. On the card a rerun is a new
    trajectory of the same recipe (atomics, cuDNN's algorithm choice); on
    the CPU it repeats the same one."""
    for attempt in range(retries + 1):
        try:
            return run(strategy, seed, *args, **kw)
        except FloatingPointError as e:
            print(json.dumps({"strategy": strategy, "seed": seed, "attempt": attempt,
                              "non_finite": str(e)[:200]}), flush=True)
            if attempt == retries:
                raise


def report(out: dict) -> None:
    """Print each strategy's final mAP and bird AP50, the means over the
    seeds; ``out`` is {strategy: [rows of each seed]}."""
    for strategy, per_seed in out.items():
        final_bird = np.mean([rows[-1][2] for rows in per_seed])
        final_map = np.mean([rows[-1][1] for rows in per_seed])
        print(f"== {strategy}: final mAP {final_map:.3f}, "
              f"final bird AP50 {final_bird:.3f} (mean over {len(per_seed)} seeds)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("seeds", type=int, nargs="*", default=[0, 1])
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    ap.add_argument("--pool", type=int, default=60)
    ap.add_argument("--test-images", type=int, default=36)
    ap.add_argument("--cycles", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=16)
    ap.add_argument("--retries", type=int, default=0,
                    help="rerun a (strategy, seed) that stops on a non-finite loss")
    args = ap.parse_args(argv)
    run_device(ALConfig(device=args.device))

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for strategy in ("cald", "random"):
            per_seed = [run_retrying(run, args.retries, strategy, s, tmp, device=args.device,
                                     pool_n=args.pool, test_n=args.test_images,
                                     cycles=args.cycles, epochs=args.epochs)
                        for s in args.seeds]
            out[strategy] = per_seed
            for s, rows in zip(args.seeds, per_seed):
                print(f"{strategy} seed {s}: " + " | ".join(
                    f"n={n} mAP={m:.3f} birdAP50={b:.3f}" for n, m, b in rows))
    report(out)
    return out


if __name__ == "__main__":
    main()
