"""Plain supervised trainer (port of ``cald_tpu/cli/train.py``, the
reference's detection/train.py): train on the FULL training split with
checkpoint/resume, then evaluate.

    python -m cald_tpu_torch.cli.train --dataset voc2007 --data-path ... \\
        --model faster --epochs 26 --output-dir CKPTS [--resume CKPTS/last]

Runs on the card; ``--device cpu`` asks for the CPU, and without CUDA and
without it the command exits non-zero. With ``--output-dir``, the model, its
optimizer and its schedule are saved to ``OUTPUT_DIR/last`` after every epoch
with ``meta = {"epoch": e}``; ``--resume DIR`` restores them and continues at
epoch ``e + 1``. After the last epoch the test split is evaluated with the
dataset's protocol (``cfg.eval_kind``: VOC or COCO) unless ``--no-eval``.

Epoch e's batches are those of the JAX trainer: ``grouped_batch_indices``
shuffled by ``default_rng(seed + e)`` and its flips; its sampling noise is
``stream_generator(device, seed, e)`` (``cli/driver.py``), so a resumed run
repeats the uninterrupted one.

Multi-process data parallelism, launched as for ``cli.main``
(``torchrun --nproc-per-node N -m cald_tpu_torch.cli.train ...`` or the JAX
package's launch variables), trains the global batch of every rank's
stride of the training set for the agreed step count (``cli/driver.py``);
rank 0 alone writes ``last/``, and the test split is evaluated in strides
whose results are gathered.

The JAX trainer adds a second ``--resume`` to the shared parser, which
argparse refuses before any argument is read; the port uses the shared
parser's ``--resume``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from cald_tpu_torch.cli.config import build_config_from_args
from cald_tpu_torch.cli.driver import (
    _fresh_state, _loaders, _Lockstep, _task_epoch, build_datasets, run_device,
)
from cald_tpu_torch.data.batching import create_aspect_ratio_groups, default_canvases
from cald_tpu_torch.data.pool import ALPoolState
from cald_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint
from cald_tpu_torch.engine.evaluate import evaluate
from cald_tpu_torch.engine.train import make_train_step
from cald_tpu_torch.parallel import process_count, process_index, process_shard


def train(cfg, *, datasets=None) -> dict:
    """Train ``cfg.epochs`` epochs (from the ``cfg.resume`` checkpoint's next
    epoch when given) on the whole training split, then evaluate. Returns
    ``{"model", "start_epoch", "losses": {epoch: last step's loss}, "eval"}``."""
    cfg = cfg.resolve()
    device = run_device(cfg)
    if process_count() > 1:
        print(f"multi-process data parallel: {process_count()} processes")
    train_ds, test_ds = datasets if datasets is not None else build_datasets(cfg)
    num_classes = len(train_ds.class_names)
    canvases = default_canvases(cfg.min_size, cfg.max_size)
    group_ids = create_aspect_ratio_groups(train_ds.aspect_ratios(),
                                           cfg.aspect_ratio_group_factor)
    test_group_ids = create_aspect_ratio_groups(test_ds.aspect_ratios(),
                                                cfg.aspect_ratio_group_factor)
    # a "pool" holding everything: plain supervised training
    pool = ALPoolState(labeled=np.arange(len(train_ds)), unlabeled=np.zeros((0,), np.int64))
    model, optimizer, scheduler = _fresh_state(cfg, num_classes, train_ds, pool, canvases,
                                               group_ids, cycle=0, device=device)
    start_epoch = 0
    if cfg.resume:
        _, _, meta = load_checkpoint(cfg.resume, model, optimizer, scheduler)
        start_epoch = int(meta.get("epoch", -1)) + 1
        print(f"resumed from {cfg.resume} at epoch {start_epoch}")

    step_fn = make_train_step(model, optimizer, scheduler)
    losses = {}
    for epoch in range(start_epoch, cfg.epochs):
        loader = _Lockstep(_loaders(cfg, train_ds, pool.labeled, batch_size=cfg.batch_size,
                                    train=True, canvases=canvases, group_ids=group_ids,
                                    seed=cfg.seed + epoch))
        metrics = _task_epoch(cfg, step_fn, loader, cycle=0, epoch=epoch, device=device)
        losses[epoch] = float(metrics["loss"]) if metrics else float("nan")
        print(f"epoch {epoch}: loss {losses[epoch]:.4f}")
        if cfg.output_dir and process_index() == 0:
            save_checkpoint(os.path.join(cfg.output_dir, "last"), model, optimizer, scheduler,
                            rng={"seed": cfg.seed}, meta={"epoch": epoch})
    stats = {}
    if cfg.eval_every_cycle:
        test_loader = _loaders(cfg, test_ds, process_shard(range(len(test_ds)), pad=False),
                               batch_size=cfg.score_batch_size, train=False,
                               canvases=canvases, group_ids=test_group_ids)
        stats = evaluate(model, test_loader, test_ds, kind=cfg.eval_kind, device=device,
                         classwise=cfg.classwise)
    return {"model": model, "start_epoch": start_epoch, "losses": losses, "eval": stats}


def main(argv=None) -> dict:
    cfg = build_config_from_args(argv)
    if torch.device(cfg.device).type == "cuda" and not torch.cuda.is_available():
        sys.exit("cald_tpu_torch: CUDA is not available; pass --device cpu to run on the CPU")
    print(cfg)
    return train(cfg)


if __name__ == "__main__":
    main(sys.argv[1:])
