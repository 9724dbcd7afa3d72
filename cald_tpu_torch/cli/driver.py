"""The active-learning cycle driver (port of ``cald_tpu/cli/driver.py`` for
Faster R-CNN with the ``cald``, ``random``, ``ltc`` and ``lsc`` strategies,
frozen or group norms).

Cycle structure (the reference's):
    for cycle: train a fresh detector on the labeled set -> evaluate ->
               score the pool -> select the budget -> labeled += selection

The pool split, cycle and seeds are checkpointed with the model
(``--output-dir``), so any cycle boundary is resumable (``--resume``).

Random streams. The NumPy streams are those of the JAX package's ``al_loop``,
so batches, flips, pool subsets and random picks equal its own:
  * the pool: ``ALPoolState.initial(len(train), init_num, seed)``;
  * the training loader of (cycle, epoch): ``grouped_batch_indices`` shuffled
    by ``default_rng(seed + cycle * 1000 + epoch)``, the flips of batch n by
    ``default_rng((seed + cycle * 1000 + epoch, n))``;
  * the scoring subset and the random picks of cycle k:
    ``default_rng(seed + 100 + k)``.
JAX's key streams become ``torch.Generator``s on the run's device, seeded from
the same numbers (their draws are the port's own):
  * the samplers' Gumbel noise of epoch e, ``fold_in(key(seed), e)`` in JAX:
    ``stream_generator(device, seed, e)``;
  * the augmentation draws (CALD) and noise normals (LS/C) of cycle k's
    scoring, ``fold_in(key(seed + 17), k)`` in JAX:
    ``stream_generator(device, seed + 17, k)``;
where ``stream_generator(device, a, b)`` is seeded with the first 63 bits of
``np.random.SeedSequence([a, b])``'s state. The model init is
``models/init.py::random_init_`` with ``seed`` (the JAX package's
``create_train_state(..., seed=cfg.seed)``), then the pretrained backbone
where one is given.

Not ported yet (they raise ``NotImplementedError``): the strategies ssm,
ll4al and vaal (ROADMAP queue 1 item 7), the models other than Faster R-CNN
(item 8), COCO (item 9), the multi-process branches (item 11) and
``--score-shrink-slice`` (item 13).

Known difference: ``--pretrained-backbone`` with ``--norm group`` raises
``ValueError`` before any work. The JAX package fails too, later and with
another message: its importer fills FrozenBatchNorm leaves only.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import os
import time

import numpy as np
import torch

from cald_tpu_torch.augment.suite import expand_aug_string
from cald_tpu_torch.cli.config import ALConfig
from cald_tpu_torch.convert.torchvision_import import load_backbone_
from cald_tpu_torch.data.batching import (
    create_aspect_ratio_groups, default_canvases, grouped_batch_indices,
)
from cald_tpu_torch.data.loader import BatchLoader
from cald_tpu_torch.data.pool import ALPoolState
from cald_tpu_torch.data.transforms import random_horizontal_flip
from cald_tpu_torch.data.voc import get_voc2007, get_voc2012
from cald_tpu_torch.engine.checkpoint import load_checkpoint, peek_checkpoint, save_checkpoint
from cald_tpu_torch.engine.evaluate import evaluate
from cald_tpu_torch.engine.optim import RESNET_FROZEN_L3, make_sgd
from cald_tpu_torch.engine.schedules import lr_scheduler, multistep_with_warmup
from cald_tpu_torch.engine.train import make_train_step, train_one_epoch
from cald_tpu_torch.models.faster_rcnn import FasterRCNN, FasterRCNNConfig
from cald_tpu_torch.models.init import random_init_
from cald_tpu_torch.models.matcher import generator_gumbel
from cald_tpu_torch.strategies.cald import (
    CALDConfig, cald_select, labeled_class_counts, make_cald_score_fn, score_pool,
)
from cald_tpu_torch.strategies.lsc import lsc_scores, make_lsc_score_fn
from cald_tpu_torch.strategies.ltc import make_ltc_score_fn, run_ltc
from cald_tpu_torch.strategies.random_strategy import random_select

STRATEGIES = ("cald", "random", "ltc", "lsc")


def stream_generator(device: torch.device, a: int, b: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for the stream that JAX folds as
    ``fold_in(key(a), b)``."""
    state = np.random.SeedSequence([a, b]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state >> np.uint64(1)))


def _check_supported(cfg: ALConfig):
    """Refuse, before any work, what the port does not run yet, and
    ``--pretrained-backbone`` under group norm, which has no weights to
    import into."""
    if cfg.strategy not in STRATEGIES:
        raise NotImplementedError(f"strategy {cfg.strategy!r} is not ported yet "
                                  "(ROADMAP queue 1 item 7)")
    if cfg.model != "faster":
        raise NotImplementedError(f"model {cfg.model!r} is not ported yet "
                                  "(ROADMAP queue 1 item 8)")
    if cfg.score_shrink_slice:
        raise NotImplementedError("--score-shrink-slice is not ported yet "
                                  "(ROADMAP queue 1 item 13)")
    if cfg.norm == "group" and cfg.pretrained_backbone:
        raise ValueError("--pretrained-backbone imports FrozenBatchNorm statistics; "
                         "a --norm group backbone has none")


def build_datasets(cfg: ALConfig):
    if cfg.dataset == "voc2007":
        return get_voc2007(cfg.data_path, "trainval"), get_voc2007(cfg.data_path, "test")
    if cfg.dataset == "voc2012":
        return get_voc2012(cfg.data_path, "trainval"), get_voc2012(cfg.data_path, "val")
    if "coco" in cfg.dataset:
        raise NotImplementedError("COCO is not ported yet (ROADMAP queue 1 item 9)")
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


def build_model(cfg: ALConfig, num_classes: int):
    """Returns (model, frozen parameter-name prefixes); the weights are
    zeros until ``_fresh_state`` initialises them. Nothing is frozen under
    group norm or in the tiny model."""
    if cfg.model != "faster":
        raise NotImplementedError(f"model {cfg.model!r} is not ported yet "
                                  "(ROADMAP queue 1 item 8)")
    if cfg.tiny:
        mcfg = FasterRCNNConfig(num_classes=num_classes, backbone="tiny", norm=cfg.norm,
                                rpn_pre_nms_top_n_train=128, rpn_pre_nms_top_n_test=128,
                                rpn_post_nms_top_n_train=64, rpn_post_nms_top_n_test=64,
                                rpn_batch_size_per_image=32, box_batch_size_per_image=32,
                                detections_per_img=16, representation_size=64)
        return FasterRCNN(mcfg), ()
    frozen = RESNET_FROZEN_L3 if cfg.norm == "frozen" else ()
    return FasterRCNN(FasterRCNNConfig(num_classes=num_classes, norm=cfg.norm)), frozen


def _loaders(cfg: ALConfig, dataset, indices, *, batch_size, train: bool, canvases,
             group_ids, seed=0) -> BatchLoader:
    rng = np.random.default_rng(seed) if train else None
    batches = grouped_batch_indices(list(indices), group_ids, batch_size, rng)
    return BatchLoader(
        dataset, batches, canvases=canvases, min_size=cfg.min_size,
        max_size=cfg.max_size, max_boxes=cfg.max_boxes,
        transform=random_horizontal_flip if train else None,
        num_workers=cfg.workers, seed=seed)


def _apply_pretrained_backbone(model: FasterRCNN, cfg: ALConfig):
    """Load the torchvision-layout backbone ``state_dict`` of
    ``--pretrained-backbone`` into a fresh model (the reference's
    ``pretrained_backbone=True``); the reference rebuilds the model every
    cycle, so this runs every cycle."""
    if cfg.pretrained_backbone:
        sd = torch.load(cfg.pretrained_backbone, map_location="cpu", weights_only=True)
        load_backbone_(model, sd)


def _fresh_state(cfg: ALConfig, num_classes: int, dataset, pool: ALPoolState, canvases,
                 group_ids, *, cycle: int, device):
    """A fresh model, optimizer and schedule for a cycle (the reference
    re-creates the model every cycle). Returns (model, optimizer, scheduler)."""
    model, frozen_prefixes = build_model(cfg, num_classes)
    random_init_(model, cfg.seed)
    _apply_pretrained_backbone(model, cfg)
    model.to(device)
    loader0 = _loaders(cfg, dataset, pool.labeled, batch_size=cfg.batch_size, train=True,
                       canvases=canvases, group_ids=group_ids, seed=cfg.seed + cycle)
    steps_per_epoch = max(len(loader0), 1)
    optimizer = make_sgd(model, cfg.lr, momentum=cfg.momentum,
                         weight_decay=cfg.weight_decay, frozen_prefixes=frozen_prefixes)
    scheduler = lr_scheduler(optimizer, multistep_with_warmup(
        cfg.lr, steps_per_epoch, milestones=cfg.lr_steps, gamma=cfg.lr_gamma,
        warmup_iters=cfg.warmup_iters))
    return model, optimizer, scheduler


def train_cycle(cfg: ALConfig, num_classes: int, dataset, pool: ALPoolState, canvases,
                group_ids, *, cycle: int, device):
    """Fresh model + the full training schedule on the current labeled set."""
    model, optimizer, scheduler = _fresh_state(cfg, num_classes, dataset, pool, canvases,
                                               group_ids, cycle=cycle, device=device)
    step_fn = make_train_step(model, optimizer, scheduler)
    for epoch in range(cfg.epochs):
        loader = _loaders(cfg, dataset, pool.labeled, batch_size=cfg.batch_size, train=True,
                          canvases=canvases, group_ids=group_ids,
                          seed=cfg.seed + cycle * 1000 + epoch)
        draw = generator_gumbel(stream_generator(device, cfg.seed, epoch))
        train_one_epoch(step_fn, loader, draw, device=device, epoch=epoch, cycle=cycle,
                        print_freq=cfg.print_freq)
    return model, optimizer, scheduler


def _scoring_model(cfg: ALConfig, model: FasterRCNN) -> FasterRCNN:
    """The pool-scoring variant with smaller RPN candidate counts (capped at
    the model's own); ``score_rpn_post_nms`` 0, the default, scores with the
    model itself. The variant shares the model's weights."""
    if not cfg.score_rpn_post_nms:
        return model
    pre = min(cfg.score_rpn_pre_nms or 10 ** 9, model.cfg.rpn_pre_nms_top_n_test)
    post = min(cfg.score_rpn_post_nms, model.cfg.rpn_post_nms_top_n_test)
    if (pre, post) == (model.cfg.rpn_pre_nms_top_n_test, model.cfg.rpn_post_nms_top_n_test):
        return model
    variant = copy.copy(model)
    variant.cfg = dataclasses.replace(model.cfg, rpn_pre_nms_top_n_test=pre,
                                      rpn_post_nms_top_n_test=post)
    return variant


def score_and_select(cfg: ALConfig, model: FasterRCNN, dataset, pool: ALPoolState, canvases,
                     group_ids, *, cycle: int, device) -> np.ndarray:
    """Dispatch on ``cfg.strategy``; returns the chosen DATASET indices."""
    rng = np.random.default_rng(cfg.seed + 100 + cycle)
    subset = (pool.subsample_pool(cfg.pool_cap, rng) if cfg.pool_cap
              else pool.unlabeled.copy())
    budget = cfg.budget_num
    if cfg.strategy == "random":
        return subset[random_select(len(subset), budget, rng)]
    if cfg.strategy not in STRATEGIES:
        raise NotImplementedError(f"strategy {cfg.strategy!r} is not ported yet "
                                  "(ROADMAP queue 1 item 7)")
    loader = _loaders(cfg, dataset, subset, batch_size=cfg.score_batch_size, train=False,
                      canvases=canvases, group_ids=group_ids)
    generator = stream_generator(device, cfg.seed + 17, cycle)
    scoring_model = _scoring_model(cfg, model)
    if cfg.strategy == "ltc":
        u = run_ltc(make_ltc_score_fn(scoring_model), loader, subset, device)
        return subset[np.argsort(u, kind="stable")[:budget]]
    if cfg.strategy == "lsc":
        s = lsc_scores(make_lsc_score_fn(scoring_model), loader, subset, generator)
        return subset[np.argsort(s, kind="stable")[:budget]]
    ccfg = CALDConfig(aug_names=tuple(expand_aug_string(cfg.augs)), base_point=cfg.bp,
                      mutual_range=cfg.mr, uniform=cfg.uniform, no_mutual=cfg.no_mutual)
    score_fn = make_cald_score_fn(scoring_model, ccfg, cfg.num_classes)
    consistency, corrs = score_pool(score_fn, loader, subset, generator)
    labeled_mean = labeled_class_counts(dataset, pool.labeled, cfg.num_classes - 1)
    return subset[cald_select(consistency, corrs, labeled_mean, budget, ccfg)]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def al_loop(cfg: ALConfig, *, datasets=None) -> list[dict]:
    """Run the AL experiment; returns one result dict per cycle."""
    cfg = cfg.resolve()
    _check_supported(cfg)
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    train_ds, test_ds = datasets if datasets is not None else build_datasets(cfg)
    num_classes = len(train_ds.class_names)
    canvases = default_canvases(cfg.min_size, cfg.max_size)
    group_ids = create_aspect_ratio_groups(train_ds.aspect_ratios(),
                                           cfg.aspect_ratio_group_factor)
    test_group_ids = create_aspect_ratio_groups(test_ds.aspect_ratios(),
                                                cfg.aspect_ratio_group_factor)
    pool = ALPoolState.initial(len(train_ds), cfg.init_num, cfg.seed)
    history = []

    resume_cycle = -1
    if cfg.resume:
        r_pool, _, r_meta = peek_checkpoint(cfg.resume)
        if r_pool is None:
            raise ValueError(f"--resume checkpoint {cfg.resume!r} carries no pool state "
                             "(only the per-cycle checkpoints of al_loop are resumable)")
        pool = r_pool
        resume_cycle = int(r_meta["cycle"])
        print(f"--resume: restored pool (labeled {len(pool.labeled)}) at cycle {resume_cycle}")

    profiler = None
    profiled = False
    for cycle in range(cfg.cycles):
        if cycle < resume_cycle:
            history.append({"cycle": cycle, "resumed": True})
            continue
        t0 = time.time()
        if cfg.profile_dir and not profiled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
            profiler.start()
            profiled = True
        print(f"=== cycle {cycle}: labeled {len(pool.labeled)}, "
              f"unlabeled {len(pool.unlabeled)} ===")
        first_ckpt = (os.path.join(cfg.first_checkpoint_path, f"{cfg.dataset}_{cfg.model}_1st")
                      if cfg.first_checkpoint_path else "")
        resuming_here = cycle == resume_cycle
        fresh = lambda c: _fresh_state(cfg, num_classes, train_ds, pool, canvases,  # noqa: E731
                                       group_ids, cycle=c, device=device)
        if resuming_here:
            # the trained model of this cycle; go straight to its selection
            print(f"--resume: loading cycle checkpoint {cfg.resume}")
            model, optimizer, scheduler = fresh(cycle)
            load_checkpoint(cfg.resume, model, optimizer, scheduler)
        elif cfg.skip and cycle == 0 and first_ckpt and os.path.isdir(first_ckpt):
            # reuse the saved first-cycle model (reference --skip); the
            # checkpoint's split is the one its weights were trained on
            print(f"--skip: loading first-cycle checkpoint {first_ckpt}")
            model, optimizer, scheduler = fresh(0)
            skip_pool, _, _ = load_checkpoint(first_ckpt, model, optimizer, scheduler)
            if skip_pool is not None:
                pool = skip_pool
        else:
            model, optimizer, scheduler = train_cycle(cfg, num_classes, train_ds, pool,
                                                      canvases, group_ids, cycle=cycle,
                                                      device=device)
        _sync(device)
        t_train = time.time()
        if cycle == 0 and first_ckpt and not (cfg.skip and os.path.isdir(first_ckpt)):
            save_checkpoint(first_ckpt, model, optimizer, scheduler, pool=pool,
                            meta={"cycle": 0})

        stats = {}
        if resuming_here:
            stats = {"resumed": True}   # eval ran before the checkpoint was saved
        elif cfg.eval_every_cycle:
            test_loader = _loaders(cfg, test_ds, range(len(test_ds)),
                                   batch_size=cfg.score_batch_size, train=False,
                                   canvases=canvases, group_ids=test_group_ids)
            stats = evaluate(model, test_loader, test_ds, kind=cfg.eval_kind, device=device)
        _sync(device)
        t_eval = time.time()

        if cfg.output_dir and not resuming_here:
            save_checkpoint(os.path.join(cfg.output_dir, f"cycle_{cycle}"), model, optimizer,
                            scheduler, pool=pool,
                            rng={"seed": cfg.seed, "torch_cpu": torch.get_rng_state()},
                            meta={"cycle": cycle})

        t_score = time.time()
        if cycle < cfg.cycles - 1:
            chosen = score_and_select(cfg, model, train_ds, pool, canvases, group_ids,
                                      cycle=cycle, device=device)
            pool = pool.select(np.asarray(chosen))
        _sync(device)
        t_end = time.time()
        if profiler is not None:
            profiler.stop()
            os.makedirs(cfg.profile_dir, exist_ok=True)
            path = os.path.join(cfg.profile_dir, f"cycle_{cycle}_trace.json")
            profiler.export_chrome_trace(path)
            profiler = None
            print(f"profile trace written to {path}")
        digest = hashlib.sha1(np.sort(np.asarray(pool.labeled)).tobytes()).hexdigest()[:12]
        history.append({"cycle": cycle, "labeled": int(len(pool.labeled)),
                        "labeled_digest": digest, "eval": stats, "time_s": t_end - t0,
                        "split_s": {"train": t_train - t0, "eval": t_eval - t_train,
                                    "score": t_end - t_score}})
        del model, optimizer, scheduler
    return history
