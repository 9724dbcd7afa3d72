"""The active-learning cycle driver (port of ``cald_tpu/cli/driver.py``):
every ``--model`` of the JAX package (``faster``, Faster R-CNN ResNet-50-FPN
or its ``--tiny`` miniature; ``retina``, RetinaNet ResNet-50-FPN or its
``--tiny`` miniature; ``faster_mobilenet``, Faster R-CNN MobileNetV3-Large-FPN;
``retina_mobilenet``, single-level RetinaNet MobileNetV3-Large) with every
strategy: ``cald``, ``random``, ``ltc``, ``lsc``, ``ssm``, ``ll4al`` and
``vaal``; frozen or group norms.

Cycle structure (the reference's):
    for cycle: train a fresh detector on the labeled set -> evaluate ->
               score the pool -> select the budget -> labeled += selection

LL4AL trains the detector jointly with its LossNet; VAAL follows each
task epoch with an epoch of VAE + discriminator steps.

The pool split, cycle and seeds are checkpointed with the model
(``--output-dir``), so any cycle boundary is resumable (``--resume``), with
the strategies' carry-state: SSM's adapted gamma and clslambda in ``meta``,
the trained LossNet (LL4AL) and VAE + discriminator (VAAL) parameters in
``extra``. A checkpoint without ``extra`` retrains the cycle.

Random streams. The NumPy streams are those of the JAX package's ``al_loop``,
so batches, flips, pool subsets and random picks equal its own:
  * the pool: ``ALPoolState.initial(len(train), init_num, seed)``;
  * the training loader of (cycle, epoch): ``grouped_batch_indices`` shuffled
    by ``default_rng(seed + cycle * 1000 + epoch)``, the flips of batch n by
    ``default_rng((seed + cycle * 1000 + epoch, n))``;
  * the scoring subset, the random picks and SSM's cross-validation draws of
    cycle k: ``default_rng(seed + 100 + k)``.
JAX's key streams become ``torch.Generator``s on the run's device, seeded from
the same numbers (their draws are the port's own):
  * the samplers' Gumbel noise of epoch e, ``fold_in(key(seed), e)`` in JAX:
    ``stream_generator(device, seed, e)``;
  * the augmentation draws (CALD) and noise normals (LS/C) of cycle k's
    scoring, ``fold_in(key(seed + 17), k)`` in JAX:
    ``stream_generator(device, seed + 17, k)``;
  * the samplers' noise of LL4AL's joint step bi of (cycle, epoch):
    ``stream_generator(device, seed + 3, (cycle * 1000 + epoch) * 100000 + bi)``;
  * VAAL's reparameterisation normals of (cycle, epoch), drawn step after
    step: ``stream_generator(device, seed + 31, cycle * 1000 + epoch)``;
where ``stream_generator(device, a, b)`` is seeded with the first 63 bits of
``np.random.SeedSequence([a, b])``'s state. The model init is
``models/init.py::random_init_`` with ``seed`` (the JAX package's
``create_train_state(..., seed=cfg.seed)``), then the pretrained backbone
where one is given; LossNet is initialised from ``seed + 1``, and cycle k's
VAE and discriminator from ``seed + k`` and ``seed + k + 1`` (Flax's
initial distributions, ``models/init.py::lecun_init_``).

Datasets: VOC2007 (trainval/test), VOC2012 (trainval/val) and COCO
(train2017/val2017, evaluated by the COCO protocol). The model's class count
is the training set's (``len(class_names)``); ``cfg.num_classes`` (81 for
COCO, 21 for VOC) sizes CALD's class statistics and SSM's ``clslambda``, as
in the JAX package.

Multi-process data parallelism (``cald_tpu_torch.parallel``): launched by
torchrun (``WORLD_SIZE`` above 1), by the JAX package's
``JAX_COORDINATOR_ADDRESS`` + ``JAX_NUM_PROCESSES`` + ``JAX_PROCESS_ID`` or by
``CALD_TPU_DISTRIBUTED=1``, every rank runs this loop on its own card
(``cuda:LOCAL_RANK`` unless ``--device`` names one), as the JAX package's
processes run it over their global mesh:
  * training: each rank loads its stride of the labeled set
    (``process_shard``), all ranks take the agreed minimum step count
    (``_sync_len``), the weights start from rank 0's, every step averages the
    gradients (the global batch's step) and its sampling noise is the rank's
    rows of the global batch's draw (``process_draw``);
  * evaluation: each rank detects its stride of the test set and the results
    are gathered before the evaluator runs;
  * scoring: each rank scores its stride of the pool subset and the scores
    are merged by a scatter and a sum over the ranks, so every rank makes the
    same selection; SSM's cross-validation runs on the whole subset on every
    rank;
  * rank 0 alone writes the checkpoints, the first-cycle model and the
    profile; ``--resume`` reads on every rank.

Known differences: ``--pretrained-backbone`` with ``--norm group`` raises
``ValueError`` before any work. The JAX package fails too, later and with
another message: its importer fills FrozenBatchNorm leaves only. ``--skip``
with ``ll4al`` raises ``ValueError`` when it would load the first-cycle
checkpoint, which holds no LossNet; the JAX package fails at the cycle's
scoring with a ``KeyError``. Under more than one process LL4AL's schedules
count the agreed steps per epoch, as every other schedule does; the JAX
package's count the rank's own loader (the same number unless the ranks'
aspect-ratio groups batch differently).
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import itertools
import os
import time

import numpy as np
import torch

from cald_tpu_torch.augment.suite import expand_aug_string, generator_draw
from cald_tpu_torch.cli.config import ALConfig
from cald_tpu_torch.convert.torchvision_import import load_backbone_, load_state_dict
from cald_tpu_torch.data.batching import (
    create_aspect_ratio_groups, default_canvases, grouped_batch_indices, images_tensor,
    make_padded_batch,
)
from cald_tpu_torch.data.coco import get_coco
from cald_tpu_torch.data.loader import BatchLoader, decode_image
from cald_tpu_torch.data.pool import ALPoolState
from cald_tpu_torch.data.records import ImageRecord
from cald_tpu_torch.data.transforms import random_horizontal_flip
from cald_tpu_torch.data.voc import get_voc2007, get_voc2012
from cald_tpu_torch.engine.checkpoint import (
    load_checkpoint, load_extra, peek_checkpoint, save_checkpoint,
)
from cald_tpu_torch.engine.evaluate import evaluate
from cald_tpu_torch.engine.optim import RESNET_FROZEN_L3, make_sgd
from cald_tpu_torch.engine.schedules import lr_scheduler, multistep_with_warmup
from cald_tpu_torch.engine.train import make_train_step, train_one_epoch
from cald_tpu_torch.models.faster_rcnn import FasterRCNN, FasterRCNNConfig
from cald_tpu_torch.models.init import lecun_init_, random_init_
from cald_tpu_torch.models.lossnet import LossNet
from cald_tpu_torch.models.matcher import generator_gumbel
from cald_tpu_torch.models.retinanet import (
    RetinaNet, RetinaNetConfig, retinanet_mobilenet, retinanet_resnet50_fpn_cal,
)
from cald_tpu_torch.parallel import (
    all_gather_objects, broadcast_module_, initialize_distributed, local_rank, process_count,
    process_draw, process_index, process_merge_sum, process_shard,
)
from cald_tpu_torch.strategies.cald import (
    CALDConfig, cald_select, labeled_class_counts, make_cald_score_fn, score_pool,
)
from cald_tpu_torch.strategies.ll4al import (
    ll_scores, ll_select, make_ll_score_fn, make_ll_train_step,
)
from cald_tpu_torch.strategies.lsc import lsc_scores, make_lsc_score_fn
from cald_tpu_torch.strategies.ltc import make_ltc_score_fn, run_ltc
from cald_tpu_torch.strategies.random_strategy import random_select
from cald_tpu_torch.strategies.ssm import CrossValidator, SSMConfig, ssm_select
from cald_tpu_torch.strategies.vaal import VAALTrainer, vaal_select

STRATEGIES = ("cald", "random", "ltc", "lsc", "ssm", "ll4al", "vaal")
MODELS = ("faster", "retina", "faster_mobilenet", "retina_mobilenet")
Detector = FasterRCNN | RetinaNet


def stream_generator(device: torch.device, a: int, b: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for the stream that JAX folds as
    ``fold_in(key(a), b)``."""
    state = np.random.SeedSequence([a, b]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state >> np.uint64(1)))


def run_device(cfg: ALConfig) -> torch.device:
    """Join a multi-process launch (``initialize_distributed``: NCCL on the
    card, gloo for ``--device cpu``) and return the run's device:
    ``cuda:LOCAL_RANK`` for a bare ``--device cuda`` under more than one
    process, else ``--device``."""
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    initialize_distributed(backend=None if device.type == "cuda" else "gloo")
    if device.type == "cuda" and device.index is None and process_count() > 1:
        device = torch.device("cuda", local_rank())
    return device


def _check_supported(cfg: ALConfig):
    """Refuse, before any work, an unknown strategy or model, and
    ``--pretrained-backbone`` under group norm, which has no weights to
    import into."""
    if cfg.strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {cfg.strategy!r}")
    if cfg.model not in MODELS:
        raise ValueError(f"unknown model {cfg.model!r}")
    if cfg.norm == "group" and cfg.pretrained_backbone:
        raise ValueError("--pretrained-backbone imports FrozenBatchNorm statistics; "
                         "a --norm group backbone has none")


def build_datasets(cfg: ALConfig):
    if cfg.dataset == "voc2007":
        return get_voc2007(cfg.data_path, "trainval"), get_voc2007(cfg.data_path, "test")
    if cfg.dataset == "voc2012":
        return get_voc2012(cfg.data_path, "trainval"), get_voc2012(cfg.data_path, "val")
    if "coco" in cfg.dataset:
        return get_coco(cfg.data_path, "train"), get_coco(cfg.data_path, "val")
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


def build_model(cfg: ALConfig, num_classes: int):
    """Returns (model, frozen parameter-name prefixes); the weights are
    zeros until ``_fresh_state`` initialises them. The ResNet-50 models
    freeze conv1 and layer1 under frozen norms; nothing is frozen under
    group norm, in the tiny models or in the MobileNet models (``--tiny``
    shrinks ``faster`` and ``retina`` only, as in the JAX package)."""
    frozen = RESNET_FROZEN_L3 if (cfg.norm == "frozen" and not cfg.tiny) else ()
    if cfg.model == "faster":
        if cfg.tiny:
            return FasterRCNN(FasterRCNNConfig(
                num_classes=num_classes, backbone="tiny", norm=cfg.norm,
                rpn_pre_nms_top_n_train=128, rpn_pre_nms_top_n_test=128,
                rpn_post_nms_top_n_train=64, rpn_post_nms_top_n_test=64,
                rpn_batch_size_per_image=32, box_batch_size_per_image=32,
                detections_per_img=16, representation_size=64)), ()
        return FasterRCNN(FasterRCNNConfig(num_classes=num_classes, norm=cfg.norm)), frozen
    if cfg.model == "faster_mobilenet":
        return FasterRCNN(FasterRCNNConfig(num_classes=num_classes, backbone="mobilenetv3",
                                           norm=cfg.norm,
                                           anchor_sizes=((32, 64, 128, 256, 512),))), ()
    if cfg.model == "retina":
        if cfg.tiny:
            return RetinaNet(RetinaNetConfig(
                num_classes=num_classes, backbone="tiny", norm=cfg.norm,
                detections_per_img=16, topk_candidates=64,
                anchor_sizes=((16, 20),) * 5)), ()
        return retinanet_resnet50_fpn_cal(num_classes, norm=cfg.norm), frozen
    if cfg.model == "retina_mobilenet":
        return retinanet_mobilenet(num_classes, norm=cfg.norm), ()
    raise ValueError(f"unknown model {cfg.model!r}")


def _loaders(cfg: ALConfig, dataset, indices, *, batch_size, train: bool, canvases,
             group_ids, seed=0) -> BatchLoader:
    """A training loader (shuffled, flipped) takes this rank's stride of
    ``indices`` (``process_shard``, the DistributedSampler); an evaluation or
    scoring loader takes ``indices`` as they are."""
    if train:
        indices = process_shard(indices)
    rng = np.random.default_rng(seed) if train else None
    batches = grouped_batch_indices(list(indices), group_ids, batch_size, rng)
    return BatchLoader(
        dataset, batches, canvases=canvases, min_size=cfg.min_size,
        max_size=cfg.max_size, max_boxes=cfg.max_boxes,
        transform=random_horizontal_flip if train else None,
        num_workers=cfg.workers, seed=seed, device=cfg.device)


def _sync_len(n: int) -> int:
    """The ranks' agreed per-epoch step count: the least of their loader
    lengths, so no rank waits in a collective for another's extra batch
    (identity at one process)."""
    return n if process_count() == 1 else min(all_gather_objects(int(n)))


class _Lockstep:
    """A training loader cut to the agreed step count."""

    def __init__(self, loader):
        self.loader, self.n = loader, _sync_len(len(loader))

    def __len__(self):
        return self.n

    def __iter__(self):
        return itertools.islice(iter(self.loader), self.n)


def _apply_pretrained_backbone(model, cfg: ALConfig):
    """Load the torchvision-layout backbone ``state_dict`` of
    ``--pretrained-backbone`` (``.npz``, ``.npy`` or a ``torch.load`` file)
    into a fresh model (the reference's ``pretrained_backbone=True``); the
    reference rebuilds the model every cycle, so this runs every cycle."""
    if cfg.pretrained_backbone:
        load_backbone_(model, load_state_dict(cfg.pretrained_backbone))


def _steps_per_epoch(cfg: ALConfig, dataset, pool: ALPoolState, canvases, group_ids, *,
                     cycle: int) -> int:
    """Agreed batches of the cycle's training loader (at least 1): the
    schedules' epoch length."""
    return max(_sync_len(len(_loaders(cfg, dataset, pool.labeled, batch_size=cfg.batch_size,
                                      train=True, canvases=canvases, group_ids=group_ids,
                                      seed=cfg.seed + cycle))), 1)


def _sgd(cfg: ALConfig, module, base_lr: float, steps_per_epoch: int, frozen_prefixes=()):
    """(optimizer, scheduler): the reference's SGD on the warmup + multistep
    schedule from ``base_lr``."""
    optimizer = make_sgd(module, base_lr, momentum=cfg.momentum,
                         weight_decay=cfg.weight_decay, frozen_prefixes=frozen_prefixes)
    scheduler = lr_scheduler(optimizer, multistep_with_warmup(
        base_lr, steps_per_epoch, milestones=cfg.lr_steps, gamma=cfg.lr_gamma,
        warmup_iters=cfg.warmup_iters))
    return optimizer, scheduler


def _fresh_state(cfg: ALConfig, num_classes: int, dataset, pool: ALPoolState, canvases,
                 group_ids, *, cycle: int, device):
    """A fresh model, optimizer and schedule for a cycle (the reference
    re-creates the model every cycle), rank 0's weights on every rank.
    Returns (model, optimizer, scheduler)."""
    model, frozen_prefixes = build_model(cfg, num_classes)
    random_init_(model, cfg.seed)
    _apply_pretrained_backbone(model, cfg)
    broadcast_module_(model.to(device))
    steps = _steps_per_epoch(cfg, dataset, pool, canvases, group_ids, cycle=cycle)
    return (model, *_sgd(cfg, model, cfg.lr, steps, frozen_prefixes))


def _train_loader(cfg: ALConfig, dataset, pool: ALPoolState, canvases, group_ids, *,
                  cycle: int, epoch: int) -> _Lockstep:
    return _Lockstep(_loaders(cfg, dataset, pool.labeled, batch_size=cfg.batch_size,
                              train=True, canvases=canvases, group_ids=group_ids,
                              seed=cfg.seed + cycle * 1000 + epoch))


def _task_epoch(cfg: ALConfig, step_fn, loader, *, cycle: int, epoch: int, device) -> dict:
    """One epoch of task steps; returns the last step's metrics."""
    draw = process_draw(generator_gumbel(stream_generator(device, cfg.seed, epoch)))
    return train_one_epoch(step_fn, loader, draw, device=device, epoch=epoch, cycle=cycle,
                           print_freq=cfg.print_freq)


def _tensors(batch, device) -> list[torch.Tensor]:
    return [images_tensor(batch.images, device), *(torch.from_numpy(a).to(device) for a in (
        batch.valid_hw, batch.boxes, batch.labels, batch.box_valid))]


def train_cycle(cfg: ALConfig, num_classes: int, dataset, pool: ALPoolState, canvases,
                group_ids, *, cycle: int, device):
    """Fresh model + the full training schedule on the current labeled set."""
    model, optimizer, scheduler = _fresh_state(cfg, num_classes, dataset, pool, canvases,
                                               group_ids, cycle=cycle, device=device)
    step_fn = make_train_step(model, optimizer, scheduler)
    for epoch in range(cfg.epochs):
        loader = _train_loader(cfg, dataset, pool, canvases, group_ids, cycle=cycle, epoch=epoch)
        _task_epoch(cfg, step_fn, loader, cycle=cycle, epoch=epoch, device=device)
    return model, optimizer, scheduler


def _new_lossnet(model, cfg: ALConfig, device) -> LossNet:
    """LossNet over the first 4 levels of the model's pyramid (the JAX
    package's ``LossNet(num_levels=4)``, whose Dense layers take what they
    are given): P2..P5, RetinaNet's P3..P6, MobileNet Faster R-CNN's 3
    levels, the single level of ``retina_mobilenet``."""
    lossnet = LossNet(num_levels=min(4, len(model.cfg.strides)),
                      in_channels=model.cfg.fpn_channels)
    lecun_init_(lossnet, cfg.seed + 1)
    return broadcast_module_(lossnet.to(device))


def _train_cycle_ll4al(cfg: ALConfig, num_classes: int, dataset, pool: ALPoolState, canvases,
                       group_ids, *, cycle: int, device):
    """Joint detector + LossNet training (ll_train.py:55-133): LossNet has
    its own SGD on the task's schedule (nothing frozen); after
    ``task_epochs`` epochs its input features are detached. Returns (model,
    optimizer, scheduler, lossnet)."""
    model, optimizer, scheduler = _fresh_state(cfg, num_classes, dataset, pool, canvases,
                                               group_ids, cycle=cycle, device=device)
    lossnet = _new_lossnet(model, cfg, device)
    steps = _steps_per_epoch(cfg, dataset, pool, canvases, group_ids, cycle=cycle)
    ll_optimizer, ll_scheduler = _sgd(cfg, lossnet, cfg.lr, steps)
    step = make_ll_train_step(model, lossnet, optimizer, ll_optimizer, scheduler, ll_scheduler,
                              ll_weight=cfg.ll_weight)
    for epoch in range(cfg.epochs):
        loader = _train_loader(cfg, dataset, pool, canvases, group_ids, cycle=cycle, epoch=epoch)
        metrics = None
        for bi, batch in enumerate(loader):
            draw = process_draw(generator_gumbel(stream_generator(
                device, cfg.seed + 3, (cycle * 1000 + epoch) * 100000 + bi)))
            metrics = step(*_tensors(batch, device), draw,
                           detach_features=epoch >= cfg.task_epochs)
        last = "empty loader" if metrics is None else f"loss {float(metrics['loss']):.4f}"
        print(f"ll4al cycle {cycle} epoch {epoch}: {last}")
    return model, optimizer, scheduler, lossnet


def _make_vaal_trainer(cfg: ALConfig, steps_per_epoch: int, cycle: int, device) -> VAALTrainer:
    """A fresh VAE + discriminator for a cycle with the reference's
    optimizers: SGD at lr/10 for the VAE and at lr for the discriminator,
    both on the task's warmup + multistep schedule (vaal_train.py:221-238)."""
    def optimizers(vae, disc):
        return (*_sgd(cfg, vae, cfg.lr / 10, steps_per_epoch),
                *_sgd(cfg, disc, cfg.lr, steps_per_epoch))

    trainer = VAALTrainer(optimizers, seed=cfg.seed + cycle, device=device)
    broadcast_module_(trainer.vae)
    broadcast_module_(trainer.disc)
    return trainer


def _vaal_adversary_epoch(cfg: ALConfig, trainer: VAALTrainer, dataset, pool: ALPoolState,
                          canvases, group_ids, *, cycle: int, epoch: int, device):
    """One epoch of VAE + discriminator steps: one per labeled batch, each
    with the next unlabeled batch, the unlabeled loader cycled when it is
    shorter (vaal_train.py:99-148); under more than one process, the agreed
    step counts of both loaders."""
    seed = cfg.seed + cycle * 1000 + epoch
    lab_loader = _loaders(cfg, dataset, pool.labeled, batch_size=cfg.batch_size, train=True,
                          canvases=canvases, group_ids=group_ids, seed=seed)
    unlab_loader = _loaders(cfg, dataset, pool.unlabeled, batch_size=cfg.batch_size,
                            train=True, canvases=canvases, group_ids=group_ids, seed=seed + 1)
    if _sync_len(len(unlab_loader)) == 0:
        return
    draw = process_draw(generator_draw(stream_generator(device, cfg.seed + 31,
                                                        cycle * 1000 + epoch)))
    vloss = dloss = float("nan")
    unlab_iter = itertools.cycle(unlab_loader)
    for lb in _Lockstep(lab_loader):
        ub = next(unlab_iter)
        vloss, dloss = trainer.train_step(images_tensor(lb.images, device),
                                          images_tensor(ub.images, device), draw)
    print(f"vaal cycle {cycle} epoch {epoch}: vae_loss {float(vloss):.2f} "
          f"dis_loss {float(dloss):.4f}")


def _train_cycle_vaal(cfg: ALConfig, num_classes: int, dataset, pool: ALPoolState, canvases,
                      group_ids, *, cycle: int, device):
    """The task and the VAE + discriminator trained interleaved, an
    adversary epoch after every task epoch (vaal_train.py:248-251). Returns
    (model, optimizer, scheduler, trainer)."""
    model, optimizer, scheduler = _fresh_state(cfg, num_classes, dataset, pool, canvases,
                                               group_ids, cycle=cycle, device=device)
    step_fn = make_train_step(model, optimizer, scheduler)
    trainer = _make_vaal_trainer(
        cfg, _steps_per_epoch(cfg, dataset, pool, canvases, group_ids, cycle=cycle), cycle,
        device)
    for epoch in range(cfg.epochs):
        loader = _train_loader(cfg, dataset, pool, canvases, group_ids, cycle=cycle, epoch=epoch)
        _task_epoch(cfg, step_fn, loader, cycle=cycle, epoch=epoch, device=device)
        _vaal_adversary_epoch(cfg, trainer, dataset, pool, canvases, group_ids, cycle=cycle,
                              epoch=epoch, device=device)
    return model, optimizer, scheduler, trainer


def _detect_host_fn(cfg: ALConfig, model: Detector, canvases, device):
    """fn(list of (H, W, 3) arrays) -> per-image dicts (``boxes``,
    ``scores``, ``labels``) in the images' own coordinates: SSM's
    cross-validation re-detect, one image at a time on the first canvas."""
    def run(images):
        out = []
        for img in images:
            rec = ImageRecord(image_id="cv", image_path="", width=img.shape[1],
                              height=img.shape[0], boxes=np.zeros((0, 4), np.float32),
                              labels=np.zeros((0,), np.int32),
                              difficult=np.zeros((0,), np.int32))
            batch = make_padded_batch([img], [rec], canvases[0], min_size=cfg.min_size,
                                      max_size=cfg.max_size, max_boxes=1, indices=[0])
            with torch.inference_mode():
                dets = model.detect(images_tensor(batch.images, device),
                                    torch.from_numpy(batch.valid_hw).to(device))
                dets = dets.rescale(torch.from_numpy(batch.scale).to(device))
            v = dets.valid[0].cpu().numpy()
            out.append({"boxes": dets.boxes[0].cpu().numpy()[v],
                        "scores": dets.scores[0].cpu().numpy()[v],
                        "labels": dets.labels[0].cpu().numpy()[v]})
        return out

    return run


def _ssm_pool_detections(model: Detector, loader, scfg: SSMConfig, device) -> dict[int, dict]:
    """One batched pass over the pool collecting SSM's per-image inputs:
    boxes (original coordinates), foreground score rows, and the
    low-confidence ``al`` flag (frcnn_ssm.py:60,71-74)."""
    out: dict[int, dict] = {}
    with torch.inference_mode():
        for batch in loader:
            dets = model.detect(images_tensor(batch.images, device),
                                torch.from_numpy(batch.valid_hw).to(device))
            dets = dets.rescale(torch.from_numpy(batch.scale).to(device))
            boxes, rows, scores, valid = (t.cpu().numpy() for t in (
                dets.boxes, dets.scores_cls, dets.scores, dets.valid))
            for i, idx in enumerate(batch.image_idx):
                m = valid[i]
                out[int(idx)] = {
                    "boxes": boxes[i][m],
                    "score_rows": rows[i][m][:, 1:],          # no background column
                    "al": bool(m.sum() == 0 or scores[i][m].max() < scfg.conf_thresh),
                }
    return out


def _variant(model, **changes):
    """A shallow copy of ``model`` (the same weights) with its config
    changed."""
    variant = copy.copy(model)
    variant.cfg = dataclasses.replace(model.cfg, **changes)
    return variant


def _scoring_model(cfg: ALConfig, model):
    """The pool-scoring variant with fewer candidates (capped at the model's
    own): Faster R-CNN's RPN pre/post-NMS counts, RetinaNet's per-level
    ``topk_candidates`` trimmed to ``--score-rpn-post-nms``.
    ``score_rpn_post_nms`` 0, the default, scores with the model itself. The
    variant shares the model's weights."""
    if not cfg.score_rpn_post_nms:
        return model
    if isinstance(model, RetinaNet):
        topk = min(cfg.score_rpn_post_nms, model.cfg.topk_candidates)
        if topk == model.cfg.topk_candidates:
            return model
        return _variant(model, topk_candidates=topk)
    pre = min(cfg.score_rpn_pre_nms or 10 ** 9, model.cfg.rpn_pre_nms_top_n_test)
    post = min(cfg.score_rpn_post_nms, model.cfg.rpn_post_nms_top_n_test)
    if (pre, post) == (model.cfg.rpn_pre_nms_top_n_test, model.cfg.rpn_post_nms_top_n_test):
        return model
    return _variant(model, rpn_pre_nms_top_n_test=pre, rpn_post_nms_top_n_test=post)


def _ssm_select(cfg: ALConfig, model: Detector, dataset, pool: ALPoolState, subset, loader,
                canvases, rng: np.random.Generator, strategy_state: dict, device) -> np.ndarray:
    """SSM's two stages over ``subset``: the pool detected by the SSM variant
    of ``model`` (Faster R-CNN: its SSM postprocess, RPN counts and weights
    shared; RetinaNet: NMS at SSM's 0.3 through its standard postprocess,
    as in the JAX package), then the
    host selection whose easy single-class boxes are pasted into labeled
    images and re-detected by ``model``. Adapts gamma and clslambda in
    ``strategy_state``; returns positions into ``subset``."""
    scfg: SSMConfig = strategy_state.setdefault("ssm_cfg", SSMConfig())
    gamma = strategy_state.setdefault("gamma", scfg.gamma)
    clslambda = strategy_state.setdefault("clslambda",
                                          np.full(cfg.num_classes - 1, np.log(2.0)))
    if isinstance(model, RetinaNet):
        ssm_model = _variant(model, nms_thresh=scfg.nms_thresh)
    else:
        ssm_model = _variant(model, box_nms_thresh=scfg.nms_thresh, ssm_mode=True)
    by_idx = _ssm_pool_detections(ssm_model, loader, scfg, device)
    pool_dets = [by_idx[int(idx)] for idx in subset]

    def patch_getter(pos_i, box):
        img = decode_image(dataset.record(int(subset[pos_i])).image_path).astype(np.float32)
        x1, y1 = int(max(0, box[0])), int(max(0, box[1]))
        x2, y2 = int(min(img.shape[1], box[2])), int(min(img.shape[0], box[3]))
        if x2 <= x1 or y2 <= y1:
            return None
        return img[y1:y2, x1:x2]

    cv = CrossValidator(dataset, _detect_host_fn(cfg, model, canvases, device), scfg, rng)
    chosen, gamma, clslambda = ssm_select(
        pool_dets, np.arange(len(subset)), cfg.budget_num, gamma=gamma, clslambda=clslambda,
        cross_validator=cv, labeled_indices=pool.labeled, rng=rng, patch_getter=patch_getter)
    strategy_state["gamma"] = gamma
    strategy_state["clslambda"] = clslambda
    return chosen


def score_and_select(cfg: ALConfig, model: Detector, dataset, pool: ALPoolState, canvases,
                     group_ids, *, cycle: int, device,
                     strategy_state: dict | None = None) -> np.ndarray:
    """Dispatch on ``cfg.strategy``; returns the chosen DATASET indices.
    ``strategy_state`` carries what a strategy keeps between cycles: SSM's
    gamma and clslambda (updated here; defaults when absent), LL4AL's
    ``lossnet`` and VAAL's ``vaal`` trainer (both required).

    Under more than one process the batched scorers take this rank's stride
    of the pool subset and the scores are merged (a scatter into the whole
    subset and a sum over the ranks), so every rank selects alike; SSM's
    cross-validation draws from ``rng``, and runs on the whole subset on
    every rank."""
    strategy_state = {} if strategy_state is None else strategy_state
    rng = np.random.default_rng(cfg.seed + 100 + cycle)
    subset = (pool.subsample_pool(cfg.pool_cap, rng) if cfg.pool_cap
              else pool.unlabeled.copy())
    budget = cfg.budget_num
    if cfg.strategy == "random":
        return subset[random_select(len(subset), budget, rng)]
    if cfg.strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {cfg.strategy!r}")
    local_pos = np.arange(len(subset))[process_index()::process_count()]
    local = subset[local_pos]

    def merge(vals: np.ndarray) -> np.ndarray:
        """(len(local), ...) scores of this rank -> (len(subset), ...)."""
        if process_count() == 1:
            return vals
        full = np.zeros((len(subset),) + vals.shape[1:], vals.dtype)
        full[local_pos] = vals
        return process_merge_sum(full)

    def pool_loader(indices):
        return _loaders(cfg, dataset, indices, batch_size=cfg.score_batch_size, train=False,
                        canvases=canvases, group_ids=group_ids)

    if cfg.strategy == "ll4al":
        fn = make_ll_score_fn(model, strategy_state["lossnet"])
        pred = merge(ll_scores(fn, pool_loader(local), local, device))
        return subset[ll_select(pred, budget)]
    if cfg.strategy == "vaal":
        trainer: VAALTrainer = strategy_state["vaal"]
        pos = {int(i): p for p, i in enumerate(local)}
        scores = np.zeros(len(local))
        for batch in pool_loader(local):
            sc = trainer.unlabeled_scores(images_tensor(batch.images, device))
            for i, idx in enumerate(batch.image_idx):
                scores[pos[int(idx)]] = sc[i]
        return subset[vaal_select(merge(scores), budget)]
    if cfg.strategy == "ssm":
        return subset[_ssm_select(cfg, model, dataset, pool, subset, pool_loader(subset),
                                  canvases, rng, strategy_state, device)]
    generator = stream_generator(device, cfg.seed + 17, cycle)
    scoring_model = _scoring_model(cfg, model)
    loader = pool_loader(local)
    if cfg.strategy == "ltc":
        u = merge(run_ltc(make_ltc_score_fn(scoring_model), loader, local, device))
        return subset[np.argsort(u, kind="stable")[:budget]]
    if cfg.strategy == "lsc":
        s = merge(lsc_scores(make_lsc_score_fn(scoring_model), loader, local, generator))
        return subset[np.argsort(s, kind="stable")[:budget]]
    ccfg = CALDConfig(aug_names=tuple(expand_aug_string(cfg.augs)), base_point=cfg.bp,
                      mutual_range=cfg.mr, uniform=cfg.uniform, no_mutual=cfg.no_mutual,
                      shrink_slice=cfg.score_shrink_slice)
    score_fn = make_cald_score_fn(scoring_model, ccfg, cfg.num_classes)
    consistency, corrs = score_pool(score_fn, loader, local, generator)
    labeled_mean = labeled_class_counts(dataset, pool.labeled, cfg.num_classes - 1)
    return subset[cald_select(merge(consistency), merge(corrs), labeled_mean, budget, ccfg)]


def _carry_meta(cycle: int, strategy_state: dict) -> dict:
    meta: dict = {"cycle": cycle}
    if "gamma" in strategy_state:                   # SSM's adapted thresholds
        meta["ssm_gamma"] = strategy_state["gamma"]
        meta["ssm_clslambda"] = strategy_state["clslambda"]
    return meta


def _carry_extra(strategy_state: dict) -> dict:
    """The trained LossNet or VAE + discriminator, parameters only (as the
    JAX package saves them), on the CPU."""
    def cpu(module):
        return {k: v.detach().cpu() for k, v in module.state_dict().items()}

    extra: dict = {}
    if "lossnet" in strategy_state:
        extra["ll_params"] = cpu(strategy_state["lossnet"])
    if "vaal" in strategy_state:
        extra["vaal_vae"] = cpu(strategy_state["vaal"].vae)
        extra["vaal_d"] = cpu(strategy_state["vaal"].disc)
    return extra


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def al_loop(cfg: ALConfig, *, datasets=None) -> list[dict]:
    """Run the AL experiment; returns one result dict per cycle (the same
    on every rank)."""
    cfg = cfg.resolve()
    _check_supported(cfg)
    device = run_device(cfg)
    rank0 = process_index() == 0
    train_ds, test_ds = datasets if datasets is not None else build_datasets(cfg)
    num_classes = len(train_ds.class_names)
    canvases = default_canvases(cfg.min_size, cfg.max_size)
    group_ids = create_aspect_ratio_groups(train_ds.aspect_ratios(),
                                           cfg.aspect_ratio_group_factor)
    test_group_ids = create_aspect_ratio_groups(test_ds.aspect_ratios(),
                                                cfg.aspect_ratio_group_factor)
    pool = ALPoolState.initial(len(train_ds), cfg.init_num, cfg.seed)
    strategy_state: dict = {}
    history = []

    resume_cycle = -1
    if cfg.resume:
        r_pool, _, r_meta = peek_checkpoint(cfg.resume)
        if r_pool is None:
            raise ValueError(f"--resume checkpoint {cfg.resume!r} carries no pool state "
                             "(only the per-cycle checkpoints of al_loop are resumable)")
        pool = r_pool
        resume_cycle = int(r_meta["cycle"])
        if "ssm_gamma" in r_meta:
            strategy_state["gamma"] = float(r_meta["ssm_gamma"])
            strategy_state["clslambda"] = np.asarray(r_meta["ssm_clslambda"])
        print(f"--resume: restored pool (labeled {len(pool.labeled)}) at cycle {resume_cycle}")

    profiler = None
    profiled = False
    for cycle in range(cfg.cycles):
        if cycle < resume_cycle:
            history.append({"cycle": cycle, "resumed": True})
            continue
        t0 = time.time()
        if cfg.profile_dir and not profiled and rank0:
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
        if resuming_here and cfg.strategy in ("ll4al", "vaal"):
            # the trained LossNet or VAE + discriminator ride in ``extra``;
            # a checkpoint without them retrains the cycle
            carry = load_extra(cfg.resume)
            if not carry:
                print(f"--resume: checkpoint lacks {cfg.strategy} carry-state; "
                      "retraining the cycle")
                resuming_here = False
        fresh = lambda c: _fresh_state(cfg, num_classes, train_ds, pool, canvases,  # noqa: E731
                                       group_ids, cycle=c, device=device)
        if resuming_here:
            # the trained model of this cycle; go straight to its selection
            print(f"--resume: loading cycle checkpoint {cfg.resume}")
            model, optimizer, scheduler = fresh(cycle)
            load_checkpoint(cfg.resume, model, optimizer, scheduler)
            if cfg.strategy == "ll4al":
                strategy_state["lossnet"] = _new_lossnet(model, cfg, device)
                strategy_state["lossnet"].load_state_dict(carry["ll_params"])
            elif cfg.strategy == "vaal":
                trainer = _make_vaal_trainer(cfg, 1, cycle, device)
                trainer.vae.load_state_dict(carry["vaal_vae"])
                trainer.disc.load_state_dict(carry["vaal_d"])
                strategy_state["vaal"] = trainer
        elif cfg.skip and cycle == 0 and first_ckpt and os.path.isdir(first_ckpt):
            # reuse the saved first-cycle model (reference --skip); the
            # checkpoint's split is the one its weights were trained on
            if cfg.strategy == "ll4al":
                raise ValueError("--skip with ll4al: the first-cycle checkpoint holds no "
                                 "LossNet; run without --skip")
            print(f"--skip: loading first-cycle checkpoint {first_ckpt}")
            model, optimizer, scheduler = fresh(0)
            skip_pool, _, _ = load_checkpoint(first_ckpt, model, optimizer, scheduler)
            if skip_pool is not None:
                pool = skip_pool
            if cfg.strategy == "vaal":
                # the loaded task model skipped the interleaved adversary
                # epochs: run them alone
                trainer = _make_vaal_trainer(cfg, _steps_per_epoch(
                    cfg, train_ds, pool, canvases, group_ids, cycle=cycle), cycle, device)
                for epoch in range(cfg.epochs):
                    _vaal_adversary_epoch(cfg, trainer, train_ds, pool, canvases, group_ids,
                                          cycle=cycle, epoch=epoch, device=device)
                strategy_state["vaal"] = trainer
        elif cfg.strategy == "ll4al":
            model, optimizer, scheduler, strategy_state["lossnet"] = _train_cycle_ll4al(
                cfg, num_classes, train_ds, pool, canvases, group_ids, cycle=cycle,
                device=device)
        elif cfg.strategy == "vaal":
            model, optimizer, scheduler, strategy_state["vaal"] = _train_cycle_vaal(
                cfg, num_classes, train_ds, pool, canvases, group_ids, cycle=cycle,
                device=device)
        else:
            model, optimizer, scheduler = train_cycle(cfg, num_classes, train_ds, pool,
                                                      canvases, group_ids, cycle=cycle,
                                                      device=device)
        _sync(device)
        t_train = time.time()
        if (cycle == 0 and first_ckpt and not (cfg.skip and os.path.isdir(first_ckpt))
                and rank0):
            save_checkpoint(first_ckpt, model, optimizer, scheduler, pool=pool,
                            meta={"cycle": 0})

        stats = {}
        if resuming_here:
            stats = {"resumed": True}   # eval ran before the checkpoint was saved
        elif cfg.eval_every_cycle:
            test_loader = _loaders(cfg, test_ds, process_shard(range(len(test_ds)), pad=False),
                                   batch_size=cfg.score_batch_size, train=False,
                                   canvases=canvases, group_ids=test_group_ids)
            stats = evaluate(model, test_loader, test_ds, kind=cfg.eval_kind, device=device,
                             classwise=cfg.classwise)
        _sync(device)
        t_eval = time.time()

        if cfg.output_dir and not resuming_here and rank0:
            save_checkpoint(os.path.join(cfg.output_dir, f"cycle_{cycle}"), model, optimizer,
                            scheduler, pool=pool,
                            rng={"seed": cfg.seed, "torch_cpu": torch.get_rng_state()},
                            meta=_carry_meta(cycle, strategy_state),
                            extra=_carry_extra(strategy_state))

        t_score = time.time()
        if cycle < cfg.cycles - 1:
            chosen = score_and_select(cfg, model, train_ds, pool, canvases, group_ids,
                                      cycle=cycle, device=device,
                                      strategy_state=strategy_state)
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
