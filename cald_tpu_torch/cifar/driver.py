"""LL4AL CIFAR classification demo (port of ``cald_tpu/cifar/driver.py``): the
active-learning loop of the reference's ll4al/main.py, trials x cycles x
(train -> test -> score an unlabeled subset -> add the top-K by predicted
loss).

Reference semantics kept:
  - the ll4al/config.py constants: batch 128, subset 10000, addendum 1000,
    200 epochs, milestone 160, features detached into LossNet after epoch
    120, margin and weight 1, SGD(0.1, momentum 0.9, weight decay 5e-4) for
    both networks, fresh every cycle, with a 10x drop at the milestone;
  - the joint step: the backbone's per-sample cross-entropy, meaned, plus
    ``weight * LossPredLoss`` on the pair-flipped batch;
  - selection: a random subset of the unlabeled pool, ascending argsort of
    the predicted loss, the top ``addendum`` taken.

A step augments, normalises, runs both networks and updates them on the
device; the BatchNorm statistics follow Flax's update (``resnet.py``).

The rate drops ``milestone * steps_per_epoch`` steps into every cycle, with
the steps per epoch of the first cycle, as in the JAX package: its jitted
step binds the schedule when the model is built, and each cycle renews only
the optimizer state. (The reference's MultiStepLR counts each cycle's own
epochs, so its later cycles drop later.)
Random streams: the NumPy permutations are the JAX package's
(``default_rng(seed + 1000 * trial)``); the augmentation draws of (cycle,
epoch) come from a ``torch.Generator`` seeded from ``SeedSequence([seed,
cycle * 1000 + epoch])``, batch after batch (the port's own draws); the
backbone is initialised from ``seed`` and LossNet from ``seed + 1`` in Flax's
initial distributions (``models/init.py``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from cald_tpu_torch.cifar.data import augment_batch, augment_draws, normalize
from cald_tpu_torch.cifar.resnet import CifarResNet18
from cald_tpu_torch.models.init import lecun_init_, random_init_
from cald_tpu_torch.models.lossnet import LossNet, loss_pred_loss


@dataclasses.dataclass(frozen=True)
class CifarALConfig:
    """ll4al/config.py constants."""

    num_train: int = 50000
    batch: int = 128
    subset: int = 10000
    addendum: int = 1000
    margin: float = 1.0
    weight: float = 1.0
    trials: int = 3
    cycles: int = 10
    epochs: int = 200
    lr: float = 0.1
    milestones: tuple = (160,)
    epoch_loss: int = 120
    momentum: float = 0.9
    weight_decay: float = 5e-4
    num_classes: int = 10
    interm_dim: int = 128
    width: int = 64
    seed: int = 0


def _make_optimizer(cfg: CifarALConfig, module: torch.nn.Module, steps_per_epoch: int):
    """(SGD, scheduler): torch's weight decay is optax's
    ``add_decayed_weights`` ahead of ``sgd(momentum)``; the rate drops by 10x
    from step ``milestone * steps_per_epoch`` on (MultiStepLR per epoch)."""
    opt = torch.optim.SGD(module.parameters(), lr=cfg.lr, momentum=cfg.momentum,
                          weight_decay=cfg.weight_decay)
    bounds = [int(m) * steps_per_epoch for m in cfg.milestones]
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: 0.1 ** sum(step >= b for b in bounds))
    return opt, sched


def _stream(device, seed: int, n: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, n]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state >> np.uint64(1)))


class CifarLL4AL:
    """The backbone + LossNet pair on ``device`` (the card unless the
    caller asks for the CPU), with its train, test and scoring passes."""

    def __init__(self, cfg: CifarALConfig, steps_per_epoch: int, device="cuda"):
        self.cfg = cfg
        self.steps_per_epoch = steps_per_epoch
        self.device = torch.device(device)
        self.backbone = CifarResNet18(num_classes=cfg.num_classes, width=cfg.width)
        random_init_(self.backbone, cfg.seed)
        self.lossnet = LossNet(num_levels=4, interm_dim=cfg.interm_dim,
                               in_channels=self.backbone.stage_channels)
        lecun_init_(self.lossnet, cfg.seed + 1)
        self.backbone.to(self.device)
        self.lossnet.to(self.device)
        self.reset_optimizers()

    def reset_optimizers(self) -> None:
        """Fresh optimizers and schedules on the epoch length the model was
        built with (every cycle, ll4al/main.py:241-252)."""
        self.opt, self.sched = _make_optimizer(self.cfg, self.backbone, self.steps_per_epoch)
        self.ll_opt, self.ll_sched = _make_optimizer(self.cfg, self.lossnet, self.steps_per_epoch)

    def train_step(self, images: torch.Tensor, labels: torch.Tensor, flip: torch.Tensor,
                   offsets: torch.Tensor, *, detach: bool) -> dict:
        """One joint step on raw (B, 32, 32, 3) images with the given
        augmentation draws; returns ``loss``, ``ce`` and ``module`` as
        detached device scalars."""
        cfg = self.cfg
        self.backbone.train()
        x = normalize(augment_batch(images.to(self.device).float(), flip, offsets))
        logits, feats = self.backbone(x)
        ce = F.cross_entropy(logits, labels.to(self.device).long(), reduction="none")
        if detach:
            feats = [f.detach() for f in feats]
        mod = loss_pred_loss(self.lossnet(feats), ce, margin=cfg.margin)
        loss = ce.mean() + cfg.weight * mod
        self.opt.zero_grad(set_to_none=True)
        self.ll_opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.ll_opt.step()
        self.sched.step()
        self.ll_sched.step()
        return {"loss": loss.detach(), "ce": ce.mean().detach(), "module": mod.detach()}

    def train_epoch(self, images: np.ndarray, labels: np.ndarray, order, epoch: int,
                    generator: torch.Generator) -> dict:
        """One epoch over ``order``; a trailing partial batch is dropped, as
        in the JAX package (LossPredLoss wants even batches)."""
        cfg = self.cfg
        detach = epoch > cfg.epoch_loss          # strict >, ll4al/main.py:107
        metrics: dict = {}
        for bi in range(0, len(order) - cfg.batch + 1, cfg.batch):
            idx = order[bi: bi + cfg.batch]
            flip, offsets = augment_draws(generator, cfg.batch)
            metrics = self.train_step(torch.from_numpy(images[idx]), torch.from_numpy(labels[idx]),
                                      flip, offsets, detach=detach)
        return metrics

    @torch.inference_mode()
    def test_accuracy(self, images: np.ndarray, labels: np.ndarray, batch: int = 500) -> float:
        self.backbone.eval()
        correct = 0
        for bi in range(0, len(images), batch):
            x = normalize(torch.from_numpy(images[bi: bi + batch]).to(self.device))
            logits, _ = self.backbone(x)
            y = torch.from_numpy(labels[bi: bi + batch]).to(self.device)
            correct += int((logits.argmax(-1) == y).sum())
        return 100.0 * correct / len(images)

    @torch.inference_mode()
    def uncertainty(self, images: np.ndarray, indices, batch: int = 500) -> np.ndarray:
        """LossNet's predicted losses of ``images[indices]`` (float64)."""
        self.backbone.eval()
        idx = np.asarray(indices)
        out = np.zeros((len(idx),), np.float64)
        for bi in range(0, len(idx), batch):
            x = normalize(torch.from_numpy(images[idx[bi: bi + batch]]).to(self.device))
            _, feats = self.backbone(x)
            out[bi: bi + batch] = self.lossnet(feats).double().cpu().numpy()
        return out


def al_cifar_loop(cfg: CifarALConfig, train_images, train_labels, test_images, test_labels,
                  *, trial: int = 0, print_fn=print, device="cuda") -> list[dict]:
    """One trial of the reference loop (ll4al/main.py:219-290); one result
    dict per cycle (``cycle``, ``labeled``, ``acc``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    rng = np.random.default_rng(cfg.seed + 1000 * trial)
    indices = rng.permutation(len(train_images))
    labeled = list(indices[: cfg.addendum])
    unlabeled = list(indices[cfg.addendum:])

    model = CifarLL4AL(cfg, max(len(labeled) // cfg.batch, 1), device)
    history = []
    for cycle in range(cfg.cycles):
        t0 = time.time()
        # fresh optimizers every cycle; the weights persist across cycles
        model.reset_optimizers()
        for epoch in range(cfg.epochs):
            order = rng.permutation(labeled)
            model.train_epoch(train_images, train_labels, order, epoch,
                              _stream(device, cfg.seed, cycle * 1000 + epoch))
        acc = model.test_accuracy(test_images, test_labels)
        print_fn(f"Trial {trial + 1} || Cycle {cycle + 1}/{cfg.cycles} || "
                 f"Label set size {len(labeled)}: Test acc {acc:.2f} "
                 f"({time.time() - t0:.0f}s)")
        history.append({"cycle": cycle, "labeled": len(labeled), "acc": acc})
        if cycle == cfg.cycles - 1:
            break
        rng.shuffle(unlabeled)
        subset = unlabeled[: cfg.subset]
        u = model.uncertainty(train_images, subset)
        arg = np.argsort(u, kind="stable")          # ascending, main.py:267
        subset = np.asarray(subset)
        labeled += list(subset[arg][-cfg.addendum:])
        unlabeled = list(subset[arg][: -cfg.addendum]) + unlabeled[cfg.subset:]
    return history
