"""LR schedules of the reference's training recipe (port of
``cald_tpu/engine/schedules.py``).

MultiStepLR(milestones=[16, 19], gamma=0.1) stepped per EPOCH, combined with
a linear warmup over the first 1000 iterations of epoch 0 from factor 1/1000.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def warmup_factor(step: int, warmup_iters: int, warmup_factor0: float) -> float:
    """Linear ``warmup_factor0`` -> 1 over ``warmup_iters`` iterations."""
    alpha = min(float(step), warmup_iters) / warmup_iters
    return warmup_factor0 * (1.0 - alpha) + alpha


def multistep_with_warmup(base_lr: float, steps_per_epoch: int,
                          milestones: Sequence[int] = (16, 19), gamma: float = 0.1,
                          warmup_iters: int = 1000,
                          warmup_factor0: float = 1.0 / 1000.0) -> Callable[[int], float]:
    """schedule(step) -> lr, the step counted in iterations: warmup only in
    epoch 0, capped at min(1000, steps_per_epoch - 1) iterations, and a decay
    by ``gamma`` at each milestone epoch."""
    wi = max(1, min(warmup_iters, steps_per_epoch - 1)) if steps_per_epoch > 1 else 1
    ms = sorted(milestones)

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        decay = gamma ** sum(epoch >= m for m in ms)
        wf = warmup_factor(step, wi, warmup_factor0) if epoch == 0 else 1.0
        return base_lr * decay * wf

    return schedule


def lr_scheduler(optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float]) -> torch.optim.lr_scheduler.LambdaLR:
    """A ``LambdaLR`` that sets the learning rate to ``schedule(step)``; step
    it once per iteration, after ``optimizer.step()``."""
    base = optimizer.defaults["lr"]
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: schedule(step) / base)
