"""The train step and the host-side epoch loop (port of
``cald_tpu/engine/train.py``).

The JAX package's ``TrainState`` becomes the model, its optimizer and its
scheduler, updated in place. A step returns its metrics as device tensors and
adds no host sync of its own; the epoch loop reads them every ``print_freq``
steps and raises ``FloatingPointError`` on a non-finite loss (the reference
exits the process).

Under multi-process data parallelism (``cald_tpu_torch.parallel``) a step
averages its gradients and its metrics over the ranks: every loss is a mean
of per-image losses, so the result is the step of the global batch.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from cald_tpu_torch.data.batching import images_tensor
from cald_tpu_torch.engine.logging import MetricLogger
from cald_tpu_torch.models.matcher import Draw
from cald_tpu_torch.parallel import process_mean, reduce_gradients_


def make_train_step(model, optimizer: torch.optim.Optimizer, scheduler=None, *,
                    loss_weights: dict | None = None) -> Callable:
    """Returns step(images, valid_hw, gt_boxes, gt_labels, gt_valid, draw) ->
    metrics: the four losses and their (weighted) sum ``loss``, detached
    device scalars, averaged over the ranks. One step is FasterRCNN.loss,
    backward, the ranks' gradient average, an optimizer step and a scheduler
    step."""

    def step(images, valid_hw, gt_boxes, gt_labels, gt_valid, draw: Draw) -> dict:
        losses, _ = model.loss(images, valid_hw, gt_boxes, gt_labels, gt_valid, draw)
        if loss_weights:
            total = sum(losses[k] * w for k, w in loss_weights.items())
        else:
            total = sum(losses.values())
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        reduce_gradients_(optimizer)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        metrics = {**losses, "loss": total}
        return dict(zip(metrics, process_mean(torch.stack(
            [v.detach() for v in metrics.values()])).unbind()))

    return step


def train_one_epoch(step_fn: Callable, loader, draw: Draw, *, device, epoch: int,
                    cycle: int = 0, print_freq: int = 20,
                    logger: MetricLogger | None = None) -> dict:
    """Host loop over one epoch; returns the last step's metrics.

    ``loader`` yields batches with numpy ``images``, ``valid_hw``, ``boxes``,
    ``labels`` and ``box_valid``; ``draw`` supplies every step's sampling
    noise (``matcher.generator_gumbel``).
    """
    logger = logger or MetricLogger(delimiter="  ")
    header = f"Cycle: [{cycle}] Epoch: [{epoch}]"
    metrics: dict = {}
    for i, batch in enumerate(logger.log_every(loader, print_freq, header)):
        metrics = step_fn(images_tensor(batch.images, device), *(
            torch.from_numpy(a).to(device) for a in (
                batch.valid_hw, batch.boxes, batch.labels, batch.box_valid)), draw)
        if i % print_freq == 0:
            host = {k: float(v) for k, v in metrics.items()}
            if not math.isfinite(host["loss"]):
                raise FloatingPointError(f"Loss is {host['loss']}, stopping (losses: {host})")
            logger.update(**host)
    return metrics
