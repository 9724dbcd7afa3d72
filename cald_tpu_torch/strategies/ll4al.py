"""LL4AL: learning-loss active learning (port of
``cald_tpu/strategies/ll4al.py``; reference ll_train.py).

Joint training: the detector produces per-image loss vectors
(``model.loss(per_image=True)``) whose sum is the target of a LossNet
ranking head over the FPN features; after ``task_epochs`` the features
feeding LossNet are detached (ll_train.py:90-95). Scoring = LossNet
prediction on the pool; selection = top-budget, descending
(ll_train.py:278-284).

Under multi-process data parallelism the ranking loss pairs image i with
image flip(i) of the global batch, as the JAX package's jitted step does on
its global arrays: rank 0's image i pairs with the last rank's image B-1-i.
The ranks' predicted losses are gathered differentiably (``gather_cat``),
every rank computes the same ranking loss, and each rank's LossNet gradient
flows back through its own slice.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from cald_tpu_torch.data.batching import images_tensor
from cald_tpu_torch.models.lossnet import loss_pred_loss
from cald_tpu_torch.models.matcher import Draw
from cald_tpu_torch.parallel import gather_cat, process_mean, reduce_gradients_


def make_ll_train_step(model, lossnet, optimizer: torch.optim.Optimizer,
                       ll_optimizer: torch.optim.Optimizer, scheduler=None,
                       ll_scheduler=None, *, ll_weight: float = 1.0) -> Callable:
    """Returns step(images, valid_hw, gt_boxes, gt_labels, gt_valid, draw, *,
    detach_features) -> metrics (``task_loss``, ``ll_loss``, ``loss``:
    detached device scalars). One backward of ``mean(per_image) + ll_weight
    * ll`` updates the detector and LossNet, each with its own optimizer and
    scheduler; under data parallelism ``ll`` is the global batch's and the
    gradients and metrics are averaged over the ranks."""

    def step(images, valid_hw, gt_boxes, gt_labels, gt_valid, draw: Draw, *,
             detach_features: bool) -> dict:
        losses, pyramid = model.loss(images, valid_hw, gt_boxes, gt_labels, gt_valid, draw,
                                     per_image=True)
        per_image = sum(losses.values())                               # (B,)
        feats = pyramid[: lossnet.num_levels]
        if detach_features:
            feats = [f.detach() for f in feats]
        ll = loss_pred_loss(gather_cat(lossnet(feats)), gather_cat(per_image.detach()))
        task_loss = per_image.mean()
        total = task_loss + ll_weight * ll
        optimizer.zero_grad(set_to_none=True)
        ll_optimizer.zero_grad(set_to_none=True)
        total.backward()
        reduce_gradients_(optimizer, ll_optimizer)
        optimizer.step()
        ll_optimizer.step()
        for s in (scheduler, ll_scheduler):
            if s is not None:
                s.step()
        metrics = process_mean(torch.stack([task_loss.detach(), ll.detach(), total.detach()]))
        return dict(zip(("task_loss", "ll_loss", "loss"), metrics.unbind()))

    return step


def make_ll_score_fn(model, lossnet) -> Callable:
    """fn(images, valid_hw) -> predicted losses (B,): LossNet on the
    detector's FPN features, no RoI work (ll_train.py:145-166)."""

    @torch.inference_mode()
    def fn(images: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
        return lossnet(model.features(images, valid_hw))

    return fn


def ll_scores(score_fn: Callable, loader: Iterable, pool_indices: Sequence[int],
              device) -> np.ndarray:
    """(N,) float64 predicted losses aligned with ``pool_indices``."""
    pos = {int(idx): i for i, idx in enumerate(pool_indices)}
    out = np.zeros((len(pool_indices),))
    for batch in loader:
        p = score_fn(images_tensor(batch.images, device),
                     torch.from_numpy(np.asarray(batch.valid_hw)).to(device))
        p = p.double().cpu().numpy()
        for i, idx in enumerate(batch.image_idx):
            out[pos[int(idx)]] = p[i]
    return out


def ll_select(pred_losses: np.ndarray, budget: int) -> np.ndarray:
    """Top-budget by predicted loss, descending (ll_train.py:278-284)."""
    return np.argsort(-pred_losses, kind="stable")[:budget]
