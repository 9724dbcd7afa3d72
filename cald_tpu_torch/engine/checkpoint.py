"""Per-cycle checkpoints (port of ``cald_tpu/engine/checkpoint.py``).

A checkpoint is a directory of ``torch.save`` files: ``model.pt`` (the
model's ``state_dict``), ``optimizer.pt`` (optimizer and scheduler state)
and ``al.pt`` (the ``ALPoolState``, ``meta``, the RNG state and any
strategy carry-state under ``extra``). Everything is saved as tensors and
plain Python values, so ``torch.load(..., weights_only=True)`` reads it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cald_tpu_torch.data.pool import ALPoolState


def _plain(v):
    """numpy arrays -> tensors, numpy scalars -> Python numbers."""
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v)
    if isinstance(v, np.generic):
        return v.item()
    return v


def _numpy(v):
    return v.numpy() if isinstance(v, torch.Tensor) else v


def save_checkpoint(path: str, model: torch.nn.Module, optimizer=None, scheduler=None, *,
                    pool: ALPoolState | None = None, rng: dict | None = None,
                    meta: dict | None = None, extra: dict | None = None):
    """Write a checkpoint directory at ``path``. ``rng``: e.g. ``{"seed": s,
    "torch_cpu": torch.get_rng_state()}``."""
    os.makedirs(path, exist_ok=True)
    torch.save(model.state_dict(), os.path.join(path, "model.pt"))
    torch.save({"optimizer": optimizer.state_dict() if optimizer is not None else None,
                "scheduler": scheduler.state_dict() if scheduler is not None else None},
               os.path.join(path, "optimizer.pt"))
    torch.save({"pool": {k: _plain(v) for k, v in pool.to_dict().items()} if pool else None,
                "rng": rng, "meta": {k: _plain(v) for k, v in (meta or {}).items()},
                "extra": {k: _plain(v) for k, v in (extra or {}).items()}},
               os.path.join(path, "al.pt"))


def _al(path: str) -> dict:
    return torch.load(os.path.join(path, "al.pt"), weights_only=True)


def peek_checkpoint(path: str):
    """(pool | None, rng | None, meta dict) without a model: ``al_loop``'s
    ``--resume`` reads the pool first, since it sets the cycle's loader
    sizes and so the schedule that ``load_checkpoint`` then fills."""
    raw = _al(path)
    pool = raw["pool"]
    pool = ALPoolState.from_dict({k: _numpy(v) for k, v in pool.items()}) if pool else None
    return pool, raw["rng"], raw["meta"]


def load_extra(path: str) -> dict:
    """The strategy carry-state saved under ``extra`` ({} if none)."""
    return {k: _numpy(v) for k, v in _al(path)["extra"].items()}


def load_checkpoint(path: str, model: torch.nn.Module, optimizer=None, scheduler=None):
    """Restore into the given model (and optimizer/scheduler, where saved).
    Returns (pool | None, rng | None, meta dict)."""
    model.load_state_dict(torch.load(os.path.join(path, "model.pt"), weights_only=True,
                                     map_location="cpu"))
    opt = torch.load(os.path.join(path, "optimizer.pt"), weights_only=True,
                     map_location="cpu")
    if optimizer is not None and opt["optimizer"] is not None:
        optimizer.load_state_dict(opt["optimizer"])
    if scheduler is not None and opt["scheduler"] is not None:
        scheduler.load_state_dict(opt["scheduler"])
    return peek_checkpoint(path)
