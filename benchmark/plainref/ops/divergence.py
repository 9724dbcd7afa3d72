"""KL / Jensen-Shannon divergence (port of ``cald_tpu/ops/divergence.py``):
``scipy.stats.entropy`` semantics, both arguments normalized to sum to one,
natural log, ``0 * log(0/m) == 0``."""

from __future__ import annotations

import torch


def _normalize(p: torch.Tensor) -> torch.Tensor:
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def kl_divergence(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``sum(p * log(p / q))`` over the last axis after normalizing both."""
    p = _normalize(p)
    q = _normalize(q)
    pos = p > 0
    ratio = torch.where(pos, p / q.clamp_min(1e-30), torch.ones_like(p))
    return torch.where(pos, p * torch.log(ratio), torch.zeros_like(p)).sum(dim=-1)


def js_divergence(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``0.5 KL(p, m) + 0.5 KL(q, m)`` with ``m = (p + q) / 2`` formed from the
    raw rows (as the reference scorer does), clamped at zero."""
    m = (p + q) / 2.0
    return (0.5 * kl_divergence(p, m) + 0.5 * kl_divergence(q, m)).clamp_min(0.0)
