"""Random selection baseline (port of
``cald_tpu/strategies/random_strategy.py``; reference random_train.py:208-212)."""

from __future__ import annotations

import numpy as np


def random_select(pool_size: int, budget: int, rng: np.random.Generator) -> np.ndarray:
    """Uniformly choose ``budget`` pool positions (the reference shuffles the
    unlabeled list and takes the head)."""
    return rng.permutation(pool_size)[:budget]
