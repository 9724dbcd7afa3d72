"""Active-learning pool bookkeeping as explicit, checkpointable state (copy of
``cald_tpu/data/pool.py``).

The reference keeps ``labeled_set`` / ``unlabeled_set`` as transient Python lists
(reference cald_train.py:307-310,446-459) that are lost on restart
(SURVEY.md §5 'checkpoint/resume'). Here the split is a small dataclass of numpy
arrays that serializes alongside model checkpoints, so an AL run is resumable at
any cycle boundary.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ALPoolState:
    """Labeled/unlabeled index split plus cycle counter."""

    labeled: np.ndarray     # int64, sorted unique dataset indices
    unlabeled: np.ndarray   # int64
    cycle: int = 0
    seed: int = 0

    @classmethod
    def initial(cls, num_images: int, init_num: int, seed: int = 0) -> "ALPoolState":
        """Shuffle all indices and take the first ``init_num`` as the seed set
        (reference cald_train.py:307-310)."""
        rng = np.random.default_rng(seed)
        perm = rng.permutation(num_images)
        return cls(labeled=np.sort(perm[:init_num]),
                   unlabeled=np.sort(perm[init_num:]),
                   cycle=0, seed=seed)

    def select(self, chosen: np.ndarray) -> "ALPoolState":
        """Move ``chosen`` dataset indices from unlabeled to labeled and advance
        the cycle (reference cald_train.py:446-459)."""
        chosen = np.asarray(chosen, dtype=np.int64)
        if not np.isin(chosen, self.unlabeled).all():
            raise ValueError("selection contains indices not in the unlabeled pool")
        labeled = np.sort(np.concatenate([self.labeled, chosen]))
        unlabeled = np.setdiff1d(self.unlabeled, chosen, assume_unique=True)
        return ALPoolState(labeled=labeled, unlabeled=unlabeled,
                           cycle=self.cycle + 1, seed=self.seed)

    def subsample_pool(self, max_pool: int, rng: np.random.Generator) -> np.ndarray:
        """Random pool subsample for scoring (COCO caps at 10000,
        reference cald_train.py:428-431)."""
        if len(self.unlabeled) <= max_pool:
            return self.unlabeled.copy()
        return np.sort(rng.choice(self.unlabeled, size=max_pool, replace=False))

    def to_dict(self) -> dict:
        return {"labeled": self.labeled, "unlabeled": self.unlabeled,
                "cycle": np.int64(self.cycle), "seed": np.int64(self.seed)}

    @classmethod
    def from_dict(cls, d: dict) -> "ALPoolState":
        return cls(labeled=np.asarray(d["labeled"], np.int64),
                   unlabeled=np.asarray(d["unlabeled"], np.int64),
                   cycle=int(d["cycle"]), seed=int(d["seed"]))
