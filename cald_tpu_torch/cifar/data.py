"""CIFAR-10 data for the LL4AL demo (port of ``cald_tpu/cifar/data.py``).

Reads the standard python-pickle batch files (``cifar-10-batches-py/``) and
makes a seeded synthetic set (the JAX package's arrays, byte for byte).
Augmentation is batched on the device: a random horizontal flip and a random
32x32 crop from 4 pixels of zero padding (ll4al/main.py:41-47), then the
per-channel normalisation. The flips and crop offsets are inputs
(``augment_draws`` draws them from a ``torch.Generator``), so tests can
inject the JAX package's.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2023, 0.1994, 0.2010)
PAD = 4


def load_cifar10(root: str):
    """Returns (train_images (50000, 32, 32, 3) uint8, train_labels (50000,),
    test_images, test_labels) from the standard batch files."""
    d = os.path.join(root, "cifar-10-batches-py")

    def read(name):
        with open(os.path.join(d, name), "rb") as f:
            raw = pickle.load(f, encoding="bytes")
        x = raw[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x, np.asarray(raw[b"labels"], np.int32)

    xs, ys = zip(*[read(f"data_batch_{i}") for i in range(1, 6)])
    tx, ty = read("test_batch")
    return np.concatenate(xs), np.concatenate(ys), tx, ty


def synthetic_cifar(num_train: int = 512, num_test: int = 128, num_classes: int = 10,
                    seed: int = 0):
    """Class-coloured noise images: trivially learnable, no I/O."""
    rng = np.random.default_rng(seed)

    def make(n):
        y = rng.integers(0, num_classes, n).astype(np.int32)
        base = (np.linspace(0, 255, num_classes)[y])[:, None, None, None]
        x = np.clip(base + rng.normal(0, 40, (n, 32, 32, 3)), 0, 255)
        return x.astype(np.uint8), y

    xtr, ytr = make(num_train)
    xte, yte = make(num_test)
    return xtr, ytr, xte, yte


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8/float 0..255 (B, H, W, 3) -> normalised float32 (ll4al/main.py:45)."""
    mean = torch.tensor(CIFAR10_MEAN, device=images.device)
    std = torch.tensor(CIFAR10_STD, device=images.device)
    return (images.float() / 255.0 - mean) / std


def augment_draws(generator: torch.Generator, b: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(flip (B,) bool, crop offsets (B, 2) int64 in [0, 2 * PAD]) drawn
    from ``generator`` on its device."""
    dev = generator.device
    flip = torch.rand(b, generator=generator, device=dev) < 0.5
    offsets = torch.randint(0, 2 * PAD + 1, (b, 2), generator=generator, device=dev)
    return flip, offsets


def augment_batch(images: torch.Tensor, flip: torch.Tensor,
                  offsets: torch.Tensor) -> torch.Tensor:
    """Flip the images where ``flip``, pad by 4 with zeros and crop the
    (H, W) window at ``offsets`` (row, column). images (B, H, W, 3) raw
    0..255; returns the same shape and range."""
    b, h, w, _ = images.shape
    images = torch.where(flip.to(images.device)[:, None, None, None], images.flip(2), images)
    padded = torch.nn.functional.pad(images, (0, 0, PAD, PAD, PAD, PAD))
    offsets = offsets.to(images.device)
    rows = offsets[:, 0:1] + torch.arange(h, device=images.device)          # (B, H)
    cols = offsets[:, 1:2] + torch.arange(w, device=images.device)          # (B, W)
    bi = torch.arange(b, device=images.device)[:, None, None]
    return padded[bi, rows[:, :, None], cols[:, None, :]]
