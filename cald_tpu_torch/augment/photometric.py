"""Photometric augmentations on fixed-canvas batches (port of
``cald_tpu/augment/photometric.py``). Boxes are unchanged.

Images are (B, H, W, C) tensors of RAW 0..255 pixels whose top-left
``valid_hw[b]`` region is valid; every function leaves the padding as it
was. The reference (``cald_helper.py:56-85``) works on 0..1 tensors, so its
constants are rescaled as the JAX package rescales them: noise std in pixel
units, clamps at 255.

Every random draw is an input, as cutout's are: the standard normals of
``gaussian_noise``, the uniforms of ``salt_pepper_noise`` and the
permutation index of ``color_swap``, so tests can inject the JAX package's
draws.
"""

from __future__ import annotations

import torch

_GRAY = (0.2989, 0.587, 0.114)
# the channel orders of the JAX package's ``_PERMS``, in its order
PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


def _valid_mask(images: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) bool: the valid region of each image."""
    _, h, w, _ = images.shape
    rows = torch.arange(h, device=images.device)[None, :] < valid_hw[:, 0:1]
    cols = torch.arange(w, device=images.device)[None, :] < valid_hw[:, 1:2]
    return (rows[:, :, None] & cols[:, None, :])[..., None]


def gaussian_noise(images: torch.Tensor, valid_hw: torch.Tensor, normals: torch.Tensor,
                   std: float = 1.0) -> torch.Tensor:
    """images + normals * std on the valid region, unclamped (the reference's
    ``+ randn * std / 255`` on 0..1 pixels). ``normals`` (B, H, W, C) are
    standard normals, taken in the images' dtype as JAX draws them."""
    noisy = images + normals.to(images.dtype) * std
    return torch.where(_valid_mask(images, valid_hw), noisy, images)


def salt_pepper_noise(images: torch.Tensor, valid_hw: torch.Tensor, u: torch.Tensor,
                      prob: float = 0.1) -> torch.Tensor:
    """Where u < prob/2 the image's max over its valid region ('salt'), where
    u > 1 - prob/2 its min ('pepper'). ``u`` (B, H, W, C) uniforms in [0, 1)."""
    mask = _valid_mask(images, valid_hw)
    inf = torch.tensor(float("inf"), dtype=images.dtype, device=images.device)
    big = torch.where(mask, images, -inf).amax(dim=(1, 2, 3), keepdim=True)
    small = torch.where(mask, images, inf).amin(dim=(1, 2, 3), keepdim=True)
    out = torch.where(u < prob / 2, big, images)
    out = torch.where(u > 1 - prob / 2, small, out)
    return torch.where(mask, out, images)


def color_swap(images: torch.Tensor, valid_hw: torch.Tensor,
               perm_index: torch.Tensor) -> torch.Tensor:
    """Permute the channels of each image's valid region by ``PERMS[perm_index[b]]``
    (``perm_index`` (B,) integers in 0..5)."""
    perms = torch.tensor(PERMS, dtype=torch.int64, device=images.device)
    order = perms[perm_index.long()][:, None, None, :].expand_as(images)
    swapped = torch.gather(images, -1, order)
    return torch.where(_valid_mask(images, valid_hw), swapped, images)


def _gray(images: torch.Tensor) -> torch.Tensor:
    return images @ torch.tensor(_GRAY, dtype=images.dtype, device=images.device)


def color_adjust(images: torch.Tensor, valid_hw: torch.Tensor, factor: float,
                 white_level: float = 255.0) -> torch.Tensor:
    """Brightness x factor, then contrast x factor (blended with the mean gray
    of the valid region), then saturation x factor (blended with each pixel's
    gray), each clamped to [0, white_level]: torchvision's functional
    adjustments, which the reference applies in this order."""
    mask = _valid_mask(images, valid_hw)
    out = (images * factor).clamp(0.0, white_level)
    m = mask[..., 0]
    n_valid = m.sum(dim=(1, 2)).clamp_min(1)
    mean_gray = torch.where(m, _gray(out), 0.0).sum(dim=(1, 2)) / n_valid
    out = (factor * out + (1 - factor) * mean_gray[:, None, None, None]).clamp(0.0, white_level)
    out = (factor * out + (1 - factor) * _gray(out)[..., None]).clamp(0.0, white_level)
    return torch.where(mask, out, images)
