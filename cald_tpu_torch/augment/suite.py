"""The CALD augmentation suite (port of ``cald_tpu/augment/suite.py``): build
every augmented variant of a batch at once, ready for one batched detector
forward.

Aug-string protocol: 'F' flip, 'C' cut_out(2), 'D' smaller_resize(0.8),
'R' rotation(5 deg), 'G' gaussian noise (std 16), 'S' salt-pepper (0.1);
any other character is ignored, as the reference ignores it. The long-form
names of the reference's scorer are accepted too, parameterized ('ga:24',
'sp:0.15', 'cut_out:3', 'resize:0.7', 'rotation:10', 'color_adjust:2') or
not; the ``multi_*`` families expand with ``expand_multi``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from cald_tpu_torch.augment.cutout import cutout
from cald_tpu_torch.augment.geometry import (
    horizontal_flip, resize_image_boxes, rotate_image_boxes,
)
from cald_tpu_torch.augment.photometric import (
    PERMS, color_adjust, color_swap, gaussian_noise, salt_pepper_noise,
)

AUG_CODES = {"F": "flip", "C": "cut_out", "D": "smaller_resize", "R": "rotation",
             "G": "ga", "S": "sp"}
CUTOUT_ATTEMPTS = 50

# draw(aug_index, shape, kind="uniform") -> uniforms in [0, 1) ("uniform") or
# standard normals ("normal") of ``shape`` on the images' device; the first
# axis of ``shape`` is the batch, one draw per image
Draw = Callable[..., torch.Tensor]


def expand_aug_string(augs: str) -> list[str]:
    """'FCDR' -> ['flip', 'cut_out', 'smaller_resize', 'rotation'] in the
    reference scorer's evaluation order (flip, ga, cut_out, smaller_resize,
    rotation, sp)."""
    order = ["flip", "ga", "cut_out", "smaller_resize", "rotation", "sp"]
    names = {AUG_CODES[ch] for ch in augs if ch in AUG_CODES}
    return [n for n in order if n in names]


def expand_multi(name: str) -> list[str]:
    """Expand the reference's multi_* aug families (cald_train.py:131-183)
    into parameterized names."""
    if name == "multi_ga":            # std 8..48
        return [f"ga:{8 * i}" for i in range(1, 7)]
    if name == "multi_sp":            # prob 0.05..0.30
        return [f"sp:{0.05 * i:g}" for i in range(1, 7)]
    if name == "multi_cut_out":       # cut_num 1..4
        return [f"cut_out:{i}" for i in range(1, 5)]
    if name == "multi_resize":        # ratios 0.7..0.9
        return [f"resize:{i * 0.1:g}" for i in range(7, 10)]
    if name == "multi_color_adjust":  # factors 2..5
        return [f"color_adjust:{i}" for i in range(2, 6)]
    raise ValueError(f"unknown multi augmentation {name!r}")


def generator_draw(generator: torch.Generator) -> Draw:
    """A ``Draw`` that takes its uniforms and normals from ``generator`` (on
    its device)."""
    def draw(i, shape, kind="uniform"):
        fn = torch.randn if kind == "normal" else torch.rand
        return fn(shape, generator=generator, device=generator.device)
    return draw


def _apply(name: str, index: int, images, boxes, box_valid, valid_hw, draw: Draw):
    base, _, arg = name.partition(":")
    val = float(arg) if arg else None
    b = images.shape[0]
    if base == "flip":
        return horizontal_flip(images, boxes, valid_hw)
    if base == "cut_out":
        u = draw(index, (b, CUTOUT_ATTEMPTS, 4)).to(images.device)
        return (cutout(images, boxes, box_valid, valid_hw, u,
                       cut_num=int(val) if val is not None else 2), boxes, valid_hw)
    if base == "smaller_resize":
        return resize_image_boxes(images, boxes, valid_hw, val or 0.8)
    if base == "larger_resize":
        return resize_image_boxes(images, boxes, valid_hw, val or 1.2)
    if base == "resize":
        return resize_image_boxes(images, boxes, valid_hw, val)
    if base == "rotation":
        return rotate_image_boxes(images, boxes, valid_hw, val or 5.0)
    if base == "ga":
        normals = draw(index, tuple(images.shape), kind="normal").to(images.device)
        return gaussian_noise(images, valid_hw, normals, val or 16.0), boxes, valid_hw
    if base == "sp":
        u = draw(index, tuple(images.shape)).to(images.device)
        return salt_pepper_noise(images, valid_hw, u, val or 0.1), boxes, valid_hw
    if base == "color_adjust":
        return color_adjust(images, valid_hw, val or 1.5), boxes, valid_hw
    if base == "color_swap":
        # the index JAX draws with randint(key, (), 0, 6), from a uniform
        u = draw(index, (b,)).to(images.device)
        idx = torch.floor(u * len(PERMS)).long().clamp(0, len(PERMS) - 1)
        return color_swap(images, valid_hw, idx), boxes, valid_hw
    if base.startswith("multi_"):
        raise ValueError(f"{name}: expand with expand_multi() first")
    raise ValueError(f"unknown augmentation {name!r}")


def build_aug_batch(images: torch.Tensor, ref_boxes: torch.Tensor,
                    ref_valid: torch.Tensor, valid_hw: torch.Tensor,
                    aug_names: Sequence[str], draw: Draw):
    """Apply every augmentation to every image.

    images (B, H, W, C); ref_boxes (B, K, 4); ref_valid (B, K); valid_hw
    (B, 2). ``draw(i, shape, kind)`` supplies the random draws of
    augmentation i. Returns aug_images (B, A, H, W, C), aug_boxes
    (B, A, K, 4) and aug_valid_hw (B, A, 2).
    """
    outs = [_apply(name, i, images, ref_boxes, ref_valid, valid_hw, draw)
            for i, name in enumerate(aug_names)]
    return tuple(torch.stack([o[j] for o in outs], dim=1) for j in range(3))
