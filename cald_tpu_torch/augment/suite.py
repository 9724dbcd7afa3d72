"""The CALD augmentation suite (port of the geometric part of
``cald_tpu/augment/suite.py``): build every augmented variant of a batch at
once, ready for one batched detector forward.

Aug-string protocol: 'F' flip, 'C' cut_out(2), 'D' smaller_resize(0.8),
'R' rotation(5 deg). Parameterized names ('cut_out:3', 'resize:0.7',
'rotation:10') are accepted too. The reference's photometric codes 'G'
(gaussian noise) and 'S' (salt-pepper) are not ported yet and are refused;
any other character is ignored, as the reference ignores it.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from cald_tpu_torch.augment.cutout import cutout
from cald_tpu_torch.augment.geometry import (
    horizontal_flip, resize_image_boxes, rotate_image_boxes,
)

AUG_CODES = {"F": "flip", "C": "cut_out", "D": "smaller_resize", "R": "rotation"}
# codes of the reference's protocol that the port does not run yet
UNPORTED_CODES = {"G": "ga", "S": "sp"}
CUTOUT_ATTEMPTS = 50

# draw(aug_index, shape) -> uniforms in [0, 1) on the images' device
Draw = Callable[[int, tuple], torch.Tensor]


def expand_aug_string(augs: str) -> list[str]:
    """'FCDR' -> ['flip', 'cut_out', 'smaller_resize', 'rotation'] in the
    reference scorer's evaluation order. Raises ``NotImplementedError`` for
    a code the reference knows and the port does not run ('G', 'S'): scoring
    without it would select other images, with no error."""
    missing = [ch for ch in dict.fromkeys(augs) if ch in UNPORTED_CODES]
    if missing:
        raise NotImplementedError(
            "--augs codes " + ", ".join(f"{ch!r} ({UNPORTED_CODES[ch]})" for ch in missing)
            + " are not ported yet (ROADMAP queue 1 item 1)")
    order = ["flip", "cut_out", "smaller_resize", "rotation"]
    names = {AUG_CODES[ch] for ch in augs if ch in AUG_CODES}
    return [n for n in order if n in names]


def generator_draw(generator: torch.Generator) -> Draw:
    """A ``Draw`` that takes its uniforms from ``generator`` (on its device)."""
    return lambda i, shape: torch.rand(shape, generator=generator,
                                       device=generator.device)


def _apply(name: str, index: int, images, boxes, box_valid, valid_hw, draw: Draw):
    base, _, arg = name.partition(":")
    val = float(arg) if arg else None
    if base == "flip":
        return horizontal_flip(images, boxes, valid_hw)
    if base == "cut_out":
        u = draw(index, (images.shape[0], CUTOUT_ATTEMPTS, 4)).to(images.device)
        return (cutout(images, boxes, box_valid, valid_hw, u,
                       cut_num=int(val) if val is not None else 2), boxes, valid_hw)
    if base == "smaller_resize":
        return resize_image_boxes(images, boxes, valid_hw, val or 0.8)
    if base == "resize":
        return resize_image_boxes(images, boxes, valid_hw, val)
    if base == "rotation":
        return rotate_image_boxes(images, boxes, valid_hw, val or 5.0)
    raise ValueError(f"unknown augmentation {name!r}")


def build_aug_batch(images: torch.Tensor, ref_boxes: torch.Tensor,
                    ref_valid: torch.Tensor, valid_hw: torch.Tensor,
                    aug_names: Sequence[str], draw: Draw):
    """Apply every augmentation to every image.

    images (B, H, W, C); ref_boxes (B, K, 4); ref_valid (B, K); valid_hw
    (B, 2). ``draw(i, shape)`` supplies the uniforms of augmentation i.
    Returns aug_images (B, A, H, W, C), aug_boxes (B, A, K, 4) and
    aug_valid_hw (B, A, 2).
    """
    outs = [_apply(name, i, images, ref_boxes, ref_valid, valid_hw, draw)
            for i, name in enumerate(aug_names)]
    return tuple(torch.stack([o[j] for o in outs], dim=1) for j in range(3))
