"""The correctness control: the plain reference put in the program's place,
each part computed in the precision just below the one the configuration
states for it, at the cell's own sizes (one score batch).

- convolutions and matrix products (bf16 in the configuration): fp8
  (e4m3, one scale a tensor, as an fp8 inference path would quantise):
  every module with a ``quant`` hook (``Conv``, ``Dense``, and ``Product``
  for the products between activations, such as attention's);
- the augmented images (bf16): fp8;
- box decoding, proposals, NMS, scores and consistency (float32): bf16,
  the inputs and outputs of each such stage rounded;
- the canvas's 8-bit pixels: 4 bits (16 levels).

Its readings of ``check_score``'s numbers are the upper readings from which
the limits were set (PERF.md).
"""

from __future__ import annotations

import copy

import torch

from harness import check_score, weights
from harness.capture import Capture, SampledBatch
from plainref.augment.suite import expand_aug_string, generator_draw
from plainref.cald import CALDConfig, make_cald_score_fn
from plainref.canvas import batch_canvas, image_size


def fp8(t: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled e4m3 rounding; the gradient passes straight
    through."""
    scale = t.detach().abs().amax().float().clamp_min(1e-12) / 448.0
    q = ((t.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)
    return t + (q - t.detach())


def fp8_images(t: torch.Tensor) -> torch.Tensor:
    """0..255 pixels rounded to e4m3 (which holds up to 448 unscaled)."""
    return t.float().to(torch.float8_e4m3fn).float().to(t.dtype)


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().to(t.dtype) if t.is_floating_point() else t


def four_bit(t: torch.Tensor) -> torch.Tensor:
    return torch.round(t / 255.0 * 15.0) * (255.0 / 15.0)


def control_model(ref):
    """A copy of the reference detector that computes as the control does."""
    ctl = copy.deepcopy(ref)
    for m in ctl.modules():
        if hasattr(m, "quant"):
            m.quant = fp8
    ctl.lowp = bf16
    return ctl


@torch.no_grad()
def control_sample(ref, paths, config: dict, traffic: dict, seed: int) -> SampledBatch:
    """The control's run of one score batch of ``paths`` with its capture."""
    dev = next(ref.parameters()).device
    ctl = control_model(ref)
    images, hw = batch_canvas(paths, list(range(len(paths))), config["min_size"],
                              config["max_size"], dev)
    images = four_bit(images)
    ccfg = CALDConfig(aug_names=tuple(expand_aug_string(traffic["augs"])),
                      base_point=traffic["base_point"])
    score_fn = make_cald_score_fn(ctl, ccfg, ref.cfg.num_classes, lowp_aug=fp8_images,
                                  lowp=bf16)
    gen = torch.Generator(device=dev).manual_seed(seed % 2 ** 63)
    state = gen.get_state()
    capture = Capture(ctl)
    capture.arm()
    try:
        c, corr = score_fn(images, hw, generator_draw(gen))
    finally:
        capture.disarm()
    return SampledBatch(paths=list(paths), draw_state=state, images=images, valid_hw=hw,
                        consistency=bf16(c), cls_corrs=bf16(corr), calls=capture.calls)


def readings(config: dict, traffic_name: str, traffic: dict, seed: int, device,
             cache_dir=None) -> dict:
    """The control's numbers for ``seed``: the weights and tree a run of
    that seed would have, the batch the first of its pool's canvases would
    score first."""
    from harness import traffic as traffic_mod

    layout = traffic_mod.build_tree(traffic_name, seed, traffic,
                                    **({"cache_dir": cache_dir} if cache_dir else {}))

    root = layout["root"] + "/VOC2007/JPEGImages/"
    paths = [f"{root}{i:06d}.jpg" for i in layout["pool"]]
    landscape = [p for p in paths if image_size(p)[1] >= image_size(p)[0]]
    b = traffic["batch_size"]
    batch = landscape[:b]
    ref = weights.seeded_reference(config, batch[:2], seed, device)
    sample = control_sample(ref, batch, config, traffic, seed)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return check_score.compare(sample, ref, config, traffic)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

