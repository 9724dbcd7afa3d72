"""Seeded detector weights, made by the benchmark on the device.

The scheme is a copy of ``cald_tpu_torch/models/init.py``'s families
(truncated kaiming fan-out convolutions, ``normal(0.01)`` detection heads,
truncated lecun-normal Dense layers, zero biases, RetinaNet's focal prior on
``cls_logits``), drawn from one uniform draw of a ``torch.Generator`` on the
device and shaped per leaf by the inverse normal CDF. A module of the
reference may list further leaves (``seeded_leaves()``, as (tensor, family,
std): a relative position bias table, say), drawn from the same draw after
every Conv and Dense weight; a parameter that neither is covered nor is a
norm's affine pair, which its constructor sets to ones and zeros, stops the
seeding with an error. Then the configuration's
head gains (``chip_smoke.py``'s ``HEAD_GAINS``, so that a random detector's
scores and boxes spread out as a detector's do) and the frozen norms
calibrated on one batch of the cell's own images, by the plain reference, so
that activations stay bounded through the backbone. The state dict is the
reference's; the program loads the same one.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from plainref.models.layers import Conv, Dense, FrozenBatchNorm, GroupNorm

# Flax's truncated normal rescales its std by the std of a unit normal cut at +-2
_TRUNC_STD = 0.87962566103423978
_HEAD_NORMAL = ("rpn_head.", "head.")
_LECUN_CONVS = ("fc1", "fc2", "reduce")
# norms whose constructors set their affine parameters to ones and zeros
_NORMS = (GroupNorm, nn.GroupNorm, nn.LayerNorm)


def _phi(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def _leaves(model) -> list[tuple[torch.Tensor, str, float]]:
    """(weight, family, std) of every Conv and Dense, in module order, then
    every module's ``seeded_leaves()``, in module order."""
    out = []
    for name, m in model.named_modules():
        if isinstance(m, Conv):
            o, i, kh, kw = m.weight.shape
            if name.startswith(_HEAD_NORMAL):
                out.append((m.weight, "normal", 0.01))
            elif name.rsplit(".", 1)[-1] in _LECUN_CONVS:
                out.append((m.weight, "trunc", math.sqrt(1.0 / (i * kh * kw))))
            else:
                out.append((m.weight, "trunc", math.sqrt(2.0 / (o * kh * kw))))
        elif isinstance(m, Dense):
            if name.startswith("box_predictor"):
                out.append((m.weight, "normal", 0.01))
            else:
                out.append((m.weight, "trunc", math.sqrt(1.0 / m.weight.shape[1])))
    for m in model.modules():
        if hasattr(m, "seeded_leaves"):
            out += list(m.seeded_leaves())
    return out


def _unseeded(model, leaves) -> list[str]:
    """The parameters that neither ``random_init_`` sets (the leaves, Conv
    and Dense biases) nor a norm's constructor sets to a constant."""
    covered = {id(w) for w, _, _ in leaves}
    for m in model.modules():
        if isinstance(m, (Conv, Dense)) and m.bias is not None:
            covered.add(id(m.bias))
        elif isinstance(m, _NORMS):
            covered |= {id(p) for p in m.parameters(recurse=False)}
    return [name for name, p in model.named_parameters() if id(p) not in covered]


@torch.no_grad()
def random_init_(model, seed: int, prior_probability: float | None = None) -> None:
    """Every Conv and Dense weight and every listed leaf of the reference
    ``model`` (already on its device) from one uniform draw of a generator
    seeded with ``seed``; zero biases, and the focal prior on
    ``head.cls_logits`` where given. Raises where a parameter is left as its
    constructor made it and is no norm's."""
    leaves = _leaves(model)
    stray = _unseeded(model, leaves)
    if stray:
        raise ValueError(f"no seeded family covers {', '.join(stray)}: list them in their "
                         f"module's seeded_leaves()")
    dev = leaves[0][0].device
    g = torch.Generator(device=dev).manual_seed(seed % 2 ** 63)
    total = sum(w.numel() for w, _, _ in leaves)
    u = torch.rand(total, generator=g, device=dev, dtype=torch.float32)
    lo, hi = _phi(-2.0), _phi(2.0)
    off = 0
    for w, family, std in leaves:
        part = u[off:off + w.numel()].view_as(w)
        off += w.numel()
        if family == "trunc":
            # inverse CDF of the unit normal cut at +-2, scaled as Flax scales it
            p = lo + part * (hi - lo)
            w.copy_(math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0) * (std / _TRUNC_STD))
        else:
            p = part.clamp(1e-7, 1.0 - 1e-7)
            w.copy_(math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0) * std)
    for name, m in model.named_modules():
        if isinstance(m, (Conv, Dense)) and m.bias is not None:
            m.bias.zero_()
            if name == "head.cls_logits" and prior_probability is not None:
                m.bias.fill_(-math.log((1.0 - prior_probability) / prior_probability))


@torch.no_grad()
def apply_gains_(model, gains: dict, biases: dict) -> None:
    """Multiply the named modules' weights by ``gains``; set the named
    modules' biases to ``biases``."""
    mods = dict(model.named_modules())
    for name, gain in gains.items():
        mods[name].weight.mul_(gain)
    for name, b in biases.items():
        mods[name].bias.fill_(b)


@torch.no_grad()
def calibrate_norms_(model, images, valid_hw, min_var_share: float) -> None:
    """Every frozen norm's mean and variance set to its input's statistics on
    one batch, in forward order (``chip_smoke.py::calibrate_norms_``). A
    variance below ``min_var_share`` of its layer's median variance (a
    channel the random weights leave all but dead) is raised to it: left at
    ~0, such a channel's gain of up to 1/sqrt(eps) turns rounding noise into
    signal, and the detector's output would follow the rounding."""
    def pre_hook(mod, args):
        x = args[0].float()
        var = x.var(dim=(0, 2, 3))
        mod.mean.copy_(x.mean(dim=(0, 2, 3)))
        mod.var.copy_(var.clamp_min(min_var_share * var.median().item()))

    handles = [m.register_forward_pre_hook(pre_hook) for m in model.modules()
               if isinstance(m, FrozenBatchNorm)]
    try:
        model.features(images, valid_hw)
    finally:
        for h in handles:
            h.remove()


def seeded_weights(config: dict, seed: int, device):
    """The plain reference detector of ``config`` with the seed's weights
    before calibration: the init scheme, the head gains, and every
    bottleneck's last norm scaled."""
    from harness.check_score import reference_model

    ref = reference_model(config, device)
    w = config["weights"]
    random_init_(ref, seed, getattr(ref.cfg, "prior_probability", None))
    apply_gains_(ref, w["head_gains"], w.get("biases", {}))
    with torch.no_grad():
        for name, m in ref.named_modules():
            if name.endswith(".bn3"):
                m.scale.fill_(w["residual_norm_scale"])
    return ref


def seeded_reference(config: dict, paths, seed: int, device):
    """The plain reference detector of ``config`` with the seed's weights
    (``seeded_weights``) and its frozen norms calibrated on the canvas of
    ``paths`` (images of one canvas)."""
    from plainref.canvas import batch_canvas

    ref = seeded_weights(config, seed, device)
    w = config["weights"]
    images, hw = batch_canvas(paths, list(range(len(paths))), config["min_size"],
                              config["max_size"], device)
    calibrate_norms_(ref, images, hw, w["min_var_share"])
    return ref
