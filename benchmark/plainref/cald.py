"""CALD scoring and two-stage selection (port of ``cald_tpu/strategies/cald.py``).

Per pool batch: base detect -> subsample the detections -> build the augmented
batch on the device -> one batched detect over the B x A augmented images ->
consistency and per-class correlation. Selection (stage 1: ascending
consistency, keep ``mutual_range * budget``; stage 2: class-balance JS rank)
is NumPy on the host.

``shrink_slice`` (``--score-shrink-slice``, opt-in) detects the shrink-resize
augs on a smaller canvas: their content lives in the canvas's top-left
corner, so the slice ``ceil64(ratio * canvas)`` drops only zero padding. Augs
that share a slice share one detect; with 'FCDR' on a 640x1024 canvas the
resize detects on 512x832 and the other three on the full canvas, so a score
call makes three detects. Exact when the norms' biases are zero; with
trained biases the coarse levels' padding halo differs by canvas and shifts
scores slightly (the JAX package's EXPERIMENTS.md deviation study).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from plainref.augment.suite import Draw, build_aug_batch, generator_draw
from plainref.models.detections import Detections
from plainref.ops.consistency import cald_consistency, class_correlation


@dataclasses.dataclass(frozen=True)
class CALDConfig:
    aug_names: tuple = ("flip", "cut_out", "smaller_resize", "rotation")  # 'FCDR'
    base_point: float = 1.3
    mutual_range: float = 1.2
    uniform: bool = False
    no_mutual: bool = False
    k_ref: int = 50                   # subsample target
    subsample_threshold: int = 40     # subsample trigger
    shrink_slice: bool = False        # detect shrink-resize augs on a canvas slice


def subsample_reference(boxes, scores, labels, scores_cls, prob_max, valid, *,
                        k_ref: int = 50, threshold: int = 40):
    """The reference's detection subsampling on fixed slots: where an image
    has more than ``threshold`` valid detections keep ``round(linspace(0,
    n-1, k_ref))`` (duplicates kept), else its first ``k_ref`` slots.

    All inputs (B, K, ...) -> outputs (B, k_ref, ...).
    """
    n = valid.sum(dim=1)                                            # (B,)
    steps = torch.arange(k_ref, dtype=torch.float32, device=valid.device)
    stop = (n - 1).clamp_min(0).to(torch.float32)[:, None]
    lin = torch.round(stop * (steps / max(k_ref - 1, 1))).to(torch.int64)
    first = steps.to(torch.int64)[None].expand_as(lin)
    many = (n > threshold)[:, None]
    take = torch.where(many, lin, first)                            # (B, k_ref)
    # with fewer than k_ref slots the extra ones are invalid (JAX's take
    # fills them); they repeat the last slot here
    k = valid.shape[1]
    new_valid = (many | (first < n[:, None])) & (take < k)
    take = take.clamp_max(k - 1)

    def g(a):
        idx = take.reshape(take.shape + (1,) * (a.dim() - 2)).expand(
            (a.shape[0], k_ref) + a.shape[2:])
        return torch.gather(a, 1, idx)

    return (g(boxes), g(scores), g(labels), g(scores_cls), g(prob_max),
            new_valid & g(valid))


def _shrink_ratio(name: str) -> float | None:
    """Down-scale ratio of a resize-family augmentation, else None."""
    base, _, arg = name.partition(":")
    if base == "smaller_resize":
        return float(arg) if arg else 0.8
    if base == "resize" and arg and float(arg) < 1.0:
        return float(arg)
    return None


def _ceil_mult(x: float, m: int = 64) -> int:
    return int(math.ceil(x / m)) * m


def aug_groups(aug_names: Sequence[str], canvas_hw: tuple, shrink_slice: bool) -> dict:
    """{slice (h, w) or None for the full canvas: positions of the augs
    detected on it}, in first-seen order."""
    h, w = canvas_hw
    groups: dict = {}
    for i, name in enumerate(aug_names):
        r = _shrink_ratio(name) if shrink_slice else None
        key = None
        if r is not None:
            ch, cw = _ceil_mult(h * r), _ceil_mult(w * r)
            if ch < h or cw < w:
                key = (ch, cw)
        groups.setdefault(key, []).append(i)
    return groups


def make_cald_score_fn(model, cfg: CALDConfig, num_classes: int, *,
                       lowp_aug: Callable | None = None,
                       lowp: Callable | None = None) -> Callable:
    """Returns ``score_batch(images, valid_hw, draw) -> (consistency (B,),
    cls_corrs (B, num_classes - 1))``. ``draw(i, shape)`` supplies the
    uniforms of augmentation i (``generator_draw`` for a ``torch.Generator``).
    """
    aug_names = tuple(cfg.aug_names)

    def _detect_augs(aug_images, aug_hw):
        """(B, A, H, W, 3) -> Detections (B, A, K, ...): one detect per
        canvas slice."""
        b, a, h, w = aug_images.shape[:4]
        parts = {}
        for key, idxs in aug_groups(aug_names, (h, w), cfg.shrink_slice).items():
            ims = aug_images if len(idxs) == a else aug_images[:, idxs]
            if key is not None:
                ims = ims[:, :, : key[0], : key[1]]
            d = model.detect(ims.reshape((b * len(idxs),) + ims.shape[2:]),
                             aug_hw[:, idxs].reshape(-1, 2))
            d = d.map(lambda t, n=len(idxs): t.reshape((b, n) + t.shape[1:]))
            if len(idxs) == a:
                return d
            for j, i in enumerate(idxs):
                parts[i] = d.map(lambda t, j=j: t[:, j])
        return Detections(**{f.name: torch.stack([getattr(parts[i], f.name) for i in range(a)],
                                                 dim=1)
                             for f in dataclasses.fields(Detections)})

    @torch.inference_mode()
    def score_batch(images: torch.Tensor, valid_hw: torch.Tensor, draw: Draw):
        b = images.shape[0]
        base = model.detect(images, valid_hw)
        ref_boxes, ref_scores, ref_labels, ref_scores_cls, ref_prob_max, ref_valid = \
            subsample_reference(base.boxes, base.scores, base.labels, base.scores_cls,
                                base.prob_max, base.valid, k_ref=cfg.k_ref,
                                threshold=cfg.subsample_threshold)
        base_corr = class_correlation(ref_scores, ref_labels, ref_valid, num_classes - 1)

        # augs run in the model's compute dtype (the detector casts to it anyway)
        aug_in = images if model.dtype is None else images.to(model.dtype)
        if lowp_aug is not None:
            aug_in = lowp_aug(aug_in)
        aug_images, aug_boxes, aug_hw = build_aug_batch(
            aug_in, ref_boxes, ref_valid, valid_hw, aug_names, draw)
        if lowp_aug is not None:
            aug_images = lowp_aug(aug_images)
        dets = _detect_augs(aug_images, aug_hw)
        if lowp is not None:
            aug_boxes, ref_scores_cls, ref_prob_max = (
                lowp(aug_boxes), lowp(ref_scores_cls), lowp(ref_prob_max))

        consistency = cald_consistency(
            aug_boxes, ref_scores_cls, ref_prob_max, ref_valid, dets.boxes,
            dets.scores_cls, dets.prob_max, dets.valid, cfg.base_point)
        aug_corr = class_correlation(dets.scores, dets.labels, dets.valid,
                                     num_classes - 1)               # (B, A, C-1)
        mean_corr = torch.cat([base_corr[:, None], aug_corr], dim=1).mean(dim=1)
        # an image with no base detections keeps only its (all-zero) base corr
        cls_corrs = torch.where(ref_valid.any(dim=-1)[:, None], mean_corr, base_corr)
        return consistency, cls_corrs

    return score_batch


def _softmax(x: np.ndarray, axis=-1) -> np.ndarray:
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def _js(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    m = (p + q) / 2.0

    def kl(a, b):
        return np.sum(np.where(a > 0, a * (np.log(np.maximum(a, 1e-30))
                                           - np.log(np.maximum(b, 1e-30))), 0.0),
                      axis=-1)
    return 0.5 * kl(p, m) + 0.5 * kl(q, m)


def cls_kldiv_rank(cand_corrs: np.ndarray, labeled_mean: np.ndarray, budget: int,
                   *, uniform: bool = False) -> np.ndarray:
    """Stage-2 ranking: positions into cand_corrs, zero-detection candidates
    first, then by class-balance JS divergence."""
    zero_det = np.where(cand_corrs.sum(axis=1) == 0)[0]
    chosen = list(zero_det)
    if len(chosen) < budget:
        if uniform:
            p = _softmax(labeled_mean[None] + cand_corrs)
            q = _softmax(np.ones_like(labeled_mean))[None]
            js = _js(p, q)
            js[np.asarray(chosen, int)] = np.inf
            order = np.argsort(js, kind="stable")          # closest to uniform
        else:
            p = _softmax(labeled_mean)[None]
            q = _softmax(cand_corrs)
            js = _js(p, q)
            js[np.asarray(chosen, int)] = -np.inf
            order = np.argsort(-js, kind="stable")         # most divergent
        for i in order:
            if len(chosen) >= budget:
                break
            chosen.append(int(i))
    return np.asarray(chosen, int)


def cald_select(consistency: np.ndarray, cls_corrs: np.ndarray,
                labeled_mean: np.ndarray, budget: int, cfg: CALDConfig) -> np.ndarray:
    """Full two-stage selection; returns positions into the pool array."""
    arg = np.argsort(consistency, kind="stable")
    if cfg.no_mutual:
        return arg[:budget]
    n_cand = min(int(cfg.mutual_range * budget), len(arg))
    cand = arg[:n_cand]
    picked = cls_kldiv_rank(cls_corrs[cand], labeled_mean, budget, uniform=cfg.uniform)
    return cand[picked]
