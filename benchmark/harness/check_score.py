"""The comparison that decides ``correct`` in a CALD scoring cell.

The plain reference (``plainref``, float32, TF32 off) follows the timed path
stage by stage from the program's own outputs, on every image of a sampled
batch that the seed picks:

- ``canvas_gap``: the canvas the loader handed the score call against the
  reference's own (Pillow decode, the plain resize): the mean absolute gap
  of the luma (0..255), worst image. Luma, because nvJPEG and libjpeg
  upsample the chroma of 4:2:0 files differently (up to ~100 at chroma
  edges, PERF.md) while the luma of RGB does not depend on it.
- ``pyramid_rel``: the reference's FPN pyramid of each detect call's own
  input canvas against the program's, ||diff|| / ||ref||, worst level.
- ``head_rel``: the heads on the program's pyramid: RPN objectness and
  deltas, then proposals from the program's RPN outputs, RoIAlign on its
  pyramid and the box head (Faster R-CNN; K1 is in this stage), or
  RetinaNet's subnets, against the program's outputs, ||diff|| / ||ref||.
- ``det_mismatch``: the postprocess (score filter, NMS, top-k) on the
  program's head outputs against the program's detections: the share of
  slots valid on either side whose validity, label, score (1e-3) or box
  (0.5 px) differ.
- ``aug_gap``: the FCDR augmented images built from the program's canvas,
  its base detections and the same uniforms, against the images the
  program detected on: the mean absolute gap inside the valid regions.
- ``score_gap``: consistency and class correlations worked out from the
  program's base and augmented detections, against the answers the score
  call returned: the largest absolute gap.

Below the pyramid the reference's code is a copy of the port's plain code,
so today ``det_mismatch`` and ``score_gap`` read 0: they guard against a
later change of the port's postprocess, augmentations or consistency.
Each compared number prints beside its limit; the limits were set from the
readings that ``PERF.md`` gives.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from plainref.augment.suite import build_aug_batch, expand_aug_string, generator_draw
from plainref.canvas import batch_canvas
from plainref.cald import subsample_reference
from plainref.models.detections import Detections
from plainref.models.faster_rcnn import FasterRCNN, FasterRCNNConfig
from plainref.models.retinanet import RetinaNet, RetinaNetConfig, retinanet_postprocess
from plainref.models.roi_heads import postprocess_detections
from plainref.models.rpn import select_proposals
from plainref.ops.consistency import cald_consistency, class_correlation
from plainref.ops.roi_align import multi_scale_roi_align

# the detectors a configuration's ``model`` names
MODELS = {"faster": (FasterRCNN, FasterRCNNConfig), "retina": (RetinaNet, RetinaNetConfig)}
NUMBERS = ("canvas_gap", "pyramid_rel", "head_rel", "det_mismatch", "aug_gap", "score_gap")
# ITU-R 601 luma weights
LUMA = (0.299, 0.587, 0.114)


def _model(config: dict):
    """(detector, its configuration class) of a configuration's ``model``."""
    if config["model"] not in MODELS:
        raise ValueError(f"unknown model {config['model']!r}: one of {', '.join(MODELS)}")
    return MODELS[config["model"]]


def model_config(config: dict, compute_dtype: str):
    """The detector configuration of a configuration file, in a dtype."""
    fields = _model(config)[1]
    kw = {k: (tuple(tuple(x) if isinstance(x, list) else x for x in v)
              if isinstance(v, list) else v)
          for k, v in config["detector"].items()}
    return fields(compute_dtype=compute_dtype, **kw)


def reference_model(config: dict, device, state_dict=None):
    """The plain float32 detector of a configuration, on ``device``."""
    cfg = model_config(config, "float32")
    model = _model(config)[0](cfg)
    model.to(device).eval()
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


def _luma(x: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(LUMA, dtype=torch.float32, device=x.device)
    return (x.float() * w).sum(-1)


def det_mismatch(got: Detections, want: Detections) -> tuple[int, int]:
    """(mismatched slots, slots valid on either side)."""
    either = got.valid | want.valid
    same = (got.valid == want.valid) & (got.labels == want.labels)
    same &= (got.scores - want.scores).abs() <= 1e-3
    same &= ((got.boxes - want.boxes).abs().amax(-1) <= 0.5)
    bad = either & ~(same & got.valid & want.valid)
    return int(bad.sum()), int(either.sum())


@torch.no_grad()
def _call_numbers(ref, call: dict, chunk: int = 4) -> dict:
    """pyramid_rel, head_rel and the postprocess's mismatch of one detect
    call, in chunks of images."""
    cfg = ref.cfg
    out = {"pyramid_rel": 0.0, "head_rel": 0.0, "bad": 0, "slots": 0}
    n = call["images"].shape[0]
    for lo in range(0, n, chunk):
        sl = slice(lo, lo + chunk)
        images, hw = call["images"][sl].float(), call["valid_hw"][sl]
        want = ref.features(images, hw)
        got = [f[sl].float() for f in call["pyramid"]]
        out["pyramid_rel"] = max(out["pyramid_rel"], *(_rel(g, w) for g, w in zip(got, want)))
        del want
        anchors, counts = ref._anchors(got, images.device)
        dets = Detections(**{k: getattr(call["dets"], k)[sl]
                             for k in Detections.__dataclass_fields__})
        if isinstance(ref, FasterRCNN):
            obj, deltas = (t[sl] for t in call["rpn"])
            r_obj, r_deltas = ref.rpn_head(got)
            head = [_rel(obj, r_obj), _rel(deltas, r_deltas)]
            props, _, pvalid = select_proposals(
                obj.float(), deltas.float(), anchors, counts, hw,
                pre_nms_top_n=cfg.rpn_pre_nms_top_n_test,
                post_nms_top_n=cfg.rpn_post_nms_top_n_test, nms_thresh=cfg.rpn_nms_thresh)
            levels, scales = ref._roi_levels(got)
            pooled = multi_scale_roi_align(levels, props, valid=pvalid, spatial_scales=scales)
            b, k = props.shape[:2]
            rep = ref.box_head(pooled.reshape(b * k, -1))
            r_logits, r_reg = ref.box_predictor(rep)
            logits, reg = (t[sl].float() for t in call["box"])
            head += [_rel(logits, r_logits.reshape(b, k, -1)), _rel(reg, r_reg.reshape(b, k, -1))]
            want_dets = postprocess_detections(
                logits, reg, props, pvalid, hw, score_thresh=cfg.box_score_thresh,
                nms_thresh=cfg.box_nms_thresh, detections_per_img=cfg.detections_per_img)
        else:
            logits, reg = (t[sl].float() for t in call["head"])
            r_logits, r_reg = ref.head(got)
            head = [_rel(logits, r_logits), _rel(reg, r_reg)]
            want_dets = retinanet_postprocess(
                logits, reg, anchors, counts, hw, score_thresh=cfg.score_thresh,
                nms_thresh=cfg.nms_thresh, detections_per_img=cfg.detections_per_img,
                topk_candidates=cfg.topk_candidates)
        out["head_rel"] = max(out["head_rel"], *head)
        bad, slots = det_mismatch(dets, want_dets)
        out["bad"] += bad
        out["slots"] += slots
    return out


@torch.no_grad()
def compare(sample, ref, config: dict, traffic: dict) -> dict:
    """The six numbers of one sampled batch (``capture.SampledBatch``)."""
    dev = sample.images.device
    batch = len(sample.paths)
    nums = {}
    canvas, hw = batch_canvas(sample.paths, list(range(batch)), config["min_size"],
                              config["max_size"], dev)
    if canvas.shape != sample.images.shape or not torch.equal(hw, sample.valid_hw.to(hw.dtype)):
        nums["canvas_gap"] = math.inf
    else:
        gaps = []
        for j, (h, w) in enumerate(hw.tolist()):
            gaps.append(float((_luma(sample.images[j, :h, :w]) - _luma(canvas[j, :h, :w]))
                              .abs().mean()))
        nums["canvas_gap"] = max(gaps)
    del canvas

    calls = [_call_numbers(ref, c) for c in sample.calls]
    nums["pyramid_rel"] = max(c["pyramid_rel"] for c in calls)
    nums["head_rel"] = max(c["head_rel"] for c in calls)
    nums["det_mismatch"] = sum(c["bad"] for c in calls) / max(sum(c["slots"] for c in calls), 1)

    # the augmented batch and the answers, from the program's base detections
    base, aug = sample.calls
    d = base["dets"]
    ref_boxes, ref_scores, ref_labels, ref_scores_cls, ref_prob_max, ref_valid = \
        subsample_reference(d.boxes, d.scores, d.labels, d.scores_cls, d.prob_max, d.valid,
                            k_ref=traffic["k_ref"], threshold=traffic["subsample_threshold"])
    names = expand_aug_string(traffic["augs"])
    gen = torch.Generator(device=dev)
    gen.set_state(sample.draw_state)
    aug_images, aug_boxes, aug_hw = build_aug_batch(
        sample.images, ref_boxes, ref_valid, sample.valid_hw, names, generator_draw(gen))
    s, a = aug_images.shape[:2]
    got_images = aug["images"].reshape(aug_images.shape).float()
    if not torch.equal(aug_hw.reshape(-1, 2), aug["valid_hw"].to(aug_hw.dtype)):
        nums["aug_gap"] = math.inf
    else:
        h_idx = torch.arange(aug_images.shape[2], device=dev)
        w_idx = torch.arange(aug_images.shape[3], device=dev)
        mask = ((h_idx[None, None, :, None] < aug_hw[..., 0, None, None])
                & (w_idx[None, None, None, :] < aug_hw[..., 1, None, None]))
        gap = (got_images - aug_images).abs().sum(-1) / 3
        nums["aug_gap"] = float(gap[mask].mean())
    dets = aug["dets"].map(lambda t: t.reshape(s, a, *t.shape[1:]))
    consistency = cald_consistency(aug_boxes, ref_scores_cls, ref_prob_max, ref_valid,
                                   dets.boxes, dets.scores_cls, dets.prob_max, dets.valid,
                                   traffic["base_point"])
    fg = ref.cfg.num_classes - 1
    base_corr = class_correlation(ref_scores, ref_labels, ref_valid, fg)
    aug_corr = class_correlation(dets.scores, dets.labels, dets.valid, fg)
    mean_corr = torch.cat([base_corr[:, None], aug_corr], dim=1).mean(dim=1)
    cls_corrs = torch.where(ref_valid.any(dim=-1)[:, None], mean_corr, base_corr)
    nums["score_gap"] = max(float((sample.consistency.float() - consistency).abs().max()),
                            float((sample.cls_corrs.float() - cls_corrs).abs().max()))
    return nums


def judge(samples: list[dict], limits: dict) -> tuple[bool, dict]:
    """Every sample's numbers against the limits: (correct, the worst
    reading of each number)."""
    worst = {k: max(s[k] for s in samples) for k in samples[0]}
    ok = all(np.isfinite(v) and v <= limits[k] for k, v in worst.items())
    return ok, worst
