"""The port's bf16 detector and augmentations against the JAX package's own
bf16, stage by stage.

Both packages load the same seeded weights (the tiny Faster R-CNN with the
selection gate's 21 classes and 32 FPN channels, frozen norms and group
norms) and see the same seeded scenes at 96x128 on a 128x128 canvas. Every
stage is compared three ways on the mean absolute difference: the port's
bf16 against JAX's bf16 (jitted, as the JAX score function runs), JAX's
bf16 against its float32, and the port's float32 against JAX's float32.
The rule, ``test_gate_in_bf16``'s: the port's bf16 lies no further from
JAX's bf16 than twice JAX's own bf16 rounding (its distance from its
float32). The float32 comparison is the sanity check: it lies far inside
JAX's bf16 rounding.

That rule cannot tell one rounding point more or fewer from none: under
group norms XLA, jitted, keeps a convolution's output unrounded into
GroupNorm's float32 statistics, so jitted JAX differs from JAX run op by op
(Flax's modules round their outputs) about as much as its bf16 differs
from its float32. So every stage is also held, stage by stage, to JAX's
bf16 run op by op: the port's module of that stage in bf16, given JAX's op
by op input of the stage, against JAX's op by op output, within a tenth of
JAX's bf16 rounding there. A stage that rounded where Flax's module does
not, or did not round where it does, lands at 0.08-1.0 of that rounding.
Held end to end instead, the op by op comparison grows along the group-norm
trunk (0.06 at c2 to 0.5 at c5) from GroupNorm's float32 statistics, whose
reduction order differs between the packages. The pooled features are
held within a fifth: JAX's plain RoIAlign runs jitted even op by op, and
keeps excess precision inside, while the port's sums in float32 and rounds
its output once.

Stages: the normalized, cast input; the backbone's c2..c5; the FPN's
p2..p6; the RPN's objectness and deltas; the pooled RoI features, both
packages given the same proposals (JAX float32's) so that NMS cannot blur
the comparison; the box head's class logits and box regression; the
postprocess's ``scores_cls`` and ``prob_max`` on the detections both keep
(matched by proposal and label); and each FCDR augmentation of the cast
batch with JAX's draws injected."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from cald_tpu.augment.suite import build_aug_batch as jax_build_aug_batch
from cald_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from cald_tpu.models.faster_rcnn import FasterRCNNConfig as JaxConfig
from cald_tpu.models.roi_heads import pool_box_features as jax_pool_box_features
from cald_tpu.models.roi_heads import postprocess_detections as jax_postprocess
from cald_tpu.strategies.cald import CALDConfig as JaxCALDConfig
from cald_tpu_torch.augment.suite import build_aug_batch
from cald_tpu_torch.experiments import scoring_deviation as sd
from cald_tpu_torch.models.faster_rcnn import FasterRCNN, FasterRCNNConfig, normalized_input
from cald_tpu_torch.models.roi_heads import postprocess_detections
from tests.test_torch_cald import jax_draw
from tests.torch_helpers import TINY, tiny_models, to_np

HW = (96, 128)
BATCH = 4
SCENE_SEED = 5
AUG_KEY = 7000
CFG = {**TINY, "num_classes": sd.NUM_CLASSES, "fpn_channels": 32}
NORMS = ("frozen", "group")
LEVELS = ("c2", "c3", "c4", "c5")
PYRAMID = ("p2", "p3", "p4", "p5", "p6")
DETECT_STAGES = ("input", *LEVELS, *PYRAMID, "objectness", "deltas", "pooled",
                 "class_logits", "box_regression", "scores_cls", "prob_max")
AUGS = JaxCALDConfig().aug_names
# the limits, as fractions of JAX's bf16 from its f32: the port's bf16 from
# JAX's jitted bf16; a port stage's bf16 from JAX's bf16 run op by op, on
# the same input (the pooled features: OP_BY_OP_POOLED); the port's f32
# from JAX's f32
BF16_RATIO = 2.0
OP_BY_OP_RATIO = 0.1
OP_BY_OP_POOLED = 0.2
F32_RATIO = 0.1
MIN_MATCHED = 0.5        # detections both sides keep, of the fewer valid


def scenes():
    images, valid_hw, boxes, _, valid = sd.batch_scenes(
        np.random.default_rng(SCENE_SEED), BATCH, HW)
    return images, valid_hw, boxes, valid


def jax_stages(m, images, valid_hw, props, pvalid):
    """Every stage of the JAX detector's inference path on the given
    proposals (its ``detect`` with the plain RoIAlign, as on the CPU)."""
    seen = {}

    def capture(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and context.module.name in ("backbone", "fpn"):
            seen[context.module.name] = (args[0], out)
        return out

    with nn.intercept_methods(capture):
        pyramid = m._features(images, valid_hw)
    objectness, deltas = m.rpn_head(pyramid)
    cfg = m.cfg
    scales = [1.0 / s for s in cfg.strides[: cfg.roi_levels]]
    pooled = jax.vmap(lambda *fr: jax_pool_box_features(fr[:-1], fr[-1], scales, inference=True))(
        *pyramid[: cfg.roi_levels], props)
    b, n = props.shape[:2]
    logits, reg = m.box_predictor(m.box_head(pooled.reshape(b * n, -1)))
    dets = jax.vmap(lambda cl, br, p, pv, hw: jax_postprocess(
        cl, br, p, pv, hw, score_thresh=cfg.box_score_thresh, nms_thresh=cfg.box_nms_thresh,
        detections_per_img=cfg.detections_per_img))(
        logits.reshape(b, n, -1), reg.reshape(b, n, -1), props, pvalid, valid_hw)
    x, feats = seen["backbone"]
    return {"input": x, **{k: feats[k] for k in LEVELS},
            **dict(zip(PYRAMID, pyramid)), "objectness": objectness, "deltas": deltas,
            "pooled": pooled, "class_logits": logits, "box_regression": reg,
            "dets": (dets.props, dets.labels, dets.valid, dets.scores_cls, dets.prob_max)}


@torch.inference_mode()
def port_stages(model, images, valid_hw, props, pvalid):
    """The same stages of the port's ``detect``, NHWC like JAX's."""
    nhwc = lambda t: t.permute(0, 2, 3, 1)                             # noqa: E731
    x = normalized_input(images, valid_hw, model.pixel_mean, model.pixel_std, model.dtype)
    feats = model.backbone(x)
    pyramid = model.fpn([feats[k] for k in model.feat_keys])
    objectness, deltas = model.rpn_head(pyramid)
    levels, scales = model._roi_levels(pyramid)
    pooled = model.roi_align(levels, props, pvalid, spatial_scales=scales)
    b, n = props.shape[:2]
    logits, reg = model.box_predictor(model.box_head(pooled.reshape(b * n, -1)))
    cfg = model.cfg
    dets = postprocess_detections(
        logits.reshape(b, n, -1), reg.reshape(b, n, -1), props, pvalid, valid_hw,
        score_thresh=cfg.box_score_thresh, nms_thresh=cfg.box_nms_thresh,
        detections_per_img=cfg.detections_per_img)
    return {"input": nhwc(x), **{k: nhwc(feats[k]) for k in LEVELS},
            **{k: nhwc(p) for k, p in zip(PYRAMID, pyramid)}, "objectness": objectness,
            "deltas": deltas, "pooled": pooled, "class_logits": logits, "box_regression": reg,
            "dets": (dets.props, dets.labels, dets.valid, dets.scores_cls, dets.prob_max)}


@torch.inference_mode()
def port_local_stages(model, ref: dict, images, valid_hw, props, pvalid):
    """Each stage of the port's ``detect`` on the input that stage had in
    ``ref`` (NumPy outputs of ``jax_stages``): the stem and the first stage
    on the cast input for c2, each later backbone stage on the level before,
    the FPN on c2..c5, the RPN head and the RoIAlign on the pyramid, the box
    head and predictor on the pooled features, the postprocess on the class
    logits and box regression."""
    dt = model.dtype
    nchw = lambda k: torch.from_numpy(ref[k]).to(dt).permute(0, 3, 1, 2)    # noqa: E731
    nhwc = lambda t: t.permute(0, 2, 3, 1)                                 # noqa: E731
    t = torch.from_numpy
    bb = model.backbone
    x = normalized_input(t(images), t(valid_hw), model.pixel_mean, model.pixel_std, dt)
    out = {"input": nhwc(x)}
    y = F.max_pool2d(F.relu(bb.bn1(bb.conv1(nchw("input")))), 3, stride=2, padding=1)
    for level, names in zip(LEVELS, bb.stages):
        if level != "c2":
            y = nchw(f"c{int(level[1]) - 1}")
        for name in names:
            y = getattr(bb, name)(y)
        out[level] = nhwc(y)
    out.update((k, nhwc(p)) for k, p in zip(PYRAMID, model.fpn([nchw(k) for k in LEVELS])))
    pyramid = [nchw(k) for k in PYRAMID]
    out["objectness"], out["deltas"] = model.rpn_head(pyramid)
    levels, scales = model._roi_levels(pyramid)
    out["pooled"] = model.roi_align(levels, t(props), t(pvalid), spatial_scales=scales)
    b, n = props.shape[:2]
    pooled = torch.from_numpy(ref["pooled"]).to(dt).reshape(b * n, -1)
    out["class_logits"], out["box_regression"] = model.box_predictor(model.box_head(pooled))
    cfg = model.cfg
    dets = postprocess_detections(
        t(ref["class_logits"]).reshape(b, n, -1), t(ref["box_regression"]).reshape(b, n, -1),
        t(props), t(pvalid), t(valid_hw), score_thresh=cfg.box_score_thresh,
        nms_thresh=cfg.box_nms_thresh, detections_per_img=cfg.detections_per_img)
    out["dets"] = (dets.props, dets.labels, dets.valid, dets.scores_cls, dets.prob_max)
    return out


def as_np(out: dict) -> dict:
    conv = lambda t: (to_np(t.float()) if isinstance(t, torch.Tensor)           # noqa: E731
                      else np.asarray(jnp.asarray(t).astype(jnp.float32)
                                      if jnp.issubdtype(t.dtype, jnp.floating) else t))
    return {k: tuple(conv(t) for t in v) if k == "dets" else conv(v) for k, v in out.items()}


def matched(dets, props):
    """{(image, proposal, label): (scores_cls row, prob_max)} of the valid
    detections; the proposal found by its box among the shared proposals."""
    det_props, labels, valid, scores_cls, prob_max = dets
    out = {}
    for i, j in zip(*np.nonzero(valid)):
        p = np.nonzero((props[i] == det_props[i, j]).all(axis=-1))[0][0]
        out[(i, int(p), int(labels[i, j]))] = (scores_cls[i, j], prob_max[i, j])
    return out


def det_gap(a: dict, b: dict, field: int) -> tuple[float, float]:
    """(mean |difference| of ``field`` over the detections both keep, their
    share of the fewer valid detections)."""
    both = sorted(set(a) & set(b))
    if not both:
        return float("inf"), 0.0
    gap = np.mean([np.abs(np.asarray(a[k][field], np.float64) - b[k][field]).mean()
                   for k in both])
    return float(gap), len(both) / min(len(a), len(b))


def stage_outputs(norm: str, unjitted: bool = False) -> dict:
    """Every stage's outputs as NumPy: JAX bf16 ("jb") and f32 ("jf"), the
    port's bf16 ("tb") and f32 ("tf"), with ``unjitted`` also JAX's bf16
    run op by op ("ju") and the port's bf16 and float32 stages on its
    inputs (``port_local_stages``, "tl" and "tl32"), and the shared
    proposals ("props")."""
    images, valid_hw, _, _ = scenes()
    jf32, variables, tf32 = tiny_models(norm=norm, **{k: v for k, v in CFG.items()
                                                     if k in ("num_classes", "fpn_channels")})
    jbf16 = JaxFasterRCNN(JaxConfig(norm=norm, **{**CFG, "compute_dtype": "bfloat16"}))
    tbf16 = FasterRCNN(FasterRCNNConfig(norm=norm, **{**CFG, "compute_dtype": "bfloat16"}))
    tbf16.load_state_dict(tf32.state_dict())
    tbf16.eval()
    ji, jh = jnp.asarray(images), jnp.asarray(valid_hw)
    _, _, _, props, _, pvalid = jax.jit(lambda v, i, h: jf32.apply(
        v, i, h, method=lambda m, i, h: m._proposals(m._features(i, h), h, train=False)))(
        variables, ji, jh)
    props, pvalid = np.asarray(props), np.asarray(pvalid)
    assert pvalid.sum(axis=1).min() > 8, "degenerate fixture: few proposals"

    def run_jax(model, jit=True):
        fn = lambda v, i, h, p, pv: model.apply(v, i, h, p, pv, method=jax_stages)  # noqa: E731
        return as_np((jax.jit(fn) if jit else fn)(variables, ji, jh, jnp.asarray(props),
                                                  jnp.asarray(pvalid)))

    def run_port(model):
        t = torch.from_numpy
        return as_np(port_stages(model, t(images), t(valid_hw), t(props), t(pvalid)))

    out = {"jb": run_jax(jbf16), "jf": run_jax(jf32), "tb": run_port(tbf16),
           "tf": run_port(tf32), "props": props}
    if unjitted:
        out["ju"] = run_jax(jbf16, jit=False)
        out["tl"] = as_np(port_local_stages(tbf16, out["ju"], images, valid_hw, props, pvalid))
        out["tl32"] = as_np(port_local_stages(tf32, out["ju"], images, valid_hw, props, pvalid))
    return out


def stage_gap(a: dict, b: dict, stage: str) -> float:
    return float(np.abs(a[stage].astype(np.float64) - b[stage]).mean())


def compute_detect_gaps() -> dict:
    """{norm: {stage: {"port_jax": port-bf16 vs JAX-bf16, "jax_rounding":
    JAX-bf16 vs JAX-f32, "f32": port-f32 vs JAX-f32, "op_by_op": the port's
    bf16 stage vs JAX-bf16 run op by op on the same input,
    "unrounded_op_by_op": the same with the port's stage in float32,
    "end_to_end_op_by_op": port-bf16 vs JAX-bf16 run op by op,
    "jitted_op_by_op": JAX-bf16 jitted vs op by op[, "shares": matched
    shares]}}}."""
    names = ("port_jax", "jax_rounding", "f32", "op_by_op", "unrounded_op_by_op",
             "end_to_end_op_by_op", "jitted_op_by_op")
    pairs = (("tb", "jb"), ("jb", "jf"), ("tf", "jf"), ("tl", "ju"), ("tl32", "ju"), ("tb", "ju"),
             ("jb", "ju"))
    out = {}
    for norm in NORMS:
        o = stage_outputs(norm, unjitted=True)
        gaps = {stage: {name: stage_gap(o[x], o[y], stage) for name, (x, y) in zip(names, pairs)}
                for stage in DETECT_STAGES[:-2]}
        m = {k: matched(o[k]["dets"], o["props"])
             for k in ("tb", "jb", "tf", "jf", "ju", "tl", "tl32")}
        for field, stage in enumerate(("scores_cls", "prob_max")):
            both = [det_gap(m[x], m[y], field) for x, y in pairs]
            gaps[stage] = {**{name: g for name, (g, _) in zip(names, both)},
                           "shares": [share for _, share in both]}
        out[norm] = gaps
    return out


@pytest.fixture(scope="module")
def detect_gaps():
    return compute_detect_gaps()


@pytest.mark.parametrize("stage", DETECT_STAGES)
@pytest.mark.parametrize("norm", NORMS)
def test_detect_stage_in_bf16(detect_gaps, norm, stage):
    g = detect_gaps[norm][stage]
    assert g["jax_rounding"] > 0, "JAX's bf16 does not round this stage"
    assert g["f32"] <= F32_RATIO * g["jax_rounding"], g
    assert g["port_jax"] <= BF16_RATIO * g["jax_rounding"], g
    if "shares" in g:
        assert min(g["shares"]) >= MIN_MATCHED, g


@pytest.mark.parametrize("stage", DETECT_STAGES)
@pytest.mark.parametrize("norm", NORMS)
def test_detect_stage_rounds_as_jax_op_by_op(detect_gaps, norm, stage):
    """Each stage of the port's bf16 on JAX's op by op input of that stage
    against JAX's op by op output: a rounding point more or fewer than
    Flax's module has lands at 0.08-1.0 of JAX's bf16 rounding."""
    g = detect_gaps[norm][stage]
    limit = OP_BY_OP_POOLED if stage == "pooled" else OP_BY_OP_RATIO
    assert g["op_by_op"] <= limit * g["jax_rounding"], g
    if "shares" in g:
        assert min(g["shares"]) >= MIN_MATCHED, g


@pytest.mark.parametrize("stage", [s for s in DETECT_STAGES[1:-2] if s != "pooled"])
@pytest.mark.parametrize("norm", NORMS)
def test_op_by_op_limit_fails_a_stage_that_does_not_round(detect_gaps, norm, stage):
    """The same stage run in float32 (its output never rounded to bf16)
    lies beyond the limit: the limit tells a missing rounding point from
    the packages' differences in reduction order. (The postprocess runs in
    float32 in both packages; the pooled features are held more loosely.)"""
    g = detect_gaps[norm][stage]
    assert g["unrounded_op_by_op"] > OP_BY_OP_RATIO * g["jax_rounding"], g


def compute_aug_gaps() -> dict:
    """{aug: (port-bf16 vs JAX-bf16, JAX-bf16 vs JAX-f32, port-f32 vs
    JAX-f32)} of the FCDR augmentations of the scenes, their gt boxes as the
    reference detections, JAX's draws injected into the port."""
    images, valid_hw, boxes, valid = scenes()
    key = jax.random.key(AUG_KEY)
    jfn = jax.jit(lambda im, bx, v, hw: jax_build_aug_batch(im, bx, v, hw, key, AUGS)[0])
    j = {dt: np.asarray(jfn(jnp.asarray(images).astype(dt), jnp.asarray(boxes), jnp.asarray(valid),
                            jnp.asarray(valid_hw)).astype(jnp.float32))
         for dt in (jnp.bfloat16, jnp.float32)}
    t = {dt: to_np(build_aug_batch(torch.from_numpy(images).to(dt), torch.from_numpy(boxes),
                                   torch.from_numpy(valid), torch.from_numpy(valid_hw), AUGS,
                                   jax_draw(key))[0].float())
         for dt in (torch.bfloat16, torch.float32)}
    gap = lambda a, b, i: float(np.abs(a[:, i].astype(np.float64) - b[:, i]).mean())  # noqa: E731
    return {name: (gap(t[torch.bfloat16], j[jnp.bfloat16], i),
                   gap(j[jnp.bfloat16], j[jnp.float32], i),
                   gap(t[torch.float32], j[jnp.float32], i))
            for i, name in enumerate(AUGS)}


@pytest.fixture(scope="module")
def aug_gaps():
    return compute_aug_gaps()


@pytest.mark.parametrize("aug", AUGS)
def test_augmentation_in_bf16(aug_gaps, aug):
    port_vs_jax, jax_rounding, f32 = aug_gaps[aug]
    assert jax_rounding > 0, "JAX's bf16 does not round this augmentation"
    assert f32 <= F32_RATIO * jax_rounding, (f32, jax_rounding)
    assert port_vs_jax <= BF16_RATIO * jax_rounding, (port_vs_jax, jax_rounding)


if __name__ == "__main__":
    # prints every stage's gaps: python tests/test_torch_bf16_parity.py
    for norm, gaps in compute_detect_gaps().items():
        for stage, g in gaps.items():
            print(f"{norm:6s} {stage:14s} " + "  ".join(
                f"{k} {[round(x, 3) for x in v] if k == 'shares' else f'{v:.3e}'}"
                for k, v in g.items())
                  + "  ratios " + " ".join(f"{k} {g[k] / g['jax_rounding']:.3f}" for k in (
                      "port_jax", "op_by_op", "unrounded_op_by_op", "end_to_end_op_by_op",
                      "jitted_op_by_op")))
    for aug, (a, b, c) in compute_aug_gaps().items():
        print(f"aug    {aug:14s} port-bf16 vs JAX-bf16 {a:.3e}  JAX bf16 vs f32 {b:.3e}  "
              f"ratio {a / b:.3f}  port-f32 vs JAX-f32 {c:.3e}")
