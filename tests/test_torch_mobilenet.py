"""MobileNetV3-Large in the port (``cald_tpu_torch.models.mobilenetv3``, the
``faster_mobilenet`` and ``retina_mobilenet`` detectors and the torchvision
importer) against the JAX package on the CPU, with the same weights moved
through the bridge, on the 96x128 canvas (3x4 stride-32 maps): the backbone
in float32 and in bfloat16 (whose tolerance pins squeeze-excite's float32
promotion), Faster R-CNN's detect with its two-level RoI assignment,
RetinaNet's detect and loss, and ``load_mobilenetv3_imagenet`` on one
synthetic torchvision state dict read from ``.pth`` and from ``.npz``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cald_tpu.convert.torchvision_import import load_pretrained_backbone
from cald_tpu.models import mobilenetv3 as jmobile
from cald_tpu.ops.roi_align import multi_scale_roi_align as jroi_align
from cald_tpu_torch.convert.from_flax import flax_to_state_dict
from cald_tpu_torch.convert.torchvision_import import (
    backbone_state_dict, load_backbone_, load_state_dict,
)
from cald_tpu_torch.models import mobilenetv3
from cald_tpu_torch.models.anchors import MOBILE_RETINA_SIZES
from cald_tpu_torch.models.init import random_init_
from cald_tpu_torch.models.retinanet import RetinaNet, RetinaNetConfig
from cald_tpu_torch.ops.roi_align import roi_levels
from cald_tpu_torch.ops.roi_align_cuda import roi_align_kernel
from tests.torch_helpers import (
    MOBILE_ANCHORS, TINY_RETINA, retina_models, tiny_images, tiny_models, to_np,
)

MOBILE_RETINA = dict(backbone="mobilenet", anchor_sizes=MOBILE_RETINA_SIZES)


@pytest.fixture(scope="module")
def retina():
    """retina_mobilenet (4 classes, float32) in both packages, and both
    packages' outputs on the tiny images."""
    jmodel, variables, tmodel = retina_models(**MOBILE_RETINA)
    images, valid_hw = tiny_images()
    im, hw = jnp.asarray(images), jnp.asarray(valid_hw)
    pyr_j = jax.jit(lambda v, i, h: jmodel.apply(v, i, h, method="extract_features"))(
        variables, im, hw)
    det_j = jax.jit(lambda v, i, h: jmodel.apply(v, i, h, method="detect"))(variables, im, hw)
    with torch.inference_mode():
        pyr_t = tmodel.features(torch.from_numpy(images), torch.from_numpy(valid_hw))
        det_t = tmodel.detect(torch.from_numpy(images), torch.from_numpy(valid_hw))
    return jmodel, variables, tmodel, (pyr_j, det_j, pyr_t, det_t)


def test_schedule_and_squeeze_widths_match_jax():
    assert [tuple(c) for c in mobilenetv3.LARGE_CFG] == [tuple(c) for c in jmobile.LARGE_CFG]
    assert mobilenetv3.STAGE_CHANNELS == jmobile.STAGE_CHANNELS
    for v in range(1, 1200):
        assert mobilenetv3._make_divisible(v) == jmobile._make_divisible(v)


def test_backbone_float32(retina):
    """c4 and c5 of the backbone within 1e-4 of each map's largest
    magnitude."""
    variables = retina[1]
    bb = {"params": variables["params"]["backbone"], "frozen": variables["frozen"]["backbone"]}
    x = np.random.default_rng(6).normal(0, 1, (2, 96, 128, 3)).astype(np.float32)
    want = jax.jit(jmobile.MobileNetV3Backbone(returned=("c4", "c5")).apply)(bb, jnp.asarray(x))
    tb = mobilenetv3.MobileNetV3Backbone(("c4", "c5"))
    tb.load_state_dict({k[len("backbone."):]: v for k, v in flax_to_state_dict(variables).items()
                        if k.startswith("backbone.")}, strict=True)
    with torch.inference_mode():
        got = tb(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in ("c4", "c5"):
        w, g = np.asarray(want[k]), to_np(got[k].permute(0, 2, 3, 1))
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), rtol=0)


@pytest.mark.parametrize("block", [3, 7, 12], ids=["se-relu", "hswish", "se-hswish-s2"])
def test_block_bfloat16_keeps_squeeze_excite_in_float32(retina, block):
    """One inverted-residual block in bf16 against Flax's op by op (not
    jitted: XLA's CPU fusions skip bf16 roundings between ops, 2.5e-3 mean
    off Flax's own ops over the backbone): mean error < 1e-5 of the mean
    magnitude, max error <= 2^-8 of the largest (one bf16 step). The
    squeeze-excite gate in bf16 instead of Flax's float32 promotion is
    1.6e-3 - 2.4e-3 mean off in blocks 3 and 12, so the limit pins it."""
    variables = retina[1]
    cfg = jmobile.LARGE_CFG[block]
    x = np.random.default_rng(block).normal(0, 1, (2, 24, 32, cfg.in_ch)).astype(np.float32)
    name = f"block{block}"
    bvars = {"params": variables["params"]["backbone"][name],
             "frozen": variables["frozen"]["backbone"][name]}
    want = np.asarray(jmobile.InvertedResidual(cfg, dtype=jnp.bfloat16).apply(
        bvars, jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    tb = mobilenetv3.InvertedResidual(mobilenetv3.LARGE_CFG[block], dtype=torch.bfloat16)
    prefix = f"backbone.{name}."
    tb.load_state_dict({k[len(prefix):]: v for k, v in flax_to_state_dict(variables).items()
                        if k.startswith(prefix)}, strict=True)
    with torch.inference_mode():
        got = tb(torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = to_np(got.float().permute(0, 2, 3, 1))
    assert np.abs(got - want).mean() < 1e-5 * np.abs(want).mean()
    assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max()
    if cfg.se:
        assert tb.se(torch.ones(1, cfg.expand, 2, 2, dtype=torch.bfloat16)).dtype == torch.float32


def test_retina_mobilenet_pyramid_and_detect(retina):
    """One reduced stride-32 level (1e-4 absolute); detections: valid mask
    and labels exact, boxes 1e-3 and scores/rows 1e-4 on valid slots."""
    pyr_j, det_j, pyr_t, det_t = retina[3]
    assert len(pyr_t) == len(pyr_j) == 1 and pyr_t[0].shape[-2:] == (3, 4)
    np.testing.assert_allclose(to_np(pyr_t[0].permute(0, 2, 3, 1)), np.asarray(pyr_j[0]),
                               atol=1e-4, rtol=0)
    valid = np.asarray(det_j.valid)
    assert valid.sum() > 4, "degenerate fixture"
    np.testing.assert_array_equal(to_np(det_t.valid), valid)
    np.testing.assert_array_equal(to_np(det_t.labels), np.asarray(det_j.labels))
    for field, tol in (("boxes", 1e-3), ("scores", 1e-4), ("scores_cls", 1e-4),
                       ("prob_max", 1e-4)):
        np.testing.assert_allclose(to_np(getattr(det_t, field))[valid],
                                   np.asarray(getattr(det_j, field))[valid], atol=tol, rtol=0)


def test_retina_mobilenet_loss(retina):
    """``loss(per_image=True)``, float32, 1e-4 relative; LossNet's input is
    the single level."""
    jmodel, variables, tmodel, _ = retina
    images, valid_hw = tiny_images()
    gb = np.array([[[10, 12, 60, 70], [50, 20, 120, 90]], [[5, 5, 40, 30], [0, 0, 0, 0]]],
                  np.float32)
    gl = np.array([[1, 3], [2, 0]], np.int32)
    gv = np.array([[True, True], [True, False]])
    want, _ = jax.jit(lambda v, *a: jmodel.apply(v, *a, per_image=True, method="loss"))(
        variables, images, valid_hw, gb, gl, gv)
    got, pyramid = tmodel.loss(*(torch.from_numpy(a) for a in (images, valid_hw, gb, gl, gv)),
                               None, per_image=True)
    assert len(pyramid) == 1
    for k in got:
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]), rtol=1e-4, atol=0)


def test_init_distributions():
    """The port's initialisation of retina_mobilenet: kaiming fan-out convs
    (the depthwise ones over k*k*E), lecun fan-in for squeeze-excite's convs
    and ``reduce``, zero biases."""
    model = RetinaNet(RetinaNetConfig(**{**TINY_RETINA, **MOBILE_RETINA}))
    random_init_(model, 0)
    blk = model.backbone.block12                                     # 112 -> 672, k5, SE
    std = {"depthwise": np.sqrt(2.0 / (672 * 25)), "expand": np.sqrt(2.0 / 672),
           "se.fc1": np.sqrt(1.0 / 672), "se.fc2": np.sqrt(1.0 / 168)}
    for name, s in std.items():
        w = blk.get_submodule(name).weight
        assert float(w.detach().std()) == pytest.approx(s, rel=0.08), name
    assert float(model.reduce.weight.detach().std()) == pytest.approx(np.sqrt(1.0 / 960), rel=0.05)
    assert not blk.se.fc1.bias.any() and not model.reduce.bias.any()


@pytest.fixture(scope="module")
def faster():
    jmodel, variables, tmodel = tiny_models(backbone="mobilenetv3", anchor_sizes=MOBILE_ANCHORS)
    images, valid_hw = tiny_images()
    im, hw = jnp.asarray(images), jnp.asarray(valid_hw)
    det_j = jax.jit(lambda v, i, h: jmodel.apply(v, i, h, method="detect"))(variables, im, hw)
    with torch.inference_mode():
        pyr_t = tmodel.features(torch.from_numpy(images), torch.from_numpy(valid_hw))
        det_t = tmodel.detect(torch.from_numpy(images), torch.from_numpy(valid_hw))
    return jmodel, variables, tmodel, det_j, pyr_t, det_t


def test_faster_mobilenet_detect(faster):
    """Faster R-CNN on MobileNetV3-FPN: pyramid strides (32, 32, 64), 15
    anchors per cell; detections slot for slot at tests/test_torch_detect.py's
    tolerances, valid mask and labels exact."""
    _, _, tmodel, det_j, pyr_t, det_t = faster
    assert tmodel.cfg.strides == (32, 32, 64) and tmodel.cfg.roi_levels == 2
    assert [tuple(p.shape[-2:]) for p in pyr_t] == [(3, 4), (3, 4), (2, 2)]
    assert tmodel.rpn_head.objectness.weight.shape[0] == 15
    valid = np.asarray(det_j.valid)
    assert valid.sum() > 5, "degenerate fixture"
    np.testing.assert_array_equal(to_np(det_t.valid), valid)
    np.testing.assert_array_equal(to_np(det_t.labels), np.asarray(det_j.labels))
    for field, tol in (("boxes", 1e-2), ("props", 1e-2), ("scores", 1e-3),
                       ("scores_cls", 1e-3), ("prob_max", 1e-3)):
        np.testing.assert_allclose(to_np(getattr(det_t, field)),
                                   np.asarray(getattr(det_j, field)), atol=tol, rtol=0)


def test_faster_mobilenet_two_level_roi_assignment(faster):
    """Two equal stride-32 levels: the level mapper's range collapses to
    k = 5, so every roi pools from the first level; K1's plain version (the
    wrapper on CPU tensors) equals the JAX package's multi-scale RoIAlign
    there (float32, 1e-5 absolute)."""
    _, _, tmodel, _, pyr_t, det_t = faster
    levels, scales = tmodel._roi_levels(pyr_t)
    assert scales == [1 / 32, 1 / 32]
    r = np.random.default_rng(7)
    xy = r.uniform(0, 100, (2, 40, 2))
    rois = np.concatenate([xy, xy + r.uniform(4, 300, (2, 40, 2))], -1).astype(np.float32)
    rois_t = torch.from_numpy(rois)
    assert not roi_levels(rois_t, scales).any()
    valid = torch.ones(2, 40, dtype=torch.bool)
    with torch.inference_mode():
        got = roi_align_kernel(levels, rois_t, valid, spatial_scales=scales)
    for i in range(2):
        want = jroi_align([np.asarray(to_np(f[i])) for f in levels], jnp.asarray(rois[i]),
                          spatial_scales=scales)
        np.testing.assert_allclose(to_np(got[i]), np.asarray(want), atol=1e-5, rtol=0)


def _torchvision_state_dict(seed: int) -> dict[str, np.ndarray]:
    """A seeded torchvision ``mobilenet_v3_large`` state dict (the trunk, a
    classifier weight and the BN counters that the importers drop)."""
    model = RetinaNet(RetinaNetConfig(**{**TINY_RETINA, **MOBILE_RETINA}))
    r = np.random.default_rng(seed)
    sd = {}
    for key, t in backbone_state_dict(model).items():
        a = r.normal(0, 0.1, t.shape)
        if key.endswith("running_var"):
            a = r.uniform(0.5, 1.5, t.shape)
        sd[key] = a.astype(np.float32)
    sd["features.0.1.num_batches_tracked"] = np.array(7, np.int64)
    sd["classifier.0.weight"] = r.normal(0, 0.1, (1280, 960)).astype(np.float32)
    return sd


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_load_mobilenetv3_imagenet_matches_jax(retina, tmp_path, suffix):
    """The same synthetic state dict through the JAX importer (its
    ``pth_reader`` and ``load_mobilenetv3_imagenet``, chosen from the
    backbone's params) and the port's (``load_state_dict`` +
    ``load_backbone_``, chosen from the model's backbone): every backbone
    tensor equal to 1e-7 relative, the variances with torchvision's eps
    folded in (``var + 1e-3 - 1e-5``); ``backbone_state_dict`` inverts it."""
    _, variables, tmodel, _ = retina
    sd = _torchvision_state_dict(8)
    path = str(tmp_path / f"mobilenet_v3_large{suffix}")
    if suffix == ".npz":
        np.savez(path, **sd)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    want = flax_to_state_dict(load_pretrained_backbone(variables, path))
    model = RetinaNet(tmodel.cfg)
    n = load_backbone_(model, load_state_dict(path))
    assert n == sum(1 for k in model.state_dict() if k.startswith("backbone."))
    got = model.state_dict()
    for k, w in want.items():
        if k.startswith("backbone."):
            np.testing.assert_allclose(to_np(got[k]), to_np(w), rtol=1e-7, atol=0, err_msg=k)
    np.testing.assert_allclose(to_np(got["backbone.block3.depthwise_bn.var"]),
                               sd["features.4.block.1.1.running_var"] + (1e-3 - 1e-5), rtol=1e-7)
    back = backbone_state_dict(model)
    assert set(back) == set(sd) - {"features.0.1.num_batches_tracked", "classifier.0.weight"}
    for k, v in back.items():
        np.testing.assert_allclose(to_np(v), sd[k], rtol=1e-6, atol=1e-7, err_msg=k)
