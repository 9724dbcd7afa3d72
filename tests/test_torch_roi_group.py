"""The grouped RoIAlign forward of the port (K4's plain version,
``ops/roi_align.py::grouped_multi_scale_roi_align``) against the JAX
package's grouped kernel (``ops/pallas_roi_align.py::_roi_group_kernel``
under ``CALD_TPU_ROI_GROUP``) in interpret mode; that neither depends on
the group size g (why the Hopper kernel, K2's, ignores it); K4's C entry in
the kernel source; gradients through ``RoIAlignFunction`` with the group
set; the group gate; ``detect`` with ``CALD_TPU_ROI_FLM=0``. On the CPU in
float32."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cald_tpu.ops.pallas_roi_align import WIN_INFER, WIN_TRAIN, pallas_multi_scale_roi_align
from cald_tpu_torch.models.roi_heads import pool_box_features
from cald_tpu_torch.ops import roi_align as plain
from cald_tpu_torch.ops import roi_align_cuda
from tests.torch_helpers import tiny_images, tiny_models, to_np

T = torch.from_numpy
SHAPES = ((80, 128), (40, 64), (20, 32), (10, 16))        # P2..P5 of a 320x512 image
SCALES = [0.25, 0.125, 0.0625, 0.03125]


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The TPU kernels run in interpret mode, as tests/test_pallas_interpret.py
    runs them on the CPU."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _feats(rng, c=128):
    return [rng.normal(0, 1, (h, w, c)).astype(np.float32) for h, w in SHAPES]


def _rois(rng, n):
    """Rois inside both TPU envelopes at their level (the inference window is
    44x48), as tests/test_pallas_interpret.py draws them."""
    cx = rng.uniform(60, 440, n)
    cy = rng.uniform(50, 270, n)
    sz = rng.uniform(20, 150, n)
    ar = rng.uniform(0.5, 2.0, n)
    w, h = sz * np.sqrt(ar), sz / np.sqrt(ar)
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)


@pytest.mark.parametrize("window", [WIN_INFER, WIN_TRAIN], ids=["infer", "train"])
@pytest.mark.parametrize("g,prec", [(2, "hi"), (4, "hi"), (4, "bf16")])
def test_plain_matches_tpu_grouped_kernel(rng, monkeypatch, interpret_pallas, g, prec, window):
    """19 rois (a pad tail at every g). "hi" atol 1e-4: both sum in float32,
    in another order. "bf16" atol 5e-2: both round the pooled weights and t
    to bf16, and a t that lands on a rounding boundary may round the other
    way."""
    monkeypatch.setenv("CALD_TPU_ROI_GROUP", str(g))
    monkeypatch.setenv("CALD_TPU_ROI_GROUP_PREC", prec)
    feats = _feats(rng)
    rois = _rois(rng, 19)
    want = pallas_multi_scale_roi_align([jnp.asarray(f) for f in feats], jnp.asarray(rois),
                                        spatial_scales=SCALES, window=window)
    got = plain.grouped_multi_scale_roi_align(
        [T(f)[None] for f in feats], T(rois)[None], spatial_scales=SCALES, g=g,
        hi_prec=plain.roi_group_hi_prec())
    assert got.dtype == torch.float32 and got.shape == (1, 19, 7, 7, 128)
    atol = 1e-4 if prec == "hi" else 5e-2
    np.testing.assert_allclose(to_np(got)[0], np.asarray(want), atol=atol, rtol=0)


def _hard_case(rng):
    """Two images of 21 rois at half size, with wide, border-crossing and
    tiny rois (beyond the TPU windows) and about 30% invalid ones."""
    feats = [T(rng.normal(0, 1, (2, h // 2, w // 2, 16)).astype(np.float32))
             for h, w in SHAPES]
    rois = np.concatenate([_rois(rng, 21)[None] / 2, _rois(rng, 21)[None] / 2])
    rois[0, :4] = [[-20, -10, 60, 50], [5, 5, 250, 40], [100, 100, 100.5, 100.5],
                   [10, 2, 40, 158]]
    valid = rng.uniform(size=(2, 21)) > 0.3
    return feats, rois, valid


@pytest.mark.parametrize("g", [1, 3, 8])
def test_plain_grouped_is_k2_function(rng, g):
    """In "hi" the grouped form is K2's function for every roi, wide,
    border-crossing and invalid ones included (atol 1e-5), whatever g."""
    feats, rois, valid = _hard_case(rng)
    args = dict(spatial_scales=SCALES, valid=T(valid))
    want = plain.multi_scale_roi_align(feats, T(rois), out_dtype=torch.float32, **args)
    got = plain.grouped_multi_scale_roi_align(feats, T(rois), g=g, **args)
    assert (got - want).abs().max().item() < 1e-5
    assert got[~T(valid)].abs().max().item() == 0.0


@pytest.mark.parametrize("g", [1, 3, 8])
@pytest.mark.parametrize("prec", ["hi", "bf16"])
def test_plain_grouped_does_not_depend_on_g(rng, g, prec):
    """The property that lets the Hopper kernel ignore g: in both modes the
    grouped form gives every roi, wide, border-crossing and invalid ones
    included, bit for bit the value it has when computed alone (g = 1, one
    roi per chunk)."""
    feats, rois, valid = _hard_case(rng)
    args = dict(spatial_scales=SCALES, valid=T(valid), hi_prec=prec == "hi")
    alone = plain.grouped_multi_scale_roi_align(feats, T(rois), g=1, chunk_size=1, **args)
    got = plain.grouped_multi_scale_roi_align(feats, T(rois), g=g, **args)
    assert torch.equal(got, alone)
    assert got[~T(valid)].abs().max().item() == 0.0
    if prec == "bf16":            # the mode's rounding points are applied
        hi = plain.grouped_multi_scale_roi_align(feats, T(rois), g=g, spatial_scales=SCALES,
                                                 valid=T(valid))
        assert not torch.equal(got, hi)


def test_tpu_grouped_kernel_does_not_depend_on_g(rng, monkeypatch, interpret_pallas):
    """The JAX package's grouped kernel in its "bf16" mode at g = 2 and g = 4,
    on rois inside its training window: the TPU kernel's function does not
    depend on g either (atol 5e-2: both round t to bf16, summed in another
    order by the block-diagonal products of another size)."""
    monkeypatch.setenv("CALD_TPU_ROI_GROUP_PREC", "bf16")
    feats = [jnp.asarray(f) for f in _feats(rng)]
    rois = jnp.asarray(_rois(rng, 19))
    out = {}
    for g in (2, 4):
        monkeypatch.setenv("CALD_TPU_ROI_GROUP", str(g))
        out[g] = np.asarray(pallas_multi_scale_roi_align(feats, rois, spatial_scales=SCALES,
                                                         window=WIN_TRAIN))
    assert out[2].shape == (19, 7, 7, 128) and np.isfinite(out[2]).all()
    np.testing.assert_allclose(out[4], out[2], atol=5e-2, rtol=0)


def test_k4_entry_runs_the_forward_kernel():
    """``csrc/roi_align.cu`` holds two kernels, the forward (K1, K2, K4) and
    the backward (K3); K4's C entry goes through the forward's launcher with
    float32 output and the "bf16" mode's switch."""
    src = (roi_align_cuda.CSRC / "roi_align.cu").read_text()
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(", src)
    assert sorted(kernels) == ["roi_align_bwd_kernel", "roi_align_fwd_kernel"]
    body = src[src.index('extern "C" int cald_roi_align_group_fwd('):]
    body = body[:body.index("\n}\n")]
    assert "<<<" not in body
    assert re.search(r"launch_fwd\([^;]*dtype, 1, hi_prec \? 0 : 1, stream\);", body)


def test_gradients_through_the_group_match_jax(rng, monkeypatch, interpret_pallas):
    """The training RoIAlign with CALD_TPU_ROI_GROUP=2: forward by K4's plain
    version, backward by K3's, against jax.grad of the JAX custom_vjp (whose
    backward is the standard-plan kernel). atol 1e-5: the same bilinear
    weights, summed in another order."""
    monkeypatch.setenv("CALD_TPU_ROI_GROUP", "2")
    feats = _feats(rng, 128)
    rois = _rois(rng, 16)
    cot = rng.normal(0, 1, (16, 7, 7, 128)).astype(np.float32)
    jf = tuple(jnp.asarray(f) for f in feats)
    fwd = lambda fs: pallas_multi_scale_roi_align(list(fs), jnp.asarray(rois),
                                                  spatial_scales=SCALES, window=WIN_TRAIN)
    want_g = jax.grad(lambda fs: jnp.sum(fwd(fs) * cot))(jf)

    tf = [T(f)[None].requires_grad_() for f in feats]
    out = pool_box_features(tf, T(rois)[None], torch.ones((1, 16), dtype=torch.bool), SCALES)
    (out * T(cot)[None]).sum().backward()
    np.testing.assert_allclose(to_np(out)[0], np.asarray(fwd(jf)), atol=1e-4, rtol=0)
    for t, w in zip(tf, want_g):
        np.testing.assert_allclose(to_np(t.grad)[0], np.asarray(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,route", [(15, "K2"), (16, "K4"), (40, "K4")])
@pytest.mark.parametrize("env", [("4", "hi"), ("4", "bf16")])
def test_gate_routes(rng, monkeypatch, n, route, env):
    """K4 runs when CALD_TPU_ROI_GROUP = g > 1 and every image has at least
    4g rois (the JAX package's gate), with the precision of
    CALD_TPU_ROI_GROUP_PREC; otherwise K2."""
    monkeypatch.setenv("CALD_TPU_ROI_GROUP", env[0])
    monkeypatch.setenv("CALD_TPU_ROI_GROUP_PREC", env[1])
    calls = []
    monkeypatch.setattr(roi_align_cuda, "roi_align_group_fwd_kernel",
                        lambda *a, **k: calls.append(("K4", k["g"], k["hi_prec"])))
    monkeypatch.setattr(roi_align_cuda, "roi_align_train_fwd_kernel",
                        lambda *a, **k: calls.append(("K2",)))
    rois = T(_rois(rng, n))[None]
    roi_align_cuda.window_roi_align([], rois, None, None, spatial_scales=SCALES)
    want = ("K4", 4, env[1] == "hi") if route == "K4" else ("K2",)
    assert calls == [want]


def test_gate_off_without_the_group(rng, monkeypatch):
    for value in ("", "0", "1"):
        monkeypatch.setenv("CALD_TPU_ROI_GROUP", value)
        assert plain.roi_group() == int(value or 0)
        calls = []
        monkeypatch.setattr(roi_align_cuda, "roi_align_train_fwd_kernel",
                            lambda *a, **k: calls.append("K2"))
        roi_align_cuda.window_roi_align([], T(_rois(rng, 64))[None], None, None,
                                        spatial_scales=SCALES)
        assert calls == ["K2"]


def test_group_wrapper_cpu_route_is_the_plain_version(rng):
    feats = [T(rng.normal(0, 1, (1, h // 4, w // 4, 8)).astype(np.float32)) for h, w in SHAPES]
    rois = T(_rois(rng, 9) / 4)[None]
    valid = torch.ones((1, 9), dtype=torch.bool)
    levels = plain.roi_levels(rois, SCALES).contiguous()
    k = roi_align_cuda.roi_align_group_fwd_kernel
    before = k.launches
    for hi in (True, False):
        got = k(feats, rois, valid, levels, g=4, hi_prec=hi, spatial_scales=SCALES)
        want = plain.grouped_multi_scale_roi_align(feats, rois, spatial_scales=SCALES, g=4,
                                                   hi_prec=hi, valid=valid, levels=levels)
        assert torch.equal(got, want)
    assert k.launches == before          # the plain version launches nothing


@pytest.fixture(scope="module")
def tiny_detect():
    jmodel, variables, tmodel = tiny_models()
    images, valid_hw = tiny_images()
    det_j = jax.jit(lambda v, i, h: jmodel.apply(v, i, h, method="detect"))(
        variables, jnp.asarray(images), jnp.asarray(valid_hw))
    return tmodel, images, valid_hw, det_j


@pytest.mark.parametrize("group", ["", "2"])
def test_detect_window_path_matches_jax(tiny_detect, monkeypatch, group):
    """``detect`` with CALD_TPU_ROI_FLM=0 (the window forward, K2 or K4)
    against the JAX package's detect, at tests/test_golden_parity.py's
    tolerances."""
    tmodel, images, valid_hw, det_j = tiny_detect
    monkeypatch.setenv("CALD_TPU_ROI_FLM", "0")
    monkeypatch.setenv("CALD_TPU_ROI_GROUP", group)
    calls = []
    orig = roi_align_cuda.window_roi_align
    monkeypatch.setattr("cald_tpu_torch.models.faster_rcnn.window_roi_align",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    with torch.inference_mode():
        det = tmodel.detect(T(images), T(valid_hw))
    assert calls == [1]
    np.testing.assert_array_equal(to_np(det.valid), np.asarray(det_j.valid))
    np.testing.assert_array_equal(to_np(det.labels), np.asarray(det_j.labels))
    for field, atol in (("scores", 1e-3), ("scores_cls", 1e-3), ("boxes", 1e-2)):
        np.testing.assert_allclose(to_np(getattr(det, field)), np.asarray(getattr(det_j, field)),
                                   atol=atol, rtol=0)
