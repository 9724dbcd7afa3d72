"""``--score-shrink-slice`` in the port's CALD scorer against the JAX
package's on the CPU in float32: the aug grouping by canvas slice, the score
function with the JAX cutout draws injected on a canvas the slice shrinks,
the detect count per score call, and the counterparts of
tests/test_canvas_independence.py's shrink-slice tests (equal to the full
canvas where the norms' biases are zero, bounded where they are not). Each
comparison states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cald_tpu.models.faster_rcnn import FasterRCNN as JFasterRCNN
from cald_tpu.models.faster_rcnn import FasterRCNNConfig as JConfig
from cald_tpu.strategies import cald as jcald
from cald_tpu_torch.convert.from_flax import flax_to_state_dict
from cald_tpu_torch.models.faster_rcnn import FasterRCNN, FasterRCNNConfig
from cald_tpu_torch.strategies import cald
from tests.test_canvas_independence import _perturb_norm_biases
from tests.test_torch_cald import jax_draw
from tests.torch_helpers import TINY, tiny_models, to_np

T = torch.from_numpy
FCDR = ("flip", "cut_out", "smaller_resize", "rotation")


@pytest.mark.parametrize("name", ["flip", "smaller_resize", "smaller_resize:0.5", "resize:0.7",
                                  "resize:1.2", "larger_resize", "cut_out:3"])
def test_shrink_ratio_and_ceil_mult_match_jax(name):
    assert cald._shrink_ratio(name) == jcald._shrink_ratio(name)
    for x in (0.0, 63.9, 64.0, 76.8, 512.0, 819.2):
        assert cald._ceil_mult(x) == jcald._ceil_mult(x)


@pytest.mark.parametrize("canvas, want", [
    ((640, 1024), {None: [0, 1, 3], (512, 832): [2]}),   # the VOC scoring canvas
    ((96, 128), {None: [0, 1, 2, 3]}),                   # the slice would not shrink it
    ((320, 384), {None: [0, 1, 3], (256, 320): [2]}),
])
def test_aug_groups(canvas, want):
    """Augs that share a slice share one detect: 'FCDR' on 640x1024 detects
    the resize on 512x832 and the other three on the canvas."""
    assert cald.aug_groups(FCDR, canvas, True) == want
    assert cald.aug_groups(FCDR, canvas, False) == {None: [0, 1, 2, 3]}


def test_aug_groups_share_a_slice():
    """Two shrinks of one ratio share the slice's detect."""
    assert cald.aug_groups(("smaller_resize", "flip", "resize:0.8"), (640, 1024), True) == {
        (512, 832): [0, 2], None: [1]}


def _images(seed=0, b=2, canvas=(320, 384), hw=((300, 360), (256, 300))):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (b, *canvas, 3)).astype(np.float32)
    for i, (h, w) in enumerate(hw):
        images[i, h:] = 0.0
        images[i, :, w:] = 0.0
    return images, np.array(hw, np.int32)


@pytest.fixture(scope="module")
def amplified():
    return tiny_models()


@pytest.mark.parametrize("augs, shapes", [
    (FCDR, [(2, 320, 384, 3), (6, 320, 384, 3), (2, 256, 320, 3)]),
    (("smaller_resize",), [(2, 320, 384, 3), (2, 256, 320, 3)]),
])
def test_shrink_slice_score_fn_matches_jax(amplified, augs, shapes):
    """The port's score fn with shrink_slice against the JAX package's on the
    same weights, images and cutout draws, on a 320x384 canvas (the resize
    detects on 256x320): consistency atol 1e-4, cls_corrs 1e-3, as
    tests/test_torch_cald.py holds the full canvas; one detect a slice."""
    jmodel, variables, tmodel = amplified
    images, hw = _images()
    key = jax.random.key(3)
    ccfg = dict(k_ref=8, shrink_slice=True, aug_names=augs)
    cj, rj = jcald.make_cald_score_fn(jmodel, jcald.CALDConfig(**ccfg), TINY["num_classes"])(
        variables, jnp.asarray(images), jnp.asarray(hw), key)
    seen = []
    detect = tmodel.detect

    def counting(images, valid_hw):
        seen.append(tuple(images.shape))
        return detect(images, valid_hw)

    tmodel.detect = counting
    try:
        ct, rt = cald.make_cald_score_fn(tmodel, cald.CALDConfig(**ccfg), TINY["num_classes"])(
            T(images), T(hw), jax_draw(key))
    finally:
        del tmodel.detect
    assert seen == shapes
    assert (np.asarray(cj) > 0).all(), "degenerate fixture"
    np.testing.assert_allclose(to_np(ct), np.asarray(cj), atol=1e-4, rtol=0)
    np.testing.assert_allclose(to_np(rt), np.asarray(rj), atol=1e-3, rtol=0)


@pytest.fixture(scope="module")
def zero_bias():
    """The JAX test's setup (tests/test_canvas_independence.py::frcnn_setup):
    the tiny detector at Flax's init, whose norms have zero biases."""
    cfg = dict(num_classes=6, backbone="tiny", compute_dtype="float32",
               rpn_pre_nms_top_n_test=200, rpn_post_nms_top_n_test=64)
    images = np.random.default_rng(0).uniform(0, 255, (1, 320, 384, 3)).astype(np.float32)
    valid_hw = np.array([[300, 360]], np.int32)
    variables = jax.jit(JFasterRCNN(JConfig(**cfg)).init)(jax.random.key(0), jnp.asarray(images),
                                                          jnp.asarray(valid_hw))

    def port(v):
        model = FasterRCNN(FasterRCNNConfig(**cfg))
        model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, v)), strict=True)
        return model.eval()

    return port, variables, images, valid_hw


@pytest.mark.parametrize("regime, atol", [("zero_bias", 2e-3), ("trained_bias", 0.15)])
def test_shrink_slice_against_full_canvas(zero_bias, regime, atol):
    """The sliced-canvas scores against the full canvas's on the same draws,
    the JAX tests' limits: atol 2e-3 where the norms' biases are zero
    (slicing drops only zero padding), 0.15 with trained-like biases (the
    coarse levels' padding halo differs by canvas)."""
    port, variables, images, valid_hw = zero_bias
    if regime == "trained_bias":
        variables = _perturb_norm_biases(variables)
    model = port(variables)
    out = []
    for shrink in (True, False):
        fn = cald.make_cald_score_fn(model, cald.CALDConfig(shrink_slice=shrink), 6)
        out.append(fn(T(images), T(valid_hw), cald.generator_draw(torch.Generator().manual_seed(1))))
    (c1, r1), (c2, r2) = out
    np.testing.assert_allclose(to_np(c1), to_np(c2), atol=atol)
    np.testing.assert_allclose(to_np(r1), to_np(r2), atol=atol)
