"""The port's fused bottlenecks (``ops/bottleneck.py``, the opt-in
``CALD_TPU_PALLAS_BNECK`` configuration of the backbone) against the JAX
package on the CPU in float32, on the same numpy inputs. The JAX Pallas
kernels (K5 ``_block_kernel``, K6 ``_stage_kernel``) run in interpret mode,
as tests/test_pallas_interpret.py runs them; on the CPU the port's wrappers
take the plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cald_tpu.models import faster_rcnn as jfaster_rcnn
from cald_tpu.models.resnet import Bottleneck as JaxBottleneck
from cald_tpu.models.resnet import ResNetBackbone as JaxBackbone
from cald_tpu.ops.pallas_bottleneck import maybe_fused_stage, maybe_fused_stage_deep
from cald_tpu_torch.convert.from_flax import flax_to_state_dict
from cald_tpu_torch.models import faster_rcnn, resnet
from cald_tpu_torch.models.matcher import generator_gumbel
from cald_tpu_torch.models.resnet import Bottleneck, ResNetBackbone
from cald_tpu_torch.ops import bottleneck as plain
from cald_tpu_torch.ops.bottleneck_cuda import fused_block_kernel, fused_stage_kernel
from tests.test_torch_detect import FIELDS_ATOL
from tests.torch_helpers import TINY, tiny_images, tiny_models, to_np

# the bound of tests/test_pallas_interpret.py's K6 parity test
ATOL, RTOL = 5e-5, 1e-4
SUFFIX_BACKBONE = ((2, 3, 2, 2), 16)       # every stage has a stride-1 suffix
MODES = ["1", "stage"]


def _interpret(mp):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    mp.setattr(pl, "pallas_call", patched)


@pytest.fixture
def interpret_pallas(monkeypatch):
    _interpret(monkeypatch)


def _jax_blocks(rng, c, p, n, b1=None):
    """Folded blocks in the JAX package's layouts (w1 (C, P), w2 HWIO, w3
    (P, C)), numpy float32."""
    mk = lambda *s: rng.normal(0, 0.08, s).astype(np.float32)
    return [(mk(c, p), mk(p) if b1 is None else np.full((p,), b1, np.float32),
             mk(3, 3, p, p), mk(p), mk(p, c), mk(c)) for _ in range(n)]


def _port_block(blk):
    """A JAX-layout folded block in the port's layouts ((out, in), OIHW)."""
    w1, b1, w2, b2, w3, b3 = (np.asarray(a, np.float32) for a in blk)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        w1.T, b1, w2.transpose(3, 2, 0, 1), b2, w3.T, b3))


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return to_np(t.permute(0, 2, 3, 1))


@pytest.mark.parametrize("b1", [None, 1.0], ids=["random", "positive_b1"])
def test_fused_block_matches_k5(rng, interpret_pallas, b1):
    """Plain ``fused_block`` chained over 2 blocks against the JAX K5 chain;
    b1 = 1.0 is the halo-bias case (outside pixels must give the 3x3 taps 0,
    not relu(b1))."""
    blocks = _jax_blocks(rng, 256, 64, 2, b1)
    x = rng.normal(0, 1, (2, 16, 32, 256)).astype(np.float32)
    want = maybe_fused_stage(jnp.asarray(x), [tuple(map(jnp.asarray, b)) for b in blocks])
    assert want is not None
    got = _nchw(x)
    for blk in blocks:
        got = plain.fused_block(got, _port_block(blk))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n", [3, 5])
def test_fused_stage_matches_k6(rng, interpret_pallas, n):
    """Plain ``fused_stage`` against the JAX K6 plan (5 blocks split into
    groups of 2 and a tail of 1 there)."""
    blocks = _jax_blocks(rng, 256, 64, n)
    x = rng.normal(0, 1, (2, 16, 32, 256)).astype(np.float32)
    want = maybe_fused_stage_deep(jnp.asarray(x), [tuple(map(jnp.asarray, b)) for b in blocks])
    assert want is not None
    got = plain.fused_stage(_nchw(x), [_port_block(b) for b in blocks])
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL, rtol=RTOL)


def _perturb_frozen(frozen, rng):
    """Non-trivial frozen-norm statistics, as tests/torch_helpers.py gives them."""
    def perturb(path, x):
        name, shape = path[-1].key, np.shape(x)
        if name == "scale":
            return rng.uniform(0.7, 1.3, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.7, 1.4, shape).astype(np.float32)
        return rng.normal(0.0, 0.05, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, frozen)


def test_folded_matches_jax(rng):
    """``Bottleneck.folded()`` against JAX ``Bottleneck(folded=True)`` for
    weights moved through the bridge, through the layout maps HWIO -> OIHW
    and (in, out) -> (out, in)."""
    jblock = JaxBottleneck(16)
    x = jnp.zeros((1, 4, 4, 64))
    v = jblock.init(jax.random.key(0), x)
    v = {"params": v["params"], "frozen": _perturb_frozen(v["frozen"], rng)}
    want = jblock.apply(v, x, folded=True)
    sd = flax_to_state_dict({k: {"layer1_1": t} for k, t in v.items()})
    block = Bottleneck(64, 16)
    block.load_state_dict({k.removeprefix("layer1_1."): t for k, t in sd.items()}, strict=True)
    got = block.folded()
    maps = (lambda a: a.T, lambda a: a, lambda a: a.transpose(3, 2, 0, 1), lambda a: a,
            lambda a: a.T, lambda a: a)
    for g, w, f in zip(got, want, maps):
        np.testing.assert_allclose(to_np(g), f(np.asarray(w)), rtol=1e-6, atol=1e-7)


def test_folded_refuses_projection_block():
    with pytest.raises(ValueError):
        Bottleneck(64, 16, stride=2).folded()


@pytest.fixture(scope="module")
def backbones():
    """The (2, 3, 2, 2) width-16 backbone in both packages with bridged
    weights and perturbed frozen norms, and a 1x128x256 input (JAX fuses
    every stage at this size, layer4 included)."""
    rng = np.random.default_rng(3)
    blocks, width = SUFFIX_BACKBONE
    jmodel = JaxBackbone(blocks, width, norm="frozen")
    x = rng.normal(0, 1, (1, 128, 256, 3)).astype(np.float32)
    v = jax.jit(jmodel.init)(jax.random.key(1), jnp.asarray(x))
    v = {"params": jax.tree.map(np.asarray, v["params"]),
         "frozen": _perturb_frozen(v["frozen"], rng)}
    tmodel = ResNetBackbone(blocks, width)
    tmodel.load_state_dict(flax_to_state_dict(v), strict=True)
    return jmodel, v, tmodel.eval(), x


@pytest.mark.parametrize("mode", MODES)
def test_backbone_fused_matches_jax(backbones, monkeypatch, interpret_pallas, mode):
    jmodel, v, tmodel, x = backbones
    monkeypatch.setattr(JaxBackbone, "_fuse_gate", lambda self: mode)
    monkeypatch.setenv("CALD_TPU_PALLAS_BNECK", mode)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, allow_fused=True))(v, jnp.asarray(x))
    with torch.inference_mode():
        got = tmodel(_nchw(x), allow_fused=True)
        unfused = tmodel(_nchw(x))
    for k in ("c2", "c3", "c4", "c5"):
        np.testing.assert_allclose(_nhwc(got[k]), np.asarray(want[k]), atol=1e-4, rtol=0)
        # and the fused path computes the unfused function
        np.testing.assert_allclose(_nhwc(got[k]), _nhwc(unfused[k]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode,wrapper", [("", None), ("1", "block"), ("yes", "block"),
                                          ("stage", "stage")])
def test_gate_routes_the_suffixes(backbones, monkeypatch, mode, wrapper):
    """"" runs the plain blocks, "stage" one K6 call per stage suffix, any
    other value one K5 call per suffix block; without allow_fused nothing
    fuses."""
    _, _, tmodel, x = backbones
    calls = {"block": 0, "stage": 0}

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(resnet, "fused_block_kernel", count("block", fused_block_kernel))
    monkeypatch.setattr(resnet, "fused_stage_kernel", count("stage", fused_stage_kernel))
    monkeypatch.setenv("CALD_TPU_PALLAS_BNECK", mode)
    with torch.inference_mode():
        tmodel(_nchw(x[:, :32, :32]))
        assert calls == {"block": 0, "stage": 0}
        tmodel(_nchw(x[:, :32, :32]), allow_fused=True)
    suffix = [n - 1 for n in SUFFIX_BACKBONE[0]]
    want = {"block": 0, "stage": 0}
    if wrapper == "block":
        want["block"] = sum(suffix)
    elif wrapper == "stage":
        want["stage"] = len(suffix)
    assert calls == want


def _jax_suffix_backbone(cfg):
    if cfg.backbone != "tiny":
        raise ValueError(cfg.backbone)
    blocks, width = SUFFIX_BACKBONE
    return (JaxBackbone(blocks, width, norm=cfg.norm, dtype=None), ("c2", "c3", "c4", "c5"))


def _scale_pyramid(variables, factor):
    """The FPN's output convs scaled by ``factor``. With 12 bottlenecks the
    pyramid reaches about 100, eight times the tiny backbone's, and the
    amplified heads then turn f32 rounding alone (unfused, 2e-6 of the
    pyramid) into 2e-2 px of box between the packages; scaled by 1/8 the
    pyramid is the tiny model's size again."""
    params = jax.tree.map(np.asarray, variables["params"])
    for name, conv in params["fpn"].items():
        if name.startswith("output"):
            conv["kernel"] = conv["kernel"] * np.float32(factor)
            conv["bias"] = conv["bias"] * np.float32(factor)
    return {**variables, "params": params}


@pytest.fixture(scope="module")
def detections():
    """detect of the tiny detector with the (2, 3, 2, 2) backbone in both
    packages, fused per mode."""
    images, valid_hw = tiny_images()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfaster_rcnn, "_build_backbone", _jax_suffix_backbone)
        mp.setitem(faster_rcnn.BACKBONES, "tiny", SUFFIX_BACKBONE)
        _interpret(mp)
        jmodel, variables, tmodel = tiny_models()
        variables = _scale_pyramid(variables, 1 / 8)
        tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
        for mode in MODES:
            mp.setattr(JaxBackbone, "_fuse_gate", lambda self, mode=mode: mode)
            mp.setenv("CALD_TPU_PALLAS_BNECK", mode)
            det_j = jax.jit(lambda v, i, h: jmodel.apply(v, i, h, method="detect"))(
                variables, jnp.asarray(images), jnp.asarray(valid_hw))
            with torch.inference_mode():
                det_t = tmodel.detect(torch.from_numpy(images), torch.from_numpy(valid_hw))
            out[mode] = (det_j, det_t)
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("field", ["valid", "labels"])
def test_detect_fused_exact_fields(detections, mode, field):
    det_j, det_t = detections[mode]
    assert int(np.asarray(det_j.valid).sum()) > 10, "degenerate fixture"
    np.testing.assert_array_equal(to_np(getattr(det_t, field)),
                                  np.asarray(getattr(det_j, field)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("field", sorted(FIELDS_ATOL))
def test_detect_fused_slot_for_slot(detections, mode, field):
    det_j, det_t = detections[mode]
    np.testing.assert_allclose(to_np(getattr(det_t, field)),
                               np.asarray(getattr(det_j, field)),
                               atol=FIELDS_ATOL[field], rtol=0)


def test_loss_never_fuses(monkeypatch):
    """With the gate on, ``loss`` runs the plain blocks (the kernels have no
    backward) and ``detect`` the fused ones."""
    monkeypatch.setitem(faster_rcnn.BACKBONES, "tiny", SUFFIX_BACKBONE)
    monkeypatch.setenv("CALD_TPU_PALLAS_BNECK", "1")

    def refuse(*args):
        raise AssertionError("fused")

    monkeypatch.setattr(resnet, "fused_block_kernel", refuse)
    model = faster_rcnn.FasterRCNN(faster_rcnn.FasterRCNNConfig(
        **TINY, rpn_pre_nms_top_n_train=64, rpn_post_nms_top_n_train=32,
        rpn_batch_size_per_image=16, box_batch_size_per_image=16))
    images, valid_hw = (torch.from_numpy(a) for a in tiny_images())
    boxes = torch.tensor([[[10.0, 12.0, 60.0, 70.0]], [[20.0, 5.0, 90.0, 50.0]]])
    losses, _ = model.loss(images, valid_hw, boxes, torch.tensor([[1], [2]]),
                           torch.tensor([[True], [True]]),
                           generator_gumbel(torch.Generator().manual_seed(0)))
    assert all(torch.isfinite(v) for v in losses.values())
    with pytest.raises(AssertionError, match="fused"), torch.inference_mode():
        model.detect(images, valid_hw)


def test_cpu_wrappers_take_the_plain_versions(rng):
    blocks = [_port_block(b) for b in _jax_blocks(rng, 32, 8, 3)]
    x = _nchw(rng.normal(0, 1, (1, 5, 7, 32)).astype(np.float32))
    before = (fused_block_kernel.launches, fused_stage_kernel.launches)
    assert torch.equal(fused_block_kernel(x, blocks[0]), plain.fused_block(x, blocks[0]))
    assert torch.equal(fused_stage_kernel(x, blocks), plain.fused_stage(x, blocks))
    assert (fused_block_kernel.launches, fused_stage_kernel.launches) == before


# R50's stride-1 suffixes on the 640x1024 canvas: (H, W, C, P, blocks)
R50_SUFFIXES = [(160, 256, 256, 64, 2), (80, 128, 512, 128, 3), (40, 64, 1024, 256, 5),
                (20, 32, 2048, 512, 2)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("h,w,c,p,n", R50_SUFFIXES + [(3, 4, 2048, 512, 2), (24, 32, 64, 16, 7),
                                          (256, 256, 16, 4, 8)])
def test_stage_plan(h, w, c, p, n, itemsize):
    """The K6 plan covers the suffix, every group's tile fits the shared
    memory, and a group of g > 1 keeps interior/haloed area >= 0.5."""
    plan = plain.stage_plan(h, w, c, p, n, itemsize)
    assert sum(g for g, _, _ in plan) == n
    assert all(g == plan[0][0] for g, _, _ in plan[:-1])
    for g, th, tw in plan:
        assert plain.smem_bytes(th, tw, g, c, p, itemsize) <= plain.SMEM_BYTES
        if g > 1:
            assert plain.pick_tile(h, w, c, p, g, itemsize)[2] >= 0.5
    th, tw = plain.block_tile(h, w, c, p, itemsize)
    assert plain.smem_bytes(th, tw, 1, c, p, itemsize) <= plain.SMEM_BYTES


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("h,w,c,p,n", R50_SUFFIXES)
def test_r50_plan_fits(h, w, c, p, n, itemsize):
    """At R50's four suffixes on the canvas: every K6 group fits its budget
    (the 2-per-SM budget for K5's tile where such a tile exists), the groups
    cover the suffix, and every tile is no larger than the image needs."""
    plan = plain.stage_plan(h, w, c, p, n, itemsize)
    assert sum(g for g, _, _ in plan) == n
    for g, th, tw in plan:
        assert plain.smem_bytes(th, tw, g, c, p, itemsize) <= plain.SMEM_BYTES
        assert th < 2 * h and tw < 2 * w
    th, tw = plain.block_tile(h, w, c, p, itemsize)
    two = plain.pick_tile(h, w, c, p, 1, itemsize, plain.SMEM_BYTES_TWO_PER_SM)
    if two is not None and (th, tw) == two[:2]:
        assert plain.smem_bytes(th, tw, 1, c, p, itemsize) <= plain.SMEM_BYTES_TWO_PER_SM


def test_block_tile_takes_the_measured_tiles():
    """In bf16 at R50's suffixes block_tile returns the measured tile, which
    fits the shared memory; on an image smaller than that tile, or in f32, it
    takes the best 2-per-SM tile, else the best tile."""
    for h, w, c, p, _ in R50_SUFFIXES:
        th, tw = plain.MEASURED_TILES[(c, p)]
        assert plain.block_tile(h, w, c, p, 2) == (th, tw)
        assert plain.smem_bytes(th, tw, 1, c, p, 2) <= plain.SMEM_BYTES
    two = plain.pick_tile(3, 4, 2048, 512, 1, 2, plain.SMEM_BYTES_TWO_PER_SM)
    assert plain.block_tile(3, 4, 2048, 512, 2) == two[:2]
    two = plain.pick_tile(160, 256, 256, 64, 1, 4, plain.SMEM_BYTES_TWO_PER_SM)
    assert plain.block_tile(160, 256, 256, 64, 4) == two[:2]


def test_smem_layout_matches_the_kernel_source():
    """ops/bottleneck.py's shared-memory layout is the one csrc/bottleneck.cu
    allocates: the row pad and the bf16 ring (stages x rows x k + pad); f32
    has no ring."""
    import re

    from cald_tpu_torch.ops.cuda_build import CSRC

    src = (CSRC / "bottleneck.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr (?:int|size_t) (k\w+) = (\d+);", src)}
    assert (plain.SMEM_PAD, plain.RING_STAGES, plain.RING_K, plain.RING_ROWS) == (
        const["kPad"], const["kStages"], const["kBK"], const["kRingRows"])
    assert plain.SMEM_BYTES == const["kMaxSmem"]
    assert plain.RING_BYTES == const["kStages"] * const["kRingRows"] * (
        const["kBK"] + const["kPad"]) * 2
    for th, tw, g, c, p in [(8, 16, 1, 256, 64), (8, 16, 2, 256, 64), (4, 8, 1, 2048, 512)]:
        assert plain.smem_bytes(th, tw, g, c, p, 2) - plain.RING_BYTES == plain.smem_bytes(
            th, tw, g, c, p, 4) // 2


def test_stage_plan_chains_layer1_in_bf16():
    """At R50's layer1 in bf16 the whole 2-block suffix is one group; the
    wider stages run one block per group."""
    assert [g for g, _, _ in plain.stage_plan(160, 256, 256, 64, 2, 2)] == [2]
    assert [g for g, _, _ in plain.stage_plan(40, 64, 1024, 256, 5, 2)] == [1] * 5
