"""The trunk's inference route on the CPU: every frozen norm folded into its
conv, each conv finished by K8's plain version (``ops/conv_epilogue.py``),
against the module chain (``models/layers.py``, ``resnet.py``, ``fpn.py``).

The route is taken for CUDA tensors only (``layers.inference_route``).
The tests here call the route's own methods (``ResNetBackbone.forward_
folded``, ``Bottleneck.forward_folded``, ``FPN.forward_folded``), or take a
CPU input for a CUDA one in the route's predicate (fixture
``cpu_counts_as_cuda``), so that the CPU runs what the card runs, with K8's
plain version in place of the kernel.

Tolerances. In float32 the route is held to the module chain within 1e-5
(of the reference's largest magnitude).
In bfloat16 the single pieces (``test_epilogue_piece_matches_the_module_
chain``) are built on exact arithmetic: integer inputs, weights in
quarters, norms whose gain is a power of two (eps 0, var 1) and shifts in
256ths, so every convolution, the folded weights and the float32 chain are
exact, and the route's bfloat16 output must be the float32 result rounded
once, bit for bit. Through a whole trunk the convolutions themselves round;
there the route's bfloat16 pyramid is held to be no farther from the float32
chain than the bfloat16 module chain is (it rounds once where the chain
rounds up to three times). With autograd on, the route is never taken: the
forward and every gradient equal the module chain's exactly.
"""

from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from cald_tpu_torch.models import layers
from cald_tpu_torch.models.faster_rcnn import FasterRCNN, FasterRCNNConfig
from cald_tpu_torch.models.fpn import FPN
from cald_tpu_torch.models.init import random_init_
from cald_tpu_torch.models.layers import Conv, FrozenBatchNorm
from cald_tpu_torch.models.resnet import Bottleneck, ResNetBackbone
from cald_tpu_torch.models.retinanet import RetinaNet, RetinaNetConfig
from cald_tpu_torch.ops.conv_epilogue import (
    ConvEpilogueKernel, conv_epilogue, conv_epilogue_kernel,
)

torch.set_num_threads(1)
BF16 = torch.bfloat16
KEYS = ("c2", "c3", "c4", "c5")


def _cuda_like(x: torch.Tensor) -> SimpleNamespace:
    """What the route's predicate reads of a CUDA tensor of x's dtype."""
    return SimpleNamespace(is_cuda=True, dtype=x.dtype)


@pytest.fixture
def cpu_counts_as_cuda(monkeypatch):
    """The route's predicate, with every other condition its own, taking a
    CPU input for a CUDA one."""
    real = layers.inference_route
    monkeypatch.setattr(layers, "inference_route",
                        lambda x, conv, norm: real(_cuda_like(x), conv, norm))


@pytest.fixture
def k8_calls(monkeypatch):
    """Counts the wrapper's calls (each a launch on the card)."""
    calls = []
    call = ConvEpilogueKernel.__call__

    def counting(self, *args, **kwargs):
        calls.append(args[0].shape)
        return call(self, *args, **kwargs)

    monkeypatch.setattr(ConvEpilogueKernel, "__call__", counting)
    return calls


def _cl(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _ints(g, shape, lo, hi, scale=1.0) -> torch.Tensor:
    return _cl(torch.randint(lo, hi + 1, shape, generator=g).float() * scale)


@torch.no_grad()
def _exact_conv(g, in_ch, out_ch, kernel, *, bias=False, stride=1) -> Conv:
    conv = Conv(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2, bias=bias)
    conv.weight.copy_(torch.randint(-1, 2, conv.weight.shape, generator=g) * 0.25)
    if bias:
        conv.bias.copy_(torch.randint(-64, 64, (out_ch,), generator=g) / 128)
    return conv


@torch.no_grad()
def _exact_norm(g, features) -> FrozenBatchNorm:
    bn = FrozenBatchNorm(features, eps=0.0)
    bn.scale.copy_(2.0 ** torch.randint(-1, 2, (features,), generator=g).float())
    bn.bias.copy_(torch.randint(-128, 128, (features,), generator=g) / 256)
    bn.mean.copy_(torch.randint(-128, 128, (features,), generator=g) / 256)
    return bn


def _pieces(case: str, g):
    """(chain, route): two functions of the compute dtype (None for float32)
    giving one piece of the trunk through the module chain and through the
    folded conv and K8's plain version, on the same exact inputs."""
    def with_dtype(dt, *convs):
        for c in convs:
            c.dtype = dt

    if case == "norm_relu":             # the stem, a block's conv1 or conv2
        x = _ints(g, (2, 4, 12, 10), -1, 1)
        conv, bn = _exact_conv(g, 4, 16, 3), _exact_norm(g, 16)

        def chain(dt):
            with_dtype(dt, conv)
            return F.relu(bn(conv(x)))

        def route(dt):
            with_dtype(dt, conv)
            return conv_epilogue(*conv.folded(x, bn), relu=True)
    elif case == "identity":            # conv3 of a stride-1 block
        x, z = _ints(g, (2, 32, 8, 10), -1, 1), _ints(g, (2, 8, 8, 10), -1, 1)
        conv, bn = _exact_conv(g, 8, 32, 1), _exact_norm(g, 32)

        def chain(dt):
            with_dtype(dt, conv)
            return F.relu(bn(conv(z)) + x.to(dt or x.dtype))

        def route(dt):
            with_dtype(dt, conv)
            return conv_epilogue(*conv.folded(z, bn), x.to(dt or x.dtype), relu=True)
    elif case == "projection":          # conv3 and the projection shortcut of block 0
        x, z = _ints(g, (2, 16, 8, 10), -1, 1), _ints(g, (2, 8, 4, 5), -1, 1)
        conv, bn = _exact_conv(g, 8, 32, 1), _exact_norm(g, 32)
        down, down_bn = _exact_conv(g, 16, 32, 1, stride=2), _exact_norm(g, 32)

        def chain(dt):
            with_dtype(dt, conv, down)
            return F.relu(bn(conv(z)) + down_bn(down(x)))

        def route(dt):
            with_dtype(dt, conv, down)
            y, bias = conv.folded(z, bn)
            shortcut, shift = down.folded(x, down_bn)
            return conv_epilogue(y, bias + shift, shortcut, relu=True)
    else:                               # an FPN lateral and the top-down merge
        x, up = _ints(g, (2, 16, 8, 12), -1, 1), _ints(g, (2, 16, 4, 6), -8, 8, 1 / 8)
        conv = _exact_conv(g, 16, 16, 1, bias=True)

        def chain(dt):
            with_dtype(dt, conv)
            u = up.to(dt or up.dtype)
            return conv(x) + F.interpolate(u, size=(8, 12), mode="nearest-exact")

        def route(dt):
            with_dtype(dt, conv)
            return conv_epilogue(*conv.folded(x), up.to(dt or up.dtype))
    return chain, route


PIECE_SEEDS = {"norm_relu": 11, "identity": 12, "projection": 13, "fpn_merge": 14}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["norm_relu", "identity", "projection", "fpn_merge"])
@torch.no_grad()
def test_epilogue_piece_matches_the_module_chain(case, dtype):
    """Each piece K8 finishes, on exact arithmetic: float32 within 1e-5 of
    the chain; bfloat16 the float32 chain's result rounded once."""
    chain, route = _pieces(case, torch.Generator().manual_seed(PIECE_SEEDS[case]))
    want = chain(None)
    assert want.dtype == torch.float32 and want.abs().max() > 1
    if dtype == "float32":
        torch.testing.assert_close(route(None), want, rtol=1e-5, atol=1e-5)
        return
    got = route(BF16)
    assert got.dtype == BF16 and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want.to(BF16))
    assert ((got.float() - want).abs() <= want.abs() * 2.0 ** -8).all()   # half an ulp
    # the result needs more bits than bf16 holds, so the rounding is real
    assert not torch.equal(got.float(), want)


def _perturb_(model, seed: int) -> None:
    """Frozen-norm statistics and conv biases away from the identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                n = m.scale.numel()
                m.scale.copy_(1 + 0.1 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.mean.copy_(0.1 * torch.randn(n, generator=g))
                m.var.copy_(1 + 0.1 * torch.rand(n, generator=g))
            elif isinstance(m, Conv) and m.bias is not None:
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))


def _trunk(extra: str, dtype=None, norm: str = "frozen"):
    backbone = ResNetBackbone((1, 1, 1, 1), 16, dtype=dtype, norm=norm)
    fpn = FPN(backbone.out_channels, 32, dtype=dtype, extra=extra, norm=norm)
    for i, m in enumerate((backbone, fpn)):
        random_init_(m, i + 1)
        _perturb_(m, i + 3)
    return backbone, fpn


def _pyramid(backbone, fpn, x):
    feats = backbone(x)
    return [feats[k] for k in KEYS], fpn([feats[k] for k in KEYS])


def _image(seed: int = 5, shape=(2, 3, 64, 96)) -> torch.Tensor:
    return _cl(torch.randn(shape, generator=torch.Generator().manual_seed(seed)))


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a.float() - ref).norm() / ref.norm()).item()


def _assert_close(got: torch.Tensor, want: torch.Tensor, tol: float = 1e-5) -> None:
    """Every element within ``tol`` of the reference's largest magnitude."""
    assert got.shape == want.shape and got.dtype == want.dtype
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    assert err <= tol * scale, (err, scale)


def _folded_pyramid(backbone, fpn, x):
    feats = backbone.forward_folded(x)
    feats = [feats[k] for k in KEYS]
    return feats, fpn.forward_folded(feats)


@pytest.mark.parametrize("extra", ["pool", "p6p7"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@torch.no_grad()
def test_folded_trunk_matches_the_module_chain(dtype, extra, k8_calls):
    """ResNetBackbone and FPN on the route against the module chain, C2..C5
    and every pyramid level; 13 K8 passes in the tiny backbone (the stem
    and 4 blocks of 3), 8 in the FPN (4 laterals and 4 outputs) and 2 more
    for P6/P7."""
    x = _image()
    ref_feats, ref_pyr = _pyramid(*_trunk(extra), x)     # float32 module chain
    dt = None if dtype == "float32" else BF16
    backbone, fpn = _trunk(extra, dt)
    if dt is not None:
        chain_feats, chain_pyr = _pyramid(backbone, fpn, x)
    assert not k8_calls
    feats, pyr = _folded_pyramid(backbone, fpn, x)
    assert len(k8_calls) == 13 + 8 + (2 if extra == "p6p7" else 0)
    assert len(pyr) == len(ref_pyr) == (5 if extra == "pool" else 6)
    if dt is None:
        for got, want in zip(feats + pyr, ref_feats + ref_pyr):
            _assert_close(got, want)
    else:
        for got, chain, want in zip(feats + pyr, chain_feats + chain_pyr, ref_feats + ref_pyr):
            assert got.dtype == BF16
            assert _rel(got, want) <= _rel(chain, want), (_rel(got, want), _rel(chain, want))


@pytest.mark.parametrize("sizes", ["equal", "double", "uneven"])
@torch.no_grad()
def test_folded_fpn_merges_every_level_shape(sizes, k8_calls):
    """The FPN's top-down merge on the route: levels of equal size (the
    MobileNetV3 FPN's two stride-32 maps) through the same-shape form of r,
    exact halves through the half-resolution read, other sizes resampled by
    ``F.interpolate`` first; float32 within 1e-5 of the chain."""
    hw = {"equal": [(8, 10), (8, 10)], "double": [(16, 20), (8, 10)],
          "uneven": [(13, 17), (7, 9)]}[sizes]
    fpn = FPN((24, 40), 32, extra="none")
    random_init_(fpn, 4)
    _perturb_(fpn, 5)
    feats = [_image(i, (2, c, h, w)) for i, (c, (h, w)) in enumerate(zip((24, 40), hw))]
    want = fpn(feats)
    assert not k8_calls
    with torch.enable_grad():
        assert all(torch.equal(a, b) for a, b in zip(fpn(feats), want))
    assert not k8_calls
    got = fpn.forward_folded(feats)
    assert len(k8_calls) == 4
    for a, b in zip(got, want):
        _assert_close(a, b)


ROUTE_CASES = {      # (device, autograd, norm, compute dtype, conv width) -> route
    "cuda_no_grad": (("cuda", "no_grad", "frozen", BF16, 16), True),
    "cuda_inference_mode": (("cuda", "inference_mode", "frozen", BF16, 16), True),
    "cuda_float32": (("cuda", "no_grad", "frozen", None, 16), True),
    "cpu": (("cpu", "no_grad", "frozen", BF16, 16), False),
    "autograd_on": (("cuda", "enable_grad", "frozen", BF16, 16), False),
    "group_norm": (("cuda", "no_grad", "group", BF16, 16), False),
    "float16": (("cuda", "no_grad", "frozen", torch.float16, 16), False),
    "width_not_8": (("cuda", "no_grad", "frozen", BF16, 12), False),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_the_route_follows_what_the_trunk_sees(case):
    """``inference_route``: frozen norms, a CUDA input, autograd off, a dtype
    K8 takes and widths a multiple of 8, each needed; no other switch."""
    (device, mode, norm, dtype, width), want = ROUTE_CASES[case]
    x = _image()
    seen = _cuda_like(x) if device == "cuda" else x
    conv = Conv(3, width, 3, padding=1, dtype=dtype)
    with getattr(torch, mode)():
        assert layers.inference_route(seen, conv, norm) is want


def test_autograd_on_runs_the_module_chain(monkeypatch, k8_calls):
    """With autograd on the route is never taken, even for an input the
    predicate takes for a CUDA one: the forward and every gradient (weights
    and input) equal the module chain's bit for bit. The same input with
    autograd off does take it."""
    x = _image().requires_grad_(True)
    backbone, fpn = _trunk("p6p7")
    params = [p for m in (backbone, fpn) for p in m.parameters()]
    results = []
    for cuda in (False, True):
        if cuda:
            real = layers.inference_route
            monkeypatch.setattr(layers, "inference_route",
                                lambda x, conv, norm: real(_cuda_like(x), conv, norm))
        feats, pyr = _pyramid(backbone, fpn, x)
        outs = feats + pyr
        loss = sum((o * (i + 1)).square().mean() for i, o in enumerate(outs))
        grads = torch.autograd.grad(loss, params + [x])
        results.append(([o.detach() for o in outs], grads))
    assert not k8_calls
    for a, b in zip(results[0][0] + list(results[0][1]), results[1][0] + list(results[1][1])):
        assert torch.equal(a, b)
    with torch.no_grad():
        _pyramid(backbone, fpn, x)
    assert len(k8_calls) == 13 + 8 + 2


@torch.no_grad()
def test_group_norm_never_folds(monkeypatch, k8_calls):
    """A group-norm backbone has no affine form to fold: with autograd off
    and an input the route's predicate takes for a CUDA one, it and the FPN
    after it run the module chain, bit for bit, without K8."""
    backbone, fpn = _trunk("p6p7", norm="group")
    x = _image()
    want = _pyramid(backbone, fpn, x)
    real = layers.inference_route
    monkeypatch.setattr(layers, "inference_route",
                        lambda x, conv, norm: real(_cuda_like(x), conv, norm))
    got = _pyramid(backbone, fpn, x)
    assert not k8_calls
    assert all(torch.equal(a, b) for a, b in zip(got[0] + got[1], want[0] + want[1]))


@pytest.mark.parametrize("norm", ["frozen", "group"])
@pytest.mark.parametrize("backbone", ["tiny", "mobilenetv3"])
def test_detector_trunk_takes_the_route_by_its_norms(backbone, norm, cpu_counts_as_cuda,
                                                    k8_calls):
    """A Faster R-CNN's pyramid under ``inference_mode`` with an input taken
    for a CUDA one: frozen norms take the route through the backbone (the
    tiny ResNet's 13 K8 passes; MobileNetV3's backbone keeps its chain) and
    the FPN (4 laterals and 4 outputs; MobileNetV3's 2 and 2), float32 within
    1e-5 of the chain; group norms keep the chain in both, bit for bit."""
    det = FasterRCNN(FasterRCNNConfig(num_classes=3, backbone=backbone, norm=norm,
                                      compute_dtype="float32")).eval()
    random_init_(det, 8)
    _perturb_(det, 9)
    images = torch.rand(2, 64, 96, 3, generator=torch.Generator().manual_seed(10))
    hw = torch.tensor([[64, 96], [50, 70]])
    with torch.enable_grad():
        want = [p.detach() for p in det.features(images, hw)]
    assert not k8_calls
    with torch.inference_mode():
        got = det.features(images, hw)
    expect = {("tiny", "frozen"): 13 + 8, ("mobilenetv3", "frozen"): 4}.get((backbone, norm), 0)
    assert len(k8_calls) == expect
    for a, b in zip(got, want):
        if expect:
            _assert_close(a, b)
        else:
            assert torch.equal(a, b)


@torch.no_grad()
def test_block_route_adds_both_shifts(k8_calls):
    """A block with a projection shortcut: three K8 passes, the last with
    conv3's and the shortcut's shifts summed, in float32 within 1e-5 of the
    chain."""
    block = Bottleneck(32, 16, stride=2)
    random_init_(block, 6)
    _perturb_(block, 7)
    x = _image(8, (2, 32, 12, 14))
    got = block.forward_folded(x)
    assert len(k8_calls) == 3 and k8_calls[-1] == (2, 64, 6, 7)
    _assert_close(got, block(x))


@pytest.mark.parametrize("model", ["faster", "retina"])
@torch.no_grad()
def test_r50_trunk_passes_k8_57_times(model, cpu_counts_as_cuda, k8_calls):
    """One R50-FPN forward of either detector: 49 K8 passes in the body
    (the stem and 16 blocks of 3), 8 in the FPN (Faster R-CNN's 4 laterals
    and 4 outputs; RetinaNet's 3 and 3 and P6, P7)."""
    if model == "faster":
        det = FasterRCNN(FasterRCNNConfig(num_classes=3, compute_dtype="float32")).eval()
    else:
        det = RetinaNet(RetinaNetConfig(num_classes=3, compute_dtype="float32")).eval()
    images = torch.zeros(1, 64, 64, 3)
    hw = torch.tensor([[64, 64]])
    with torch.inference_mode():
        pyramid = det.features(images, hw)
    assert len(k8_calls) == 57
    assert len(pyramid) == 5


@torch.no_grad()
def test_plain_half_resolution_read_is_nearest_exact():
    """r at exactly half y's size is read at (h // 2, w // 2): the same as
    ``F.interpolate(mode="nearest-exact")``; other sizes are refused."""
    g = torch.Generator().manual_seed(9)
    r = _cl(torch.randn(2, 8, 5, 7, generator=g))
    y = _cl(torch.zeros(2, 8, 10, 14))
    got = conv_epilogue(y, torch.zeros(8), r)
    assert torch.equal(got, F.interpolate(r, size=(10, 14), mode="nearest-exact"))
    with pytest.raises(ValueError, match="half its resolution"):
        conv_epilogue(_cl(torch.zeros(2, 8, 11, 14)), torch.zeros(8), r)


@torch.no_grad()
def test_wrapper_on_the_cpu_writes_over_y():
    """For CPU tensors the wrapper runs the plain version and writes the
    result over y, as the kernel does on the card; a device mix raises."""
    g = torch.Generator().manual_seed(10)
    y = _cl(torch.randn(2, 16, 6, 8, generator=g))
    bias, r = torch.randn(16, generator=g), _cl(torch.randn(2, 16, 3, 4, generator=g))
    want = conv_epilogue(y, bias, r, relu=True)
    before = conv_epilogue_kernel.launches
    assert conv_epilogue_kernel(y, bias, r, relu=True) is y
    assert torch.equal(y, want)
    assert conv_epilogue_kernel.launches == before
    with pytest.raises(ValueError, match="one CUDA device"):
        conv_epilogue_kernel(y, torch.zeros(16, device="meta"))
