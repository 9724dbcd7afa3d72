"""K8 (``csrc/conv_epilogue.cu``) on the card: against its plain version at
the main path's shapes (every R50 conv output and every FPN level on the
640x1024 and 1024x640 canvases, at B=16 and B=64), the wrapper's refusals,
and one detect of the seeded R50-FPN Faster R-CNN and RetinaNet: 57 K8
launches (and 57 ``trunk.epilogue`` counts inside ``detect.trunk``), and in
float32 each stage of the route against the module chain's.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with an H100 and ``nvcc`` run them with ``python -m pytest
tests/test_torch_conv_epilogue_cuda.py``. This file imports neither JAX nor
the JAX package.
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cald_tpu_torch.ops.conv_epilogue import conv_epilogue, conv_epilogue_kernel
from cald_tpu_torch.utils import spans

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K8 is a CUDA kernel)")
    conv_epilogue_kernel.load()
    return torch.device("cuda", 0)


def r50_epilogues(h: int, w: int, retina: bool = False) -> list:
    """(C, H, W, r, relu) of every K8 pass of one R50-FPN forward on an
    h x w canvas, r None, "same" or "half"; repeated blocks once."""
    out = [(64, h // 2, w // 2, None, True)]                 # the stem
    res = h // 4, w // 4
    for stage in range(4):
        planes = 64 * 2 ** stage
        inner = res if stage == 0 else (res[0] // 2, res[1] // 2)
        out += [(planes, *res, None, True), (planes, *inner, None, True),
                (4 * planes, *inner, "same", True)]
        if stage:                                           # the suffix's conv1
            out.append((planes, *inner, None, True))
        res = inner
    levels = [(h // s, w // s) for s in ((8, 16, 32) if retina else (4, 8, 16, 32))]
    for i, (lh, lw) in enumerate(levels):
        out += [(256, lh, lw, None if i == len(levels) - 1 else "half", False),
                (256, lh, lw, None, False)]
    if retina:
        out += [(256, h // 64, w // 64, None, False), (256, h // 128, w // 128, None, False)]
    return sorted(set(out), key=str)


def _operands(card, b, c, h, w, r, dtype, seed):
    g = torch.Generator(card).manual_seed(seed)
    cl = torch.channels_last
    y = torch.randn(b, c, h, w, device=card, generator=g).to(dtype).contiguous(memory_format=cl)
    bias = torch.randn(c, device=card, generator=g)
    res = None
    if r is not None:
        rh, rw = (h, w) if r == "same" else (h // 2, w // 2)
        res = torch.randn(b, c, rh, rw, device=card, generator=g).to(dtype).contiguous(
            memory_format=cl)
    return y, bias, res


@pytest.mark.parametrize("batch", [16, 64])
@pytest.mark.parametrize("canvas", [(640, 1024), (1024, 640)])
def test_k8_matches_its_plain_version_at_the_main_path_shapes(card, canvas, batch):
    """bf16, bit for bit: the same float32 additions in the same order, one
    round-to-nearest-even."""
    shapes = sorted(set(r50_epilogues(*canvas)) | set(r50_epilogues(*canvas, retina=True)),
                    key=str)
    for i, (c, h, w, r, relu) in enumerate(shapes):
        y, bias, res = _operands(card, batch, c, h, w, r, torch.bfloat16, i)
        want = conv_epilogue(y, bias, res, relu=relu)
        got = conv_epilogue_kernel(y, bias, res, relu=relu)
        torch.cuda.synchronize()
        assert got.data_ptr() == y.data_ptr()
        assert torch.equal(got, want), (c, h, w, r, relu)
        del y, res, want, got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [40, 56, 2048])
def test_k8_steps_its_channels_where_the_stride_does_not_align(card, dtype, c):
    """C whose vectors a pixel do not divide the grid's stride (the thread's
    channel steps and its bias is read again), in both dtypes and every
    form of r."""
    for i, (r, relu) in enumerate([(None, True), ("same", True), ("half", False)]):
        y, bias, res = _operands(card, 16, c, 96, 160, r, dtype, 100 + i)
        want = conv_epilogue(y, bias, res, relu=relu)
        got = conv_epilogue_kernel(y, bias, res, relu=relu)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (c, r, relu, dtype)


def test_the_wrapper_refuses_what_the_kernel_does_not_take(card):
    cl = torch.channels_last
    y = torch.zeros(2, 16, 4, 6, device=card, dtype=torch.bfloat16).contiguous(memory_format=cl)
    bias = torch.zeros(16, device=card)
    before = conv_epilogue_kernel.launches
    with pytest.raises(ValueError, match="multiple of 8"):
        conv_epilogue_kernel(torch.zeros(2, 12, 4, 6, device=card).contiguous(memory_format=cl),
                             torch.zeros(12, device=card))
    with pytest.raises(ValueError, match="channels_last"):
        conv_epilogue_kernel(torch.zeros(2, 16, 4, 6, device=card), bias)
    with pytest.raises(ValueError, match="one CUDA device"):
        conv_epilogue_kernel(y, bias.cpu())
    with pytest.raises(ValueError, match="one CUDA device"):
        conv_epilogue_kernel(y, bias, torch.zeros(2, 16, 4, 6, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="one CUDA device"):
        conv_epilogue_kernel(y.cpu(), bias)
    with pytest.raises(ValueError, match="half its resolution"):
        conv_epilogue_kernel(y, bias, torch.zeros(2, 16, 3, 3, device=card,
                                                  dtype=torch.bfloat16).contiguous(
                                                      memory_format=cl))
    assert conv_epilogue_kernel.launches == before


@pytest.fixture(scope="module", params=["faster", "retina"])
def detector(card, request):
    """(model, images, valid_hw) of the seeded R50-FPN detector in bf16."""
    import chip_smoke
    from cald_tpu_torch.models.init import random_init_
    from cald_tpu_torch.models.retinanet import RetinaNet, RetinaNetConfig

    batch = chip_smoke.make_pool(chip_smoke.BATCH)[0]
    images = torch.from_numpy(batch.images[:2]).to(card)
    valid_hw = torch.from_numpy(batch.valid_hw[:2]).to(card)
    if request.param == "faster":
        model = chip_smoke.build_model(card)
    else:
        model = RetinaNet(RetinaNetConfig(num_classes=chip_smoke.NUM_CLASSES,
                                          backbone="resnet50", compute_dtype="bfloat16")).eval()
        random_init_(model, chip_smoke.SEED)
        model.to(card)
        chip_smoke.calibrate_norms_(model, images, valid_hw)
    return model, images, valid_hw


def test_one_detect_launches_k8_57_times(detector):
    """49 passes in R50's body and 8 in the FPN, for either detector; with
    the recorder on, the 57 ``trunk.epilogue`` counts fall inside
    ``detect.trunk``."""
    model, images, valid_hw = detector
    with torch.inference_mode():
        model.detect(images, valid_hw)              # warm
        before = conv_epilogue_kernel.launches
        model.detect(images, valid_hw)
        assert conv_epilogue_kernel.launches - before == 57
        spans.clear()
        with profile(activities=[ProfilerActivity.CUDA]):
            model.detect(images, valid_hw)
            torch.cuda.synchronize()
        snap = spans.snapshot()
        spans.clear()
    assert snap["counts"]["trunk.epilogue"] == 57
    (trunk,) = [s for s in snap["spans"] if s["name"] == "detect.trunk"]
    assert trunk["counts"] == {"trunk.epilogue": 57}


def test_the_float32_route_matches_the_module_chain_conv_by_conv(detector):
    """In float32 (TF32 off), each stage of the route against the module
    chain on the chain's own input: the stem, every bottleneck and the FPN
    on the chain's C2..C5 (or C3..C5), within 1e-5 of the largest
    magnitude. Stage by stage, because the seeded model is chaotic: float32
    rounding alone, carried through 16 blocks, grows past that bound."""
    import torch.nn.functional as F

    from cald_tpu_torch.models.faster_rcnn import normalized_input

    model, images, valid_hw = detector
    f32 = type(model)(dataclasses.replace(model.cfg, compute_dtype="float32")).eval()
    f32.load_state_dict(model.state_dict())
    f32.to(images.device)
    bb = f32.backbone
    pairs = []
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            x = normalized_input(images, valid_hw, f32.pixel_mean, f32.pixel_std, None)
            y = F.relu(bb.bn1(bb.conv1(x)))
            pairs.append(("stem", conv_epilogue_kernel(*bb.conv1.folded(x, bb.bn1), relu=True),
                          y))
            y = F.max_pool2d(y, 3, stride=2, padding=1)
            feats = {}
            for stage, names in enumerate(bb.stages):
                for name in names:
                    blk = getattr(bb, name)
                    route, y = blk.forward_folded(y), blk(y)
                    pairs.append((name, route, y))
                feats[f"c{stage + 2}"] = y
            levels = [feats[k] for k in f32.feat_keys]
            route = f32.fpn(levels)
            with torch.inference_mode(False), torch.enable_grad():    # the chain on the card
                chain = [p.detach() for p in f32.fpn([t.clone() for t in levels])]
            pairs += [(f"p{i}", a, b) for i, (a, b) in enumerate(zip(route, chain))]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert len(pairs) == 1 + 16 + 5
    for name, got, want in pairs:
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        assert err <= 1e-5 * scale, (name, err, scale)
