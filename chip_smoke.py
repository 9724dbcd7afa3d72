"""Smoke run of the PyTorch/CUDA port (``cald_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

  1. card: ``nvidia-smi`` name and power limit, torch version, device name;
     exits non-zero at once when CUDA is unavailable (there is no CPU path);
  2. build: compiles the Hopper RoIAlign kernels from ``cald_tpu_torch/csrc``
     (one source, three entry points: K1, K2, K3);
  3. kernel: K1 against its plain PyTorch version at the scoring path's
     shapes (B=8, N=1000, P2..P5 of a 640x1024 canvas, C=256), f32 with TF32
     off (atol 1e-4) and bf16 against the f32 plain version (atol 5e-2);
     invalid rois must be exactly 0; prints both times;
  4. scoring path: Faster R-CNN R50-FPN, 21 classes, RPN 1000/1000, bf16,
     seeded random weights, scores a pool of 2 batches of 8 images (640x1024
     canvas, 600x1000 valid) through make_cald_score_fn -> score_pool ->
     cald_select with budget 4; checks detections, consistency and the
     kernels' launch counts (K1 2 per score call: the base detect and the
     batched aug detect; K2 and K3 none); the f32 pyramid on the GPU is held
     against the CPU path on a small input;
  5. time: 5 warm score calls, images/s beside the card's name and power limit;
  6. training kernels: K2 (training forward, f32 output) and K3 (training
     backward) against their plain versions at the training path's shapes
     (B=4, 512 sampled rois per image, P2..P5 of the 640x1024 canvas, C=256,
     about 25% invalid slots): f32 with TF32 off (atol 1e-4; K3's atomics
     add in an order that changes from run to run) and bf16 features against
     the f32 plain versions (atol 5e-2, K3 also 1e-2 relative); invalid rois
     give exactly 0 and add nothing to the gradient; prints both times;
  7. training path: a fresh R50-FPN (21 classes, bf16, the same seeded init
     and norm calibration, heads not amplified), batch 4 on the canvas with
     1-8 seeded gt boxes per image in 64 slots, RPN 2000/2000, samplers
     256 @ 0.5 and 512 @ 0.25, SGD (lr 0.0025, momentum 0.9, weight decay
     1e-4) with conv1 and layer1 frozen under the reference warmup +
     multistep schedule (125 steps per epoch), through make_train_step +
     train_one_epoch over 3 batches; checks finite losses, one K2 and one K3
     launch per step (K1 none), frozen parameters and norm statistics
     unchanged and trainable ones changed; then, on one fixed batch with
     fixed draws at a constant lr of 5e-5, that the loss after 5 steps is
     below the first step's; then times 5 warm steps (ms per step, images/s
     beside the card's name and power limit).

The line before the last is a JSON object describing each kernel; the last is
``{"ok": true, "device": {...}}``. JAX is not imported.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import types

import numpy as np

CANVAS = (640, 1024)
VALID_HW = (600, 1000)
BATCH = 8
N_BATCHES = 2
BUDGET = 4
NUM_CLASSES = 21
SEED = 0
TRAIN_BATCH = 4                 # the reference's batch size (cli/config.py)
TRAIN_SAMPLES = 512             # box-head samples per image
TRAIN_BATCHES = 3
MAX_BOXES = 64
STEPS_PER_EPOCH = 125           # the reference's first cycle: 500 labeled VOC images / 4
# a fiftieth of the reference's base lr, held constant for the fixed-batch
# check: with momentum 0.9, 2.5e-4 overshoots one batch within 6 steps (the
# loss falls for 3 steps and climbs back to the first's), 5e-5 falls steadily
FIXED_LR = 5e-5
SCALES = [0.25, 0.125, 0.0625, 0.03125]


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` launches (CUDA events),
    after one warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def roi_inputs(device, b: int = BATCH, n: int = 1000, c: int = 256, seed: int = SEED):
    """Unit-normal P2..P5 levels of the 640x1024 canvas, rois with ~30%
    invalid slots, plus border-crossing, tiny, whole-image, overhanging and
    extreme-aspect rois."""
    import torch

    rng = np.random.default_rng(seed)
    shapes = [(CANVAS[0] // s, CANVAS[1] // s) for s in (4, 8, 16, 32)]
    feats = [torch.from_numpy(rng.normal(0, 1, (b, h, w, c)).astype(np.float32)).to(device)
             for h, w in shapes]
    cx = rng.uniform(0, VALID_HW[1], (b, n))
    cy = rng.uniform(0, VALID_HW[0], (b, n))
    sz = rng.uniform(4, 500, (b, n))
    ar = rng.uniform(0.25, 4.0, (b, n))
    w, h = sz * np.sqrt(ar), sz / np.sqrt(ar)
    rois = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)
    rois[:, :6] = [[-20, -10, 60, 50], [980, 580, 1040, 640], [100, 100, 100.5, 100.5],
                   [0, 0, 1000, 600], [960, 10, 1160, 40], [5, 5, 6, 300]]
    valid = rng.uniform(size=(b, n)) > 0.3
    valid[:, :6] = True
    rois[~valid] = 0.0
    return feats, torch.from_numpy(rois).to(device), torch.from_numpy(valid).to(device)


def kernel_phase(device) -> dict:
    import torch

    from cald_tpu_torch.ops import roi_align as plain
    from cald_tpu_torch.ops.roi_align_cuda import roi_align_kernel

    scales = SCALES
    feats, rois, valid = roi_inputs(device)
    want = plain.multi_scale_roi_align(feats, rois, spatial_scales=scales, valid=valid)
    got = roi_align_kernel(feats, rois, valid, spatial_scales=scales)
    torch.cuda.synchronize()
    err_f32 = (got - want)[valid].abs().max().item()
    zero_f32 = got[~valid].abs().max().item()

    feats_bf = [f.bfloat16() for f in feats]
    got_bf = roi_align_kernel(feats_bf, rois, valid, spatial_scales=scales)
    torch.cuda.synchronize()
    err_bf16 = (got_bf.float() - want)[valid].abs().max().item()
    zero_bf16 = got_bf[~valid].float().abs().max().item()

    ms = cuda_ms(lambda: roi_align_kernel(feats_bf, rois, valid, spatial_scales=scales), 20)
    plain_ms = cuda_ms(lambda: plain.multi_scale_roi_align(
        feats_bf, rois, spatial_scales=scales, valid=valid), 5)
    print(f"kernel: roi_align B={BATCH} N=1000 C=256 valid={int(valid.sum())}: "
          f"f32 max_abs_err={err_f32:.3e} (atol 1e-4), bf16 max_abs_err={err_bf16:.3e} "
          f"(atol 5e-2), invalid max={max(zero_f32, zero_bf16)}; bf16 kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
    if not (err_f32 <= 1e-4 and err_bf16 <= 5e-2 and zero_f32 == 0.0 and zero_bf16 == 0.0):
        raise AssertionError("roi_align kernel disagrees with its plain version")
    return {"name": "roi_align", "route": "cuda", "source": "cald_tpu_torch/csrc/roi_align.cu",
            "replaces": "cald_tpu/ops/flm_roi_align.py:123", "max_abs_err": err_bf16,
            "max_abs_err_f32": err_f32, "ms": ms, "plain_ms": plain_ms}


def gt_boxes(rng, b: int):
    """Seeded ground truth: 1-8 boxes per image inside VALID_HW, in MAX_BOXES
    slots, labels in 1..NUM_CLASSES-1."""
    boxes = np.zeros((b, MAX_BOXES, 4), np.float32)
    labels = np.zeros((b, MAX_BOXES), np.int32)
    valid = np.zeros((b, MAX_BOXES), bool)
    for i in range(b):
        k = int(rng.integers(1, 9))
        wh = rng.uniform(32, 400, (k, 2))
        xy = rng.uniform(0, 1, (k, 2)) * (np.array(VALID_HW[::-1]) - wh)
        boxes[i, :k] = np.concatenate([xy, xy + wh], -1)
        labels[i, :k] = rng.integers(1, NUM_CLASSES, k)
        valid[i, :k] = True
    return boxes, labels, valid


def train_roi_inputs(device, c: int = 256, seed: int = SEED):
    """The training path's RoIAlign inputs: unit-normal P2..P5 levels of the
    canvas and TRAIN_SAMPLES rois per image made like the sampler's: a
    quarter positives (seeded gt boxes, jittered), random negatives, the
    border-crossing, tiny and extreme-aspect cases of ``roi_inputs``, and
    about 25% invalid slots (which keep their boxes, as the sampler's do)."""
    import torch

    rng = np.random.default_rng(seed + 10)
    b, n = TRAIN_BATCH, TRAIN_SAMPLES
    shapes = [(CANVAS[0] // s, CANVAS[1] // s) for s in (4, 8, 16, 32)]
    feats = [torch.from_numpy(rng.normal(0, 1, (b, h, w, c)).astype(np.float32)).to(device)
             for h, w in shapes]
    gt, _, gv = gt_boxes(rng, b)
    cx = rng.uniform(0, VALID_HW[1], (b, n))
    cy = rng.uniform(0, VALID_HW[0], (b, n))
    sz = rng.uniform(4, 500, (b, n))
    ar = rng.uniform(0.25, 4.0, (b, n))
    w, h = sz * np.sqrt(ar), sz / np.sqrt(ar)
    rois = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    n_pos = n // 4
    for i in range(b):
        src = gt[i, rng.integers(0, gv[i].sum(), n_pos)]
        size = (src[:, 2:] - src[:, :2]).repeat(2, axis=1)
        rois[i, 6:6 + n_pos] = src + rng.normal(0, 0.08, (n_pos, 4)) * size
    rois[:, :6] = [[-20, -10, 60, 50], [980, 580, 1040, 640], [100, 100, 100.5, 100.5],
                   [0, 0, 1000, 600], [960, 10, 1160, 40], [5, 5, 6, 300]]
    valid = rng.uniform(size=(b, n)) > 0.25
    valid[:, :6] = True
    return (feats, torch.from_numpy(rois.astype(np.float32)).to(device),
            torch.from_numpy(valid).to(device))


def train_kernel_phase(device) -> list[dict]:
    """K2 and K3 against their plain versions at the training shapes."""
    import torch

    from cald_tpu_torch.ops import roi_align as plain
    from cald_tpu_torch.ops.roi_align_cuda import roi_align_bwd_kernel, roi_align_train_fwd_kernel

    feats, rois, valid = train_roi_inputs(device)
    levels = plain.roi_levels(rois, SCALES).contiguous()
    shapes = [f.shape for f in feats]
    cot = torch.randn((*rois.shape[:2], 7, 7, feats[0].shape[-1]), device=device,
                      generator=torch.Generator(device=device).manual_seed(SEED))
    want = plain.multi_scale_roi_align(feats, rois, spatial_scales=SCALES, valid=valid,
                                       levels=levels, out_dtype=torch.float32)
    want_g = plain.multi_scale_roi_align_backward(cot, rois, valid, levels, shapes,
                                                  spatial_scales=SCALES)
    feats_bf = [f.bfloat16() for f in feats]
    fwd = lambda fs: roi_align_train_fwd_kernel(fs, rois, valid, levels, spatial_scales=SCALES)
    bwd = lambda c: roi_align_bwd_kernel(c, rois, valid, levels, shapes, spatial_scales=SCALES)

    got, got_bf = fwd(feats), fwd(feats_bf)
    got_g = bwd(cot)
    dead = bwd(cot * (~valid)[..., None, None, None])
    torch.cuda.synchronize()
    fwd_f32 = (got - want).abs().max().item()
    fwd_bf16 = (got_bf - want).abs().max().item()
    zero = max(got[~valid].abs().max().item(), got_bf[~valid].abs().max().item())
    bwd_f32 = max((g - w).abs().max().item() for g, w in zip(got_g, want_g))
    # the gradient as the training path hands it to bf16 levels: one cast
    g_bf = [g.bfloat16().float() for g in got_g]
    bwd_bf16 = max((g - w).abs().max().item() for g, w in zip(g_bf, want_g))
    bwd_bf16_ok = all(((g - w).abs() <= 5e-2 + 1e-2 * w.abs()).all().item()
                      for g, w in zip(g_bf, want_g))
    dead_max = max(g.abs().max().item() for g in dead)

    fwd_ms = cuda_ms(lambda: fwd(feats_bf), 20)
    fwd_plain_ms = cuda_ms(lambda: plain.multi_scale_roi_align(
        feats_bf, rois, spatial_scales=SCALES, valid=valid, levels=levels,
        out_dtype=torch.float32), 5)
    bwd_ms = cuda_ms(lambda: bwd(cot), 20)
    bwd_plain_ms = cuda_ms(lambda: plain.multi_scale_roi_align_backward(
        cot, rois, valid, levels, shapes, spatial_scales=SCALES), 5)
    print(f"train kernels: B={TRAIN_BATCH} S={TRAIN_SAMPLES} C=256 valid={int(valid.sum())}: "
          f"K2 f32 max_abs_err={fwd_f32:.3e} (atol 1e-4), bf16 {fwd_bf16:.3e} (atol 5e-2); "
          f"K3 f32 max_abs_err={bwd_f32:.3e} (atol 1e-4), bf16 {bwd_bf16:.3e} (atol 5e-2 + "
          f"1e-2 rel); invalid out max={zero}, invalid-only gradient max={dead_max}")
    print(f"train kernels: K2 bf16 {fwd_ms:.4f} ms, plain {fwd_plain_ms:.4f} ms; "
          f"K3 {bwd_ms:.4f} ms, plain {bwd_plain_ms:.4f} ms")
    if not (fwd_f32 <= 1e-4 and fwd_bf16 <= 5e-2 and bwd_f32 <= 1e-4 and bwd_bf16_ok
            and zero == 0.0 and dead_max == 0.0):
        raise AssertionError("a training RoIAlign kernel disagrees with its plain version")
    src = "cald_tpu_torch/csrc/roi_align.cu"
    return [{"name": "roi_align_train_fwd", "route": "cuda", "source": src,
             "replaces": "cald_tpu/ops/pallas_roi_align.py:132", "max_abs_err": fwd_bf16,
             "max_abs_err_f32": fwd_f32, "ms": fwd_ms, "plain_ms": fwd_plain_ms},
            {"name": "roi_align_bwd", "route": "cuda", "source": src,
             "replaces": "cald_tpu/ops/pallas_roi_align.py:534", "max_abs_err": bwd_bf16,
             "max_abs_err_f32": bwd_f32, "ms": bwd_ms, "plain_ms": bwd_plain_ms}]


def random_init_(model, seed: int, amplify_heads: bool = True) -> None:
    """Seeded random weights in the JAX package's init families: kaiming
    (fan_out) normal convs, normal(0.01) detection heads, lecun-normal Dense
    layers, zero biases. With ``amplify_heads`` (scoring) the heads are then
    amplified as in tests/test_golden_parity.py so that scores and boxes
    spread out; training starts from the JAX package's init as it is."""
    import torch

    from cald_tpu_torch.models.layers import Conv, Dense

    g = torch.Generator().manual_seed(seed)
    heads = {"rpn_head.objectness": 60.0, "rpn_head.deltas": 8.0, "rpn_head.conv": 3.0,
             "box_predictor.cls_score": 35.0, "box_predictor.bbox_pred": 15.0}
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, Conv):
                o, _, kh, kw = m.weight.shape
                std = 0.01 if name.startswith("rpn_head") else math.sqrt(2.0 / (o * kh * kw))
            elif isinstance(m, Dense):
                std = (0.01 if name.startswith("box_predictor")
                       else 1.0 / math.sqrt(m.weight.shape[1]))
            else:
                continue
            m.weight.normal_(0.0, std * (heads.get(name, 1.0) if amplify_heads else 1.0),
                             generator=g)
            if m.bias is not None:
                m.bias.zero_()


def calibrate_norms_(model, images, valid_hw) -> None:
    """Set every frozen norm's mean/var to the statistics of its input on one
    batch, in forward order, so activations stay bounded through the 16
    bottlenecks (random kaiming weights grow them block by block)."""
    import torch

    from cald_tpu_torch.models.layers import FrozenBatchNorm

    def pre_hook(mod, args):
        x = args[0].float()
        mod.mean.copy_(x.mean(dim=(0, 2, 3)))
        mod.var.copy_(x.var(dim=(0, 2, 3)))

    handles = [m.register_forward_pre_hook(pre_hook) for m in model.modules()
               if isinstance(m, FrozenBatchNorm)]
    try:
        with torch.inference_mode(False), torch.no_grad():
            model.features(images, valid_hw)
    finally:
        for h in handles:
            h.remove()


def make_pool(n_images: int, seed: int = SEED, batch: int = BATCH):
    """Seeded 0..255 images on the canvas, valid region VALID_HW, in batches."""
    rng = np.random.default_rng(seed)
    batches = []
    for start in range(0, n_images, batch):
        images = np.zeros((batch, *CANVAS, 3), np.float32)
        # smooth random content: a coarse noise field upsampled 8x, plus fine noise
        coarse = rng.uniform(0, 255, (batch, VALID_HW[0] // 8, VALID_HW[1] // 8, 3))
        images[:, :VALID_HW[0], :VALID_HW[1]] = np.clip(
            coarse.repeat(8, 1).repeat(8, 2) + rng.normal(0, 12, (batch, *VALID_HW, 3)),
            0, 255)
        batches.append(types.SimpleNamespace(
            images=images, valid_hw=np.tile(np.array(VALID_HW, np.int32), (batch, 1)),
            image_idx=np.arange(start, start + batch)))
    return batches


def make_train_batches(n_batches: int, seed: int = SEED):
    """Seeded training batches of TRAIN_BATCH images with their gt."""
    rng = np.random.default_rng(seed + 20)
    batches = make_pool(TRAIN_BATCH * n_batches, seed=seed + 20, batch=TRAIN_BATCH)
    for bt in batches:
        bt.boxes, bt.labels, bt.box_valid = gt_boxes(rng, TRAIN_BATCH)
    return batches


def build_model(device, backbone: str = "resnet50", compute_dtype: str = "bfloat16",
                amplify_heads: bool = True):
    import torch

    from cald_tpu_torch.models.faster_rcnn import FasterRCNN, FasterRCNNConfig

    cfg = FasterRCNNConfig(num_classes=NUM_CLASSES, backbone=backbone,
                           compute_dtype=compute_dtype)
    model = FasterRCNN(cfg).eval()
    random_init_(model, SEED, amplify_heads)
    model.to(device)
    calib = make_pool(BATCH, seed=SEED + 1)[0]
    calibrate_norms_(model, torch.from_numpy(calib.images[:2]).to(device),
                     torch.from_numpy(calib.valid_hw[:2]).to(device))
    return model


def reference_check(model, device) -> float:
    """The f32 pyramid on the GPU against the CPU path of the same weights
    on a small input (TF32 off); returns the max relative error."""
    import torch

    from cald_tpu_torch.models.faster_rcnn import FasterRCNN, FasterRCNNConfig

    f32 = FasterRCNN(FasterRCNNConfig(num_classes=NUM_CLASSES, compute_dtype="float32"))
    f32.load_state_dict(model.state_dict())
    f32.eval()
    images = torch.from_numpy(make_pool(BATCH, seed=SEED + 2)[0].images[:2, :128, :192].copy())
    hw = torch.tensor([[128, 192], [100, 150]], dtype=torch.int32)
    with torch.inference_mode():
        want = f32.features(images, hw)
    f32.to(device)
    with torch.inference_mode():
        got = f32.features(images.to(device), hw.to(device))
    err = max(((g.cpu() - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want))
    print(f"reference: f32 pyramid GPU vs CPU on 2x128x192, max relative error {err:.3e} "
          f"(limit 1e-3)")
    if not err <= 1e-3:
        raise AssertionError("GPU pyramid disagrees with the CPU path")
    return err


def main_path(model, device, kernels, n_batches: int = N_BATCHES):
    """Score a pool and select, checking the results; returns (score_fn,
    pool, K1 launches during the scoring). ``kernels`` are the three kernel
    wrappers (K1, K2, K3); every count is set to 0 just before the scoring
    and read just after."""
    import torch

    from cald_tpu_torch.strategies.cald import (
        CALDConfig, cald_select, make_cald_score_fn, score_pool,
    )

    cfg = CALDConfig()
    counts = {"base": [], "aug": []}
    detect = model.detect

    def counting_detect(images, valid_hw):
        d = detect(images, valid_hw)
        key = "base" if images.shape[0] == BATCH else "aug"
        counts[key].append(d.valid.sum(dim=1).float().mean().item())
        return d

    score_fn = make_cald_score_fn(model, cfg, NUM_CLASSES)
    pool = make_pool(BATCH * n_batches)
    gen = torch.Generator(device=device).manual_seed(SEED)
    model.detect = counting_detect          # instance attribute over the method
    try:
        for k in kernels:
            k.launches = 0
        consistency, cls_corrs = score_pool(score_fn, pool, list(range(BATCH * n_batches)),
                                            gen)
        launches, train_launches = kernels[0].launches, [k.launches for k in kernels[1:]]
    finally:
        del model.detect

    labeled_mean = np.random.default_rng(SEED).uniform(0, 2, NUM_CLASSES - 1)
    selected = cald_select(consistency, cls_corrs, labeled_mean, BUDGET, cfg)
    base_dets, aug_dets = float(np.mean(counts["base"])), float(np.mean(counts["aug"]))
    print(f"main path: {n_batches} batches x {BATCH} images, canvas {CANVAS}, valid "
          f"{VALID_HW}: mean valid detections base {base_dets:.2f}, aug {aug_dets:.2f}")
    print(f"main path: consistency {np.array2string(consistency, precision=4)}")
    print(f"main path: selected {selected.tolist()}; roi_align launches {launches} "
          f"(expected {2 * n_batches}), training kernels {train_launches} (expected 0)")
    if launches != 2 * n_batches or any(train_launches):
        raise AssertionError("the main path did not launch the roi_align kernel twice "
                             "per score call, and only it")
    if not (base_dets > 0 and aug_dets > 0):
        raise AssertionError("no detections on the main path")
    if not (np.isfinite(consistency).all() and consistency.min() >= 0.0
            and consistency.max() <= 1.0):
        raise AssertionError("consistency not finite or outside [0, 1]")
    if cls_corrs.shape != (BATCH * n_batches, NUM_CLASSES - 1) or not np.isfinite(cls_corrs).all():
        raise AssertionError("bad cls_corrs")
    if len(selected) != BUDGET or len(set(selected.tolist())) != BUDGET:
        raise AssertionError("selection is not budget distinct images")
    return score_fn, pool, launches


def train_path(device, kernels, backbone: str = "resnet50") -> dict:
    """Train a fresh detector through make_train_step + train_one_epoch and
    check it (phase 7); returns the K2/K3 launches and the step timing."""
    import torch

    from cald_tpu_torch.engine.optim import RESNET_FROZEN_L3, make_sgd
    from cald_tpu_torch.engine.schedules import lr_scheduler, multistep_with_warmup
    from cald_tpu_torch.engine.train import make_train_step, train_one_epoch
    from cald_tpu_torch.engine.logging import MetricLogger
    from cald_tpu_torch.models.matcher import generator_gumbel

    model = build_model(device, backbone=backbone, amplify_heads=False)
    cfg = model.cfg
    loader = make_train_batches(TRAIN_BATCHES)
    opt = make_sgd(model, 0.0025, frozen_prefixes=RESNET_FROZEN_L3)
    sched = lr_scheduler(opt, multistep_with_warmup(0.0025, steps_per_epoch=STEPS_PER_EPOCH))
    step = make_train_step(model, opt, sched)
    seen = []

    def recording_step(*args):
        m = step(*args)
        seen.append(m)
        return m

    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    trainable = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    draw = generator_gumbel(torch.Generator(device=device).manual_seed(SEED))
    logger = MetricLogger(delimiter="  ", print_fn=lambda line: print(f"train: {line}"))
    for k in kernels:
        k.launches = 0
    train_one_epoch(recording_step, loader, draw, device=device, epoch=0, print_freq=1,
                    logger=logger)
    launches = [k.launches for k in kernels]
    names = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg")
    per_step = [{k: float(m[k]) for k in names} for m in seen]
    print(f"train: cfg rpn {cfg.rpn_pre_nms_top_n_train}/{cfg.rpn_post_nms_top_n_train}, "
          f"samplers {cfg.rpn_batch_size_per_image} @ {cfg.rpn_positive_fraction} and "
          f"{cfg.box_batch_size_per_image} @ {cfg.box_positive_fraction}; {len(seen)} steps "
          f"of B={TRAIN_BATCH}; launches K1/K2/K3 {launches} (expected [0, {len(seen)}, "
          f"{len(seen)}]); lr after {opt.param_groups[0]['lr']:.6g}")
    if len(seen) != TRAIN_BATCHES or launches != [0, len(seen), len(seen)]:
        raise AssertionError("the training path did not launch K2 and K3 once per step")
    if not all(math.isfinite(v) for d in per_step for v in d.values()):
        raise AssertionError(f"non-finite training losses {per_step}")
    params = dict(model.named_parameters())
    moved = [n for n, p in frozen.items() if not torch.equal(params[n], p)]
    moved += [n for n, b in model.named_buffers() if not torch.equal(b, buffers[n])]
    still = [n for n, p in trainable.items() if torch.equal(params[n], p)]
    print(f"train: {len(frozen)} frozen parameters and {len(buffers)} norm buffers, "
          f"{len(moved)} moved; {len(trainable)} trainable, {len(still)} unchanged")
    if moved or still or not frozen:
        raise AssertionError(f"frozen state moved {moved[:5]} or trainable stayed {still[:5]}")

    # one fixed batch, fixed draws, constant lr: the loss must fall in 5 steps
    fixed = {}

    def fixed_draw(stream, shape):
        if (stream, shape) not in fixed:
            fixed[(stream, shape)] = draw(stream, shape)
        return fixed[(stream, shape)]

    bt = loader[0]
    batch = [torch.from_numpy(a).to(device) for a in (
        bt.images, bt.valid_hw, bt.boxes, bt.labels, bt.box_valid)]
    step_fixed = make_train_step(model, make_sgd(model, FIXED_LR,
                                                 frozen_prefixes=RESNET_FROZEN_L3))
    curve = [float(step_fixed(*batch, fixed_draw)["loss"]) for _ in range(6)]
    print(f"train: fixed batch, fixed draws, lr {FIXED_LR}: loss "
          f"{' '.join(f'{v:.4f}' for v in curve)}")
    if not (all(math.isfinite(v) for v in curve) and curve[5] < curve[0]):
        raise AssertionError("the loss did not fall on the fixed batch")

    reps = 5
    step_fixed(*batch, fixed_draw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step_fixed(*batch, fixed_draw)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    return {"launches": launches, "step_ms": dt * 1e3, "images_per_s": TRAIN_BATCH / dt,
            "losses": per_step[-1]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; there is no CPU path", file=sys.stderr)
        return 2
    from cald_tpu_torch.augment.suite import generator_draw
    from cald_tpu_torch.ops.roi_align_cuda import (
        roi_align_bwd_kernel, roi_align_kernel, roi_align_train_fwd_kernel,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"card: torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    kernels = (roi_align_kernel, roi_align_train_fwd_kernel, roi_align_bwd_kernel)
    t0 = time.perf_counter()
    for k in kernels:
        k.load()
    print(f"build: roi_align kernels (K1, K2, K3) ready in {time.perf_counter() - t0:.2f} s")

    kernel = kernel_phase(device)

    model = build_model(device)
    reference_check(model, device)
    score_fn, pool, launches = main_path(model, device, kernels)
    kernel["launches"] = launches

    images = torch.from_numpy(pool[0].images).to(device)
    valid_hw = torch.from_numpy(pool[0].valid_hw).to(device)
    draw = generator_draw(torch.Generator(device=device).manual_seed(SEED + 3))
    reps = 5
    score_fn(images, valid_hw, draw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        score_fn(images, valid_hw, draw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"time: {reps} warm score calls of B={BATCH}: {dt / reps * 1e3:.1f} ms/call, "
          f"{reps * BATCH / dt:.2f} images/s on {card}")
    del model, score_fn
    torch.cuda.empty_cache()

    train_kernels = train_kernel_phase(device)
    train = train_path(device, kernels)
    for entry, n in zip(train_kernels, train["launches"][1:]):
        entry["launches"] = n
    print(f"train time: {TRAIN_BATCH} images per step, 5 warm steps: {train['step_ms']:.1f} "
          f"ms/step, {train['images_per_s']:.2f} images/s on {card}")

    print(json.dumps({"kernels": [kernel, *train_kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
