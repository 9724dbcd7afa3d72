"""Smoke run of the PyTorch/CUDA port (``cald_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

  1. card: ``nvidia-smi`` name and power limit, torch version, device name;
     exits non-zero at once when CUDA is unavailable (there is no CPU path);
  2. build: compiles the Hopper RoIAlign kernel from ``cald_tpu_torch/csrc``;
  3. kernel: the kernel against its plain PyTorch version at the main path's
     shapes (B=8, N=1000, P2..P5 of a 640x1024 canvas, C=256), f32 with TF32
     off (atol 1e-4) and bf16 against the f32 plain version (atol 5e-2);
     invalid rois must be exactly 0; prints both times;
  4. main path: Faster R-CNN R50-FPN, 21 classes, RPN 1000/1000, bf16, seeded
     random weights, scores a pool of 2 batches of 8 images (640x1024 canvas,
     600x1000 valid) through make_cald_score_fn -> score_pool -> cald_select
     with budget 4; checks detections, consistency and the kernel's launch
     count (2 per score call: the base detect and the batched aug detect);
     the f32 pyramid on the GPU is held against the CPU path on a small input;
  5. time: 5 warm score calls, images/s beside the card's name and power limit.

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

    scales = [0.25, 0.125, 0.0625, 0.03125]
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


def random_init_(model, seed: int) -> None:
    """Seeded random weights in the JAX package's init families: kaiming
    (fan_out) normal convs, normal(0.01) detection heads, lecun-normal Dense
    layers, zero biases; then the heads amplified as in
    tests/test_golden_parity.py so that scores and boxes spread out."""
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
            m.weight.normal_(0.0, std * heads.get(name, 1.0), generator=g)
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


def make_pool(n_images: int, seed: int = SEED):
    """Seeded 0..255 images on the canvas, valid region VALID_HW, in batches."""
    rng = np.random.default_rng(seed)
    batches = []
    for start in range(0, n_images, BATCH):
        images = np.zeros((BATCH, *CANVAS, 3), np.float32)
        # smooth random content: a coarse noise field upsampled 8x, plus fine noise
        coarse = rng.uniform(0, 255, (BATCH, VALID_HW[0] // 8, VALID_HW[1] // 8, 3))
        images[:, :VALID_HW[0], :VALID_HW[1]] = np.clip(
            coarse.repeat(8, 1).repeat(8, 2) + rng.normal(0, 12, (BATCH, *VALID_HW, 3)),
            0, 255)
        batches.append(types.SimpleNamespace(
            images=images, valid_hw=np.tile(np.array(VALID_HW, np.int32), (BATCH, 1)),
            image_idx=np.arange(start, start + BATCH)))
    return batches


def build_model(device, backbone: str = "resnet50", compute_dtype: str = "bfloat16"):
    import torch

    from cald_tpu_torch.models.faster_rcnn import FasterRCNN, FasterRCNNConfig

    cfg = FasterRCNNConfig(num_classes=NUM_CLASSES, backbone=backbone,
                           compute_dtype=compute_dtype)
    model = FasterRCNN(cfg).eval()
    random_init_(model, SEED)
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


def main_path(model, device, roi_align_kernel, n_batches: int = N_BATCHES):
    """Score a pool and select, checking the results; returns (score_fn,
    pool, kernel launches during the scoring)."""
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
        roi_align_kernel.launches = 0
        consistency, cls_corrs = score_pool(score_fn, pool, list(range(BATCH * n_batches)),
                                            gen)
        launches = roi_align_kernel.launches
    finally:
        del model.detect

    labeled_mean = np.random.default_rng(SEED).uniform(0, 2, NUM_CLASSES - 1)
    selected = cald_select(consistency, cls_corrs, labeled_mean, BUDGET, cfg)
    base_dets, aug_dets = float(np.mean(counts["base"])), float(np.mean(counts["aug"]))
    print(f"main path: {n_batches} batches x {BATCH} images, canvas {CANVAS}, valid "
          f"{VALID_HW}: mean valid detections base {base_dets:.2f}, aug {aug_dets:.2f}")
    print(f"main path: consistency {np.array2string(consistency, precision=4)}")
    print(f"main path: selected {selected.tolist()}; roi_align launches {launches} "
          f"(expected {2 * n_batches})")
    if launches != 2 * n_batches:
        raise AssertionError("the main path did not launch the roi_align kernel twice "
                             "per score call")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; there is no CPU path", file=sys.stderr)
        return 2
    from cald_tpu_torch.augment.suite import generator_draw
    from cald_tpu_torch.ops.roi_align_cuda import roi_align_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"card: torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    roi_align_kernel.load()
    print(f"build: roi_align kernel ready in {time.perf_counter() - t0:.2f} s")

    kernel = kernel_phase(device)

    model = build_model(device)
    reference_check(model, device)
    score_fn, pool, launches = main_path(model, device, roi_align_kernel)
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

    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
