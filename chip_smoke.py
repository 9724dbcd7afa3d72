"""Smoke run of the PyTorch/CUDA port (``cald_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

  1. card: ``nvidia-smi`` name and power limit, torch version, device name;
     exits non-zero at once when CUDA is unavailable (there is no CPU path);
  2. build: compiles the Hopper kernels from ``cald_tpu_torch/csrc``, one
     ``nvcc`` per source, started together: ``roi_align.cu`` (K1-K4) and
     ``bottleneck.cu`` (K5, K6);
  3. kernel: K1 against its plain PyTorch version at the scoring path's
     shapes (B=8, N=1000, P2..P5 of a 640x1024 canvas, C=256), f32 with TF32
     off (atol 1e-4) and bf16 against the f32 plain version (atol 5e-2);
     invalid rois must be exactly 0; prints the kernel's time before and
     after the plain version's (the first is the card's first work after the
     build) and the plain version's;
  4. scoring path: Faster R-CNN R50-FPN, 21 classes, RPN 1000/1000, bf16,
     seeded random weights, scores a pool of 2 batches of 8 images (640x1024
     canvas, 600x1000 valid) through make_cald_score_fn -> score_pool ->
     cald_select with budget 4; checks detections, consistency and the
     kernels' launch counts (K1 2 per score call: the base detect and the
     batched aug detect; K2, K3, K5 and K6 none); the f32 pyramid on the GPU
     is held against the CPU path on a small input;
  5. time: 5 warm score calls, images/s beside the card's name and power limit;
  6. training kernels: K2 (training forward, f32 output) and K3 (training
     backward) against their plain versions at the training path's shapes
     (B=4, 512 sampled rois per image, P2..P5 of the 640x1024 canvas, C=256,
     about 25% invalid slots): f32 with TF32 off (atol 1e-4; K3's atomics
     add in an order that changes from run to run) and bf16 features against
     the f32 plain versions (atol 5e-2, K3 also 1e-2 relative); invalid rois
     give exactly 0 and add nothing to the gradient; prints both times, and
     K3's on uniform rois like phase 3's (B=4, 512 per image), which overlap
     less than the training rois;
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
     beside the card's name and power limit);
  8. bottleneck kernels: K5 (one fused block per launch, chained over the
     suffix) and K6 (the suffix through its group plan) against the plain
     folded chain at R50's four stride-1 suffixes on the canvas, B=8, seeded
     folded weights: f32 with TF32 off (max abs error <= 1e-4 of the
     output's largest magnitude) and bf16 against the f32 plain version
     (mean relative error < 0.03 overall and on the border); one block with
     b1 = 1.0 (border mean < 0.02, max < 0.15 of the mean magnitude); per
     stage, K5's tile and K6's plan with their grids, the kernels' time on
     weights restaged once and through the wrappers (which restage the
     folded weights into the kernels' layout in every call), the restaging
     alone, the plain version's time and, as a yardstick the port never
     calls, the same folded blocks as three bf16 channels-last cuDNN
     convolutions with bias, ReLU and the add (``cudnn_chain_ms``);
  9. fused scoring path: a fresh R50-FPN as in phase 4 (gate off while its
     norms are calibrated), then with CALD_TPU_PALLAS_BNECK "1" and "stage":
     the pool of phase 4 scored and checked as there, launches per score
     call K1 2 and K5 24 ("1") or K6 twice its plan's groups ("stage"); the
     bf16 pyramid fused against unfused (mean relative error < 0.05, on a
     copy with the JAX test's norm statistics); the f32 fused pyramid on the
     GPU against the CPU's plain fused path (1e-3); 5 warm score calls per
     mode; backbone+FPN at B=32 four ways (unfused, plain folded chain, K5,
     K6) in turns;
 10. grouped RoIAlign kernel: K4 against its plain version at the training
     path's shapes (as phase 6) and at the CALD_TPU_ROI_FLM=0 inference
     shapes (as phase 3), g = 2 and 8 in "hi" and g = 8 in "bf16": f32
     features with TF32 off against the plain version of the same mode (atol
     1e-4 "hi", 5e-2 "bf16"), bf16 features against the plain f32 version
     (atol 5e-2); invalid rois exactly 0; K4 "hi" equal to K2 bit for bit on
     f32 and bf16 features; bf16 features, g = 8, timed in turns: K2, K4
     "hi" and K4 "bf16" at the training shapes, K4 in both modes at the
     inference shapes, each with its bound;
 11. the active-learning loop: ``cli.driver.al_loop`` on the card with
     CALD_TPU_ROI_GROUP=8: R50-FPN, 21 VOC classes, bf16, RPN 2000/2000 and
     1000/1000, samplers 256/512, from a torchvision-layout backbone that the
     phase writes first (the seeded init, frozen norms calibrated on one batch
     of the data), as users pass ImageNet weights; a synthetic VOC set of 48
     trainval and 16 test images of 375x500 written as ``.npy``; strategy
     cald with FCDR, 2 cycles of 1 epoch, batch 4, 16 initial images, budget
     8, score batch 8, evaluation every cycle, checkpoints under a temporary
     directory; checks finite losses, labeled 16 -> 24 (25 where no candidate
     has a detection: CALD's stage 2 then takes all int(1.2 * 8) candidates,
     as the reference does), a finite VOC mAP per
     cycle, ``cycle_0/`` written, one K4 and one K3 launch per training step
     and no K2 or K1 in training, one K1 per detect of evaluation and
     scoring; then one score call with CALD_TPU_ROI_FLM=0 (K4 twice, K1
     none); prints each cycle's wall time and its train/eval/score split,
     and from cycle 0's torch.profiler trace (``--profile-dir``, which slows
     that cycle) the device busy share and the kernels that took the most.

Every kernel's entry has its launches on the path that runs it (K1 phase 4,
K2 and K3 phase 7, K4 phase 11, K5 and K6 phase 9), its time (K5 and K6: on
weights restaged once; ``ms_with_restaging`` through the wrappers) and its
plain version's, its bound (the larger of its bytes over 3.35 TB/s and its
operations over the peak of their type, from this run's inputs) and
``library_ms`` null: no single PyTorch call computes RoIAlign or a
bottleneck.

The line before the last is a JSON object describing each kernel; the last is
``{"ok": true, "device": {...}}``. JAX is not imported.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor

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


# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): HBM bytes/s, bf16
# tensor-core and f32 (outside the tensor cores) operations/s
HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12
F32_OPS_S = 67e12


def bound(n_bytes: float, n_ops: float, ops_per_s: float) -> dict:
    """The least time the card could take for work that moves ``n_bytes``
    (each input read once, each output written once) and does ``n_ops``
    operations at ``ops_per_s``: the larger of the two times."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / ops_per_s
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops}


def roi_work(feats, rois, valid, levels, output_size: int = 7, sr: int = 2):
    """What a RoIAlign over these inputs must touch: (bytes of the level
    pixels that the valid rois' bilinear taps read, each once; operations,
    one multiply and one add per tap and channel: S*S*sr*sr samples x 4
    corners per valid roi)."""
    import torch

    from cald_tpu_torch.ops import roi_align as plain

    b, n = rois.shape[:2]
    c = feats[0].shape[-1]
    pyr = plain._Pyramid([f.shape for f in feats], SCALES, rois.device)
    keep = valid.reshape(-1)
    r = rois.reshape(-1, 4)[keep].float()
    lv = levels.reshape(-1)[keep].long()
    img = torch.arange(b, device=rois.device).repeat_interleave(n)[keep]
    touched = torch.zeros(b * pyr.p_total, dtype=torch.bool, device=rois.device)
    for start in range(0, r.shape[0], 1024):
        sl = slice(start, start + 1024)
        scale = pyr.scales[lv[sl]]
        x1, y1 = r[sl, 0] * scale, r[sl, 1] * scale
        rw = (r[sl, 2] * scale - x1).clamp_min(1.0)
        rh = (r[sl, 3] * scale - y1).clamp_min(1.0)
        rows, wy = plain._pooled_taps(y1, rh, pyr.hs[lv[sl]], output_size, sr, False)
        cols, wx = plain._pooled_taps(x1, rw, pyr.ws[lv[sl]], output_size, sr, False)
        m = rows.shape[0]
        idx = ((img[sl] * pyr.p_total + pyr.offs[lv[sl]])[:, None, None]
               + rows.reshape(m, -1)[:, :, None] * pyr.ws[lv[sl]].long()[:, None, None]
               + cols.reshape(m, -1)[:, None, :])
        hit = (wy.reshape(m, -1) > 0)[:, :, None] & (wx.reshape(m, -1) > 0)[:, None, :]
        touched[idx[hit]] = True
    n_ops = 2.0 * int(keep.sum()) * c * output_size ** 2 * sr ** 2 * 4
    return int(touched.sum()) * c * feats[0].element_size(), n_ops


def roi_index_bytes(rois, valid, levels) -> int:
    return rois.numel() * 4 + valid.numel() + levels.numel() * 4


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

    # the kernel is timed before and after the plain version's calls: the
    # first timing is the card's first work after the build
    k1 = lambda: roi_align_kernel(feats_bf, rois, valid, spatial_scales=scales)
    ms_first = cuda_ms(k1, 20)
    plain_ms = cuda_ms(lambda: plain.multi_scale_roi_align(
        feats_bf, rois, spatial_scales=scales, valid=valid), 5)
    ms = cuda_ms(k1, 20)
    print(f"kernel: roi_align B={BATCH} N=1000 C=256 valid={int(valid.sum())}: "
          f"f32 max_abs_err={err_f32:.3e} (atol 1e-4), bf16 max_abs_err={err_bf16:.3e} "
          f"(atol 5e-2), invalid max={max(zero_f32, zero_bf16)}; bf16 kernel {ms_first:.4f} ms "
          f"first, {ms:.4f} ms after the plain version, plain {plain_ms:.4f} ms")
    if not (err_f32 <= 1e-4 and err_bf16 <= 5e-2 and zero_f32 == 0.0 and zero_bf16 == 0.0):
        raise AssertionError("roi_align kernel disagrees with its plain version")
    levels = plain.roi_levels(rois, scales)
    level_bytes, n_ops = roi_work(feats_bf, rois, valid, levels)
    # no single PyTorch call computes RoIAlign (torchvision is not a dependency)
    return {"name": "roi_align", "route": "cuda", "source": "cald_tpu_torch/csrc/roi_align.cu",
            "replaces": "cald_tpu/ops/flm_roi_align.py:123", "max_abs_err": err_bf16,
            "max_abs_err_f32": err_f32, "ms": ms, "ms_first": ms_first, "plain_ms": plain_ms,
            "library_ms": None,
            **bound(level_bytes + got_bf.numel() * 2 + roi_index_bytes(rois, valid, levels),
                    n_ops, F32_OPS_S)}


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
    _, u_rois, u_valid = roi_inputs(device, b=TRAIN_BATCH, n=TRAIN_SAMPLES, c=1)
    u_levels = plain.roi_levels(u_rois, SCALES).contiguous()
    bwd_uniform_ms = cuda_ms(lambda: roi_align_bwd_kernel(
        cot, u_rois, u_valid, u_levels, shapes, spatial_scales=SCALES), 20)
    print(f"train kernels: B={TRAIN_BATCH} S={TRAIN_SAMPLES} C=256 valid={int(valid.sum())}: "
          f"K2 f32 max_abs_err={fwd_f32:.3e} (atol 1e-4), bf16 {fwd_bf16:.3e} (atol 5e-2); "
          f"K3 f32 max_abs_err={bwd_f32:.3e} (atol 1e-4), bf16 {bwd_bf16:.3e} (atol 5e-2 + "
          f"1e-2 rel); invalid out max={zero}, invalid-only gradient max={dead_max}")
    print(f"train kernels: K2 bf16 {fwd_ms:.4f} ms, plain {fwd_plain_ms:.4f} ms; "
          f"K3 {bwd_ms:.4f} ms, plain {bwd_plain_ms:.4f} ms; K3 on uniform rois "
          f"{bwd_uniform_ms:.4f} ms")
    if not (fwd_f32 <= 1e-4 and fwd_bf16 <= 5e-2 and bwd_f32 <= 1e-4 and bwd_bf16_ok
            and zero == 0.0 and dead_max == 0.0):
        raise AssertionError("a training RoIAlign kernel disagrees with its plain version")
    src = "cald_tpu_torch/csrc/roi_align.cu"
    level_bytes, n_ops = roi_work(feats_bf, rois, valid, levels)
    index_bytes = roi_index_bytes(rois, valid, levels)
    fwd_bound = bound(level_bytes + got.numel() * 4 + index_bytes, n_ops, F32_OPS_S)
    # K3 reads grad_out (f32) and writes every level's f32 gradient
    bwd_bound = bound(cot.numel() * 4 + sum(g.numel() * 4 for g in got_g) + index_bytes,
                      n_ops, F32_OPS_S)
    return [{"name": "roi_align_train_fwd", "route": "cuda", "source": src,
             "replaces": "cald_tpu/ops/pallas_roi_align.py:132", "max_abs_err": fwd_bf16,
             "max_abs_err_f32": fwd_f32, "ms": fwd_ms, "plain_ms": fwd_plain_ms,
             "library_ms": None, **fwd_bound},
            {"name": "roi_align_bwd", "route": "cuda", "source": src,
             "replaces": "cald_tpu/ops/pallas_roi_align.py:534", "max_abs_err": bwd_bf16,
             "max_abs_err_f32": bwd_f32, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
             "ms_uniform_rois": bwd_uniform_ms, "library_ms": None, **bwd_bound}]


# the gains of tests/test_golden_parity.py, so that a random detector's scores
# and boxes spread out (scoring); training starts from the init as it is
HEAD_GAINS = {"rpn_head.objectness": 60.0, "rpn_head.deltas": 8.0, "rpn_head.conv": 3.0,
              "box_predictor.cls_score": 35.0, "box_predictor.bbox_pred": 15.0}


def amplify_heads_(model) -> None:
    import torch

    with torch.no_grad():
        for name, m in model.named_modules():
            if name in HEAD_GAINS:
                m.weight.mul_(HEAD_GAINS[name])


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
    from cald_tpu_torch.models.init import random_init_

    cfg = FasterRCNNConfig(num_classes=NUM_CLASSES, backbone=backbone,
                           compute_dtype=compute_dtype)
    model = FasterRCNN(cfg).eval()
    random_init_(model, SEED)
    if amplify_heads:
        amplify_heads_(model)
    model.to(device)
    calib = make_pool(BATCH, seed=SEED + 1)[0]
    calibrate_norms_(model, torch.from_numpy(calib.images[:2]).to(device),
                     torch.from_numpy(calib.valid_hw[:2]).to(device))
    return model


def reference_check(model, device, allow_fused: bool = False, label: str = "reference") -> float:
    """The f32 pyramid on the GPU against the CPU path of the same weights
    on a small input (TF32 off); returns the max relative error. With
    ``allow_fused`` and the gate set, the GPU runs the fused kernels and the
    CPU their plain versions."""
    import torch

    from cald_tpu_torch.models.faster_rcnn import FasterRCNN

    f32 = FasterRCNN(dataclasses.replace(model.cfg, compute_dtype="float32"))
    f32.load_state_dict(model.state_dict())
    f32.eval()
    images = torch.from_numpy(make_pool(BATCH, seed=SEED + 2)[0].images[:2, :128, :192].copy())
    hw = torch.tensor([[128, 192], [100, 150]], dtype=torch.int32)
    with torch.inference_mode():
        want = f32.features(images, hw, allow_fused=allow_fused)
    f32.to(device)
    with torch.inference_mode():
        got = f32.features(images.to(device), hw.to(device), allow_fused=allow_fused)
    err = max(((g.cpu() - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want))
    print(f"{label}: f32 pyramid GPU vs CPU on 2x128x192, max relative error {err:.3e} "
          f"(limit 1e-3)")
    if not err <= 1e-3:
        raise AssertionError("GPU pyramid disagrees with the CPU path")
    return err


def main_path(model, device, kernels: dict, expect: dict, n_batches: int = N_BATCHES,
              label: str = "main path"):
    """Score a pool and select, checking the results; returns (score_fn,
    pool, launches). ``kernels`` maps each kernel's name to its wrapper and
    ``expect`` gives its launches per score call (0 where absent); every
    count is set to 0 just before the scoring and read just after."""
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
        for k in kernels.values():
            k.launches = 0
        consistency, cls_corrs = score_pool(score_fn, pool, list(range(BATCH * n_batches)),
                                            gen)
        launches = {name: k.launches for name, k in kernels.items()}
    finally:
        del model.detect

    want = {name: expect.get(name, 0) * n_batches for name in kernels}
    labeled_mean = np.random.default_rng(SEED).uniform(0, 2, NUM_CLASSES - 1)
    selected = cald_select(consistency, cls_corrs, labeled_mean, BUDGET, cfg)
    base_dets, aug_dets = float(np.mean(counts["base"])), float(np.mean(counts["aug"]))
    print(f"{label}: {n_batches} batches x {BATCH} images, canvas {CANVAS}, valid "
          f"{VALID_HW}: mean valid detections base {base_dets:.2f}, aug {aug_dets:.2f}")
    print(f"{label}: consistency {np.array2string(consistency, precision=4)}")
    print(f"{label}: selected {selected.tolist()}; launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{label}: the kernels' launch counts are not the expected ones")
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


# R50's stride-1 suffixes on the canvas: (stage, H, W, C, P, blocks)
R50_SUFFIXES = [("layer1", 160, 256, 256, 64, 2), ("layer2", 80, 128, 512, 128, 3),
                ("layer3", 40, 64, 1024, 256, 5), ("layer4", 20, 32, 2048, 512, 2)]


def folded_blocks(c: int, p: int, n: int, device, seed: int, b1=None):
    """Seeded folded blocks in the port's layouts (kaiming-scaled, so the
    activations stay of order 1 through a chain)."""
    import torch

    rng = np.random.default_rng(seed)
    mk = lambda std, *s: torch.from_numpy(rng.normal(0, std, s).astype(np.float32)).to(device)
    return [(mk(c ** -0.5, p, c),
             mk(0.1, p) if b1 is None else torch.full((p,), b1, device=device),
             mk((9 * p) ** -0.5, p, p, 3, 3), mk(0.1, p), mk(0.5 * p ** -0.5, c, p),
             mk(0.1, c)) for _ in range(n)]


def _border(t):
    import torch

    return torch.cat([t[:, :, 0].flatten(), t[:, :, -1].flatten(), t[:, :, :, 0].flatten(),
                      t[:, :, :, -1].flatten()])


def cudnn_chain(x, blocks):
    """The yardstick of phase 8, never called by the port: each folded block
    as three cuDNN convolutions in x's dtype, channels-last, with bias, ReLU
    and the identity add."""
    import torch.nn.functional as F

    for w1, b1, w2, b2, w3, b3 in blocks:
        y = F.relu(F.conv2d(x, w1, b1))
        y = F.relu(F.conv2d(y, w2, b2, padding=1))
        x = F.relu(F.conv2d(y, w3, b3) + x)
    return x


def bottleneck_kernel_phase(device, card: str) -> list[dict]:
    """K5 and K6 against their plain versions at R50's four suffixes, B=8
    (phase 8)."""
    import torch

    from cald_tpu_torch.ops import bottleneck as plain
    from cald_tpu_torch.ops.bottleneck_cuda import (
        _kernel_weights, fused_block_kernel, fused_stage_kernel,
    )

    def k5_chain(x, blocks):
        for b in blocks:
            x = fused_block_kernel(x, b)
        return x

    rows = {"K5": [], "K6": []}
    for stage, h, w, c, p, n in R50_SUFFIXES:
        rng = np.random.default_rng(SEED + h)
        x = torch.from_numpy(np.abs(rng.normal(0, 1, (BATCH, c, h, w))).astype(np.float32))
        x = x.to(device).contiguous(memory_format=torch.channels_last)
        blocks = folded_blocks(c, p, n, device, SEED + h)
        want = plain.fused_stage(x, blocks)
        xb = x.bfloat16()
        scale, top = want.abs().mean().item(), want.abs().max().item()
        plain_ms = cuda_ms(lambda: plain.fused_stage(xb, blocks), 3)
        tile = plain.block_tile(h, w, c, p, 2)
        plan = plain.stage_plan(h, w, c, p, n, 2)
        grid = lambda th, tw: math.ceil(h / th) * math.ceil(w / tw) * BATCH
        # the kernels alone, on weights restaged once (the wrappers restage
        # them in every call, once per block per detect)
        starts = [sum(t[0] for t in plan[:k]) for k in range(len(plan))]
        restage = {"K5": lambda: [_kernel_weights(xb, [b], "K5") for b in blocks],
                   "K6": lambda: [_kernel_weights(xb, blocks[j: j + g], "K6")
                                  for j, (g, _, _) in zip(starts, plan)]}
        k5w, k6w = restage["K5"](), restage["K6"]()

        def k5_staged():
            y = xb
            for wt in k5w:
                y = fused_block_kernel.launch_staged(y, wt, *tile)
            return y

        def k6_staged():
            y = xb
            for (g, th, tw), wt in zip(plan, k6w):
                y = fused_stage_kernel.launch_staged(y, wt, th, tw, g)
            return y

        cb = [tuple(t.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
                    if t.dim() == 4 else t.to(torch.bfloat16)
                    for t in (w1[:, :, None, None], b1, w2, b2, w3[:, :, None, None], b3))
              for w1, b1, w2, b2, w3, b3 in blocks]
        with torch.inference_mode():
            cudnn_ms = cuda_ms(lambda: cudnn_chain(xb, cb), 10)
        # each block: 1x1 C->P, 3x3 P->P, 1x1 P->C, a multiply and an add per MAC;
        # bytes: the bf16 input and output once, the f32 folded weights once
        stage_ops = 2.0 * BATCH * h * w * (c * p + 9 * p * p + p * c) * n
        stage_bytes = 2 * xb.numel() * 2 + sum(t.numel() * 4 for blk in blocks for t in blk)
        for name, fn, staged in (("K5", k5_chain, k5_staged), ("K6", fused_stage_kernel, k6_staged)):
            got32 = fn(x, blocks)
            gotb = fn(xb, blocks).float()
            torch.cuda.synchronize()
            err32 = (got32 - want).abs().max().item()
            d = gotb - want
            row = {"stage": stage, "f32_max_abs_err": err32, "f32_rel": err32 / top,
                   "bf16_max_abs_err": d.abs().max().item(),
                   "bf16_mean_rel": d.abs().mean().item() / scale,
                   "bf16_border_mean_rel": _border(d).abs().mean().item() / scale,
                   "ms": cuda_ms(staged, 10), "ms_with_restaging": cuda_ms(lambda: fn(xb, blocks), 10),
                   "restage_ms": cuda_ms(restage[name], 10), "plain_ms": plain_ms,
                   "cudnn_chain_ms": cudnn_ms, "ops": stage_ops, "bytes": stage_bytes}
            if name == "K5":
                row["tile"], row["grid"] = tile, grid(*tile)
            else:
                row["plan"], row["grid"] = plan, [grid(th, tw) for _, th, tw in plan]
            rows[name].append(row)
            print(f"bottleneck {name} {stage} B={BATCH} {h}x{w} C={c} P={p} blocks={n} "
                  f"{'tile ' + str(tile) if name == 'K5' else 'plan (g, th, tw) ' + str(plan)} "
                  f"grid {row['grid']}: f32 max_abs_err "
                  f"{err32:.3e} ({row['f32_rel']:.2e} of max {top:.3g}, limit 1e-4); bf16 "
                  f"mean rel {row['bf16_mean_rel']:.4f}, border {row['bf16_border_mean_rel']:.4f} "
                  f"(limit 0.03); bf16 kernel {row['ms']:.4f} ms, with restaging "
                  f"{row['ms_with_restaging']:.4f} ms (restaging alone {row['restage_ms']:.4f}), "
                  f"cuDNN chain {cudnn_ms:.4f} ms, plain {plain_ms:.4f} ms on {card}")
            if not (row["f32_rel"] <= 1e-4 and row["bf16_mean_rel"] < 0.03
                    and row["bf16_border_mean_rel"] < 0.03):
                raise AssertionError(f"bottleneck {name} disagrees with its plain version at {stage}")
        del x, xb, want, got32, gotb, d, k5w, k6w, cb

    # the halo-bias case: b1 = 1.0 must not leak relu(b1) into the border
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(np.abs(rng.normal(0, 1, (1, 256, 16, 32))).astype(np.float32))
    x = x.to(device).contiguous(memory_format=torch.channels_last)
    blk = folded_blocks(256, 64, 1, device, SEED, b1=1.0)[0]
    want = plain.fused_block(x, blk)
    scale = want.abs().mean().item()
    for name, got in (("K5", fused_block_kernel(x.bfloat16(), blk)),
                      ("K6", fused_stage_kernel(x.bfloat16(), [blk]))):
        border = _border(got.float() - want).abs()
        mean, worst = border.mean().item() / scale, border.max().item() / scale
        print(f"bottleneck {name} b1=1.0 border: mean {mean:.4f} (limit 0.02), max {worst:.4f} "
              f"(limit 0.15)")
        if not (mean < 0.02 and worst < 0.15):
            raise AssertionError(f"bottleneck {name}: the zero halo leaks relu(b1)")
        rows[name].append({"stage": "b1=1.0", "border_mean_rel": mean, "border_max_rel": worst})

    src = "cald_tpu_torch/csrc/bottleneck.cu"
    out = []
    for name, kname, line in (("K5", "bottleneck_block", 59), ("K6", "bottleneck_stage", 218)):
        st = [r for r in rows[name] if "ms" in r]
        out.append({"name": kname, "route": "cuda", "source": src,
                    "replaces": f"cald_tpu/ops/pallas_bottleneck.py:{line}",
                    "max_abs_err": max(r["bf16_max_abs_err"] for r in st),
                    "max_abs_err_f32": max(r["f32_max_abs_err"] for r in st),
                    "bf16_mean_rel": max(r["bf16_mean_rel"] for r in st),
                    "ms": sum(r["ms"] for r in st), "plain_ms": sum(r["plain_ms"] for r in st),
                    "ms_with_restaging": sum(r["ms_with_restaging"] for r in st),
                    "restage_ms": sum(r["restage_ms"] for r in st),
                    "cudnn_chain_ms": sum(r["cudnn_chain_ms"] for r in st),
                    "library_ms": None,   # no single PyTorch call computes a bottleneck
                    **bound(sum(r["bytes"] for r in st), sum(r["ops"] for r in st), BF16_OPS_S),
                    "per_stage": rows[name]})
    return out


def fused_counts() -> dict:
    """K5 and K6 launches per detect of R50 on the canvas in bf16: one K5
    per suffix block; one K6 per group of each suffix's plan."""
    from cald_tpu_torch.ops.bottleneck import stage_plan

    return {"bottleneck_block": sum(n for *_, n in R50_SUFFIXES),
            "bottleneck_stage": sum(len(stage_plan(h, w, c, p, n, 2))
                                    for _, h, w, c, p, n in R50_SUFFIXES)}


def fused_path(device, kernels: dict, card: str) -> dict:
    """The fused scoring path (phase 9), CALD_TPU_PALLAS_BNECK = "1" then
    "stage" on a detector built with the gate off; returns each mode's
    launches and times."""
    from unittest import mock

    import torch

    from cald_tpu_torch.augment.suite import generator_draw
    from cald_tpu_torch.models import resnet
    from cald_tpu_torch.models.faster_rcnn import FasterRCNN
    from cald_tpu_torch.models.layers import FrozenBatchNorm
    from cald_tpu_torch.ops import bottleneck as plain

    model = build_model(device)
    per_detect = fused_counts()
    batch = make_pool(BATCH, seed=SEED + 4)[0]
    images = torch.from_numpy(batch.images).to(device)
    valid_hw = torch.from_numpy(batch.valid_hw).to(device)
    # The calibrated random R50 amplifies rounding: its bf16 pyramid is far
    # from its own f32 pyramid, fused or not, so the fused-vs-unfused bound
    # is held on a copy with the norm statistics of the JAX package's test
    # (tests/test_pallas_bottleneck.py: every statistic normal(1, 0.1)), and
    # the smoke model's own errors against f32 are printed beside it.
    cond = FasterRCNN(model.cfg)
    cond.load_state_dict(model.state_dict())
    cond.eval().to(device)
    gen = torch.Generator().manual_seed(SEED + 6)
    with torch.no_grad():
        for m in cond.modules():
            if isinstance(m, FrozenBatchNorm):
                for buf in (m.scale, m.bias, m.mean, m.var):
                    buf.copy_(torch.normal(1.0, 0.1, buf.shape, generator=gen))
    f32 = FasterRCNN(dataclasses.replace(model.cfg, compute_dtype="float32"))
    f32.load_state_dict(model.state_dict())
    f32.eval().to(device)
    rel = lambda got, want: [((g.float() - w.float()).abs().mean() / w.float().abs().mean()).item()
                             for g, w in zip(got, want)]
    with torch.inference_mode():
        unfused, unfused_cond = model.features(images, valid_hw), cond.features(images, valid_hw)
        ref32 = f32.features(images, valid_hw)
    del f32
    result = {}
    for mode, kname in (("1", "bottleneck_block"), ("stage", "bottleneck_stage")):
        os.environ["CALD_TPU_PALLAS_BNECK"] = mode
        label = f"fused path {mode!r}"
        score_fn, pool, launches = main_path(
            model, device, kernels, {"roi_align": 2, kname: 2 * per_detect[kname]},
            label=label)
        with torch.inference_mode():
            fused = model.features(images, valid_hw, allow_fused=True)
            fused_cond = cond.features(images, valid_hw, allow_fused=True)
        err = rel(fused_cond, unfused_cond)
        print(f"{label}: bf16 pyramid fused vs unfused (JAX-test norm statistics), mean "
              f"relative error per level {[f'{r:.4f}' for r in err]} (limit 0.05); smoke model "
              f"against its f32 pyramid: fused {[f'{r:.3f}' for r in rel(fused, ref32)]}, "
              f"unfused {[f'{r:.3f}' for r in rel(unfused, ref32)]}")
        if not max(err) < 0.05:
            raise AssertionError(f"{label}: the fused pyramid disagrees with the unfused one")
        reference_check(model, device, allow_fused=True, label=label)
        draw = generator_draw(torch.Generator(device=device).manual_seed(SEED + 3))
        reps = 5
        score_fn(images, valid_hw, draw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            score_fn(images, valid_hw, draw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"{label} time: {reps} warm score calls of B={BATCH}: {dt / reps * 1e3:.1f} "
              f"ms/call, {reps * BATCH / dt:.2f} images/s on {card}")
        result[mode] = {"launches": launches[kname], "ms_per_call": dt / reps * 1e3,
                        "images_per_s": reps * BATCH / dt}
        del score_fn, pool

    # backbone + FPN alone at B=32, four ways, in turns (ABCD DCBA)
    big = make_pool(4 * BATCH, seed=SEED + 5, batch=4 * BATCH)[0]
    im32 = torch.from_numpy(big.images).to(device)
    hw32 = torch.from_numpy(big.valid_hw).to(device)

    def backbone_ms(mode: str, plain_chain: bool = False) -> float:
        os.environ["CALD_TPU_PALLAS_BNECK"] = mode
        with mock.patch.object(resnet, "fused_stage_kernel",
                               plain.fused_stage if plain_chain else resnet.fused_stage_kernel):
            with torch.inference_mode():
                return cuda_ms(lambda: model.features(im32, hw32, allow_fused=True), 5)

    ways = {"unfused": ("", False), "plain folded chain": ("stage", True), "K5": ("1", False),
            "K6": ("stage", False)}
    times = {k: [] for k in ways}
    for name in [*ways, *reversed(ways)]:
        times[name].append(backbone_ms(*ways[name]))
    os.environ.pop("CALD_TPU_PALLAS_BNECK", None)
    print(f"fused backbone+FPN at B={4 * BATCH} (CUDA events, mean of 5, two turns): " + "; ".join(
        f"{k} {v[0]:.2f} / {v[1]:.2f} ms" for k, v in times.items()) + f" on {card}")
    result["backbone_ms"] = times
    del model, cond
    torch.cuda.empty_cache()
    return result


def group_kernel_phase(device, card: str) -> dict:
    """K4 against its plain version (phase 10) at the training path's shapes
    and at the CALD_TPU_ROI_FLM=0 inference shapes; K4 "hi" against K2 bit
    for bit; K2 and K4 in both modes timed in turns."""
    import torch

    from cald_tpu_torch.ops import roi_align as plain
    from cald_tpu_torch.ops.roi_align_cuda import (
        roi_align_group_fwd_kernel, roi_align_train_fwd_kernel,
    )

    worst = {"f32": 0.0, "bf16_mode": 0.0, "bf16_features": 0.0}
    shapes = {"train": (f"train B={TRAIN_BATCH} S={TRAIN_SAMPLES}", train_roi_inputs),
              "flm0": (f"FLM=0 inference B={BATCH} N=1000", roi_inputs)}
    timed = {}
    for key, (label, make) in shapes.items():
        feats, rois, valid = make(device)
        levels = plain.roi_levels(rois, SCALES).contiguous()
        feats_bf = [f.bfloat16() for f in feats]
        want_f32 = plain.grouped_multi_scale_roi_align(
            feats, rois, spatial_scales=SCALES, g=8, valid=valid, levels=levels)
        for g, hi in ((2, True), (8, True), (8, False)):
            k4 = lambda fs: roi_align_group_fwd_kernel(fs, rois, valid, levels, g=g, hi_prec=hi,
                                                       spatial_scales=SCALES)
            want = want_f32 if hi else plain.grouped_multi_scale_roi_align(
                feats, rois, spatial_scales=SCALES, g=g, hi_prec=False, valid=valid,
                levels=levels)
            got, got_bf = k4(feats), k4(feats_bf)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            err_bf = (got_bf - want_f32).abs().max().item()
            zero = max(got[~valid].abs().max().item(), got_bf[~valid].abs().max().item())
            mode = "hi" if hi else "bf16"
            tol = 1e-4 if hi else 5e-2
            print(f"group kernel: {label} g={g} {mode}: f32 features max_abs_err={err:.3e} "
                  f"against the plain {mode} mode (atol {tol:g}), bf16 features {err_bf:.3e} "
                  f"against the plain f32 version (atol 5e-2), invalid max={zero}")
            if not (err <= tol and err_bf <= 5e-2 and zero == 0.0):
                raise AssertionError(f"K4 disagrees with its plain version ({label}, g={g}, {mode})")
            worst["f32" if hi else "bf16_mode"] = max(worst["f32" if hi else "bf16_mode"], err)
            worst["bf16_features"] = max(worst["bf16_features"], err_bf)
        # "hi" is K2's instantiation: K2's output bit for bit
        for name, fs in (("f32", feats), ("bf16", feats_bf)):
            same = torch.equal(roi_align_group_fwd_kernel(fs, rois, valid, levels, g=8,
                                                          hi_prec=True, spatial_scales=SCALES),
                               roi_align_train_fwd_kernel(fs, rois, valid, levels,
                                                          spatial_scales=SCALES))
            print(f"group kernel: {label} g=8 hi equals K2 bit for bit on {name} features: {same}")
            if not same:
                raise AssertionError(f"K4 hi differs from K2 ({label}, {name} features)")

        # bf16 features, g = 8 (phase 11's group): K2 and K4 in both modes in turns
        del feats
        fns = {"K4": lambda: roi_align_group_fwd_kernel(feats_bf, rois, valid, levels, g=8,
                                                        hi_prec=True, spatial_scales=SCALES),
               "K4 bf16 mode": lambda: roi_align_group_fwd_kernel(
                   feats_bf, rois, valid, levels, g=8, hi_prec=False, spatial_scales=SCALES)}
        if key == "train":
            fns = {"K2": lambda: roi_align_train_fwd_kernel(feats_bf, rois, valid, levels,
                                                            spatial_scales=SCALES), **fns}
        times = {k: [] for k in fns}
        for name in [*fns, *reversed(fns)]:
            times[name].append(cuda_ms(fns[name], 20))
        level_bytes, n_ops = roi_work(feats_bf, rois, valid, levels)
        out_bytes = rois.shape[0] * rois.shape[1] * 49 * feats_bf[0].shape[-1] * 4
        timed[key] = {"times": times, **bound(level_bytes + out_bytes
                                              + roi_index_bytes(rois, valid, levels), n_ops,
                                              F32_OPS_S)}
        if key == "train":
            timed[key]["plain_ms"] = cuda_ms(lambda: plain.grouped_multi_scale_roi_align(
                feats_bf, rois, spatial_scales=SCALES, g=8, valid=valid, levels=levels), 3)
        print(f"group kernel time, {label} bf16 g=8 (CUDA events, mean of 20, in turns "
              f"{' '.join([*fns, *reversed(fns)])}): " + "; ".join(
                  f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in times.items())
              + f"; bound {timed[key]['bound_ms']:.4f} ms ({timed[key]['bound_by']})"
              + (f"; plain K4 {timed[key]['plain_ms']:.4f} ms" if key == "train" else "")
              + f" on {card}")
        del feats_bf

    train, flm0 = timed["train"], timed["flm0"]
    mean = lambda v: sum(v) / len(v)
    return {"name": "roi_align_group_fwd", "route": "cuda",
            "source": "cald_tpu_torch/csrc/roi_align.cu",
            "replaces": "cald_tpu/ops/pallas_roi_align.py:323",
            "max_abs_err": worst["bf16_features"], "max_abs_err_f32": worst["f32"],
            "max_abs_err_bf16_mode": worst["bf16_mode"], "ms": mean(train["times"]["K4"]),
            "ms_bf16_mode": mean(train["times"]["K4 bf16 mode"]), "plain_ms": train["plain_ms"],
            "k2_ms_in_turns": train["times"]["K2"], "k4_ms_in_turns": train["times"]["K4"],
            "k4_bf16_mode_ms_in_turns": train["times"]["K4 bf16 mode"],
            "ms_flm0": mean(flm0["times"]["K4"]),
            "ms_flm0_bf16_mode": mean(flm0["times"]["K4 bf16 mode"]),
            "bound_ms_flm0": flm0["bound_ms"], "bound_by_flm0": flm0["bound_by"],
            "library_ms": None,
            **{k: train[k] for k in ("bound_ms", "bound_by", "bound_bytes", "bound_ops")}}


def trace_summary(path: str, top: int = 6) -> dict:
    """Device time in a torch.profiler chrome trace: the union of the CUDA
    kernels' intervals over the span of all traced events (the busy share),
    and the kernels that took the most time."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") == "kernel")
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    busy, end = 0.0, -math.inf
    for a, b, _ in kernels:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name: dict = {}
    for a, b, name in kernels:
        by_name[name[:80]] = by_name.get(name[:80], 0.0) + (b - a) / 1e3
    return {"span_ms": span / 1e3, "kernel_ms": busy / 1e3, "busy_share": busy / span,
            "launches": len(kernels),
            "top_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])}


AL_TRAIN_IMAGES = 48
AL_TEST_IMAGES = 16
AL_IMAGE_HW = (375, 500)         # a typical VOC image


def al_loop_phase(device, kernels: dict, card: str, workdir: str) -> dict:
    """The active-learning loop on the card (phase 11): R50-FPN trained from
    a torchvision-layout backbone written here, CALD_TPU_ROI_GROUP=8, two
    cycles on a synthetic VOC set; launch counts per stage; one score call
    with CALD_TPU_ROI_FLM=0."""
    import torch

    from cald_tpu_torch.cli import driver
    from cald_tpu_torch.cli.config import ALConfig
    from cald_tpu_torch.convert.torchvision_import import backbone_state_dict
    from cald_tpu_torch.data.batching import create_aspect_ratio_groups, default_canvases
    from cald_tpu_torch.data.synthetic import make_learnable_voc
    from cald_tpu_torch.data.voc import get_voc2007
    from cald_tpu_torch.engine.checkpoint import load_checkpoint
    from cald_tpu_torch.models.init import random_init_
    from cald_tpu_torch.strategies.cald import CALDConfig, make_cald_score_fn, score_pool

    train_root = make_learnable_voc(os.path.join(workdir, "train"), AL_TRAIN_IMAGES,
                                    AL_IMAGE_HW, seed=SEED, image_format="npy")
    test_root = make_learnable_voc(os.path.join(workdir, "test"), AL_TEST_IMAGES, AL_IMAGE_HW,
                                   seed=SEED + 1, image_format="npy")
    datasets = (get_voc2007(train_root, "trainval"), get_voc2007(test_root, "test"))
    cfg = ALConfig(data_path=train_root, strategy="cald", augs="FCDR", cycles=2, epochs=1,
                   batch_size=TRAIN_BATCH, init_num=16, budget_num=8, score_batch_size=BATCH,
                   workers=4, print_freq=1, output_dir=os.path.join(workdir, "out"),
                   profile_dir=os.path.join(workdir, "profile"),
                   pretrained_backbone=os.path.join(workdir, "backbone.pt"),
                   device=device.type).resolve()

    # the backbone users would pass as ImageNet weights: the seeded init with
    # its frozen norms calibrated on one batch of this data (phases 4 and 7)
    num_classes = len(datasets[0].class_names)
    model, _ = driver.build_model(cfg, num_classes)
    random_init_(model, cfg.seed)
    model.to(device)
    canvases = default_canvases(cfg.min_size, cfg.max_size)
    groups = create_aspect_ratio_groups(datasets[0].aspect_ratios(),
                                        cfg.aspect_ratio_group_factor)
    calib = next(iter(driver._loaders(cfg, datasets[0], range(TRAIN_BATCH),
                                      batch_size=TRAIN_BATCH, train=False, canvases=canvases,
                                      group_ids=groups)))
    calibrate_norms_(model, torch.from_numpy(calib.images).to(device),
                     torch.from_numpy(calib.valid_hw).to(device))
    torch.save(backbone_state_dict(model), cfg.pretrained_backbone)
    del model

    # launches by stage: training, evaluation, scoring
    stage_counts = {"train": [], "eval": [], "score": []}
    steps, detects, losses = [], [], []

    def counted(stage, fn):
        def run(*args, **kwargs):
            before = {k: v.launches for k, v in kernels.items()}
            out = fn(*args, **kwargs)
            stage_counts[stage].append({k: v.launches - before[k] for k, v in kernels.items()})
            return out
        return run

    orig_epoch, orig_detect = driver.train_one_epoch, driver.FasterRCNN.detect

    def epoch_counting(step_fn, *args, **kwargs):
        def step(*a):
            m = step_fn(*a)
            losses.append({k: float(v) for k, v in m.items()})
            steps.append(1)
            return m
        return orig_epoch(step, *args, **kwargs)

    def detect_counting(self, images, valid_hw):
        detects.append(images.shape[0])
        return orig_detect(self, images, valid_hw)

    os.environ["CALD_TPU_ROI_GROUP"] = "8"
    patches = {"train_cycle": counted("train", driver.train_cycle),
               "evaluate": counted("eval", driver.evaluate),
               "score_and_select": counted("score", driver.score_and_select),
               "train_one_epoch": epoch_counting}
    saved = {k: getattr(driver, k) for k in patches}
    for k, v in patches.items():
        setattr(driver, k, v)
    driver.FasterRCNN.detect = detect_counting
    try:
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        history = driver.al_loop(cfg, datasets=datasets)
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
    finally:
        for k, v in saved.items():
            setattr(driver, k, v)
        driver.FasterRCNN.detect = orig_detect
    n_detect = len(detects)

    trace = trace_summary(os.path.join(cfg.profile_dir, "cycle_0_trace.json"))
    print(f"al loop: cycle 0 under torch.profiler: {trace['kernel_ms']:.1f} ms of kernels in a "
          f"{trace['span_ms']:.1f} ms trace, device busy share {trace['busy_share']:.4f}, "
          f"{trace['launches']} kernels; the most time: " + "; ".join(
              f"{v:.2f} ms {k}" for k, v in trace["top_ms"].items()))
    for h in history:
        print(f"al loop: cycle {h['cycle']}: labeled {h['labeled']}, mAP {h['eval']['mAP']:.4f}, "
              f"AP50 {h['eval']['AP50']:.4f}; wall {h['time_s']:.2f} s (train "
              f"{h['split_s']['train']:.2f}, eval {h['split_s']['eval']:.2f}, score "
              f"{h['split_s']['score']:.2f}) on {card}")
    print(f"al loop: {len(steps)} training steps, {n_detect} detects; launches by stage "
          f"{json.dumps(stage_counts)}; total {launches}; {wall:.2f} s")
    train_k = {k: sum(c[k] for c in stage_counts["train"]) for k in kernels}
    infer_k = {k: sum(c[k] for st in ("eval", "score") for c in stage_counts[st])
               for k in kernels}
    if not (len(steps) > 0 and train_k["roi_align_group_fwd"] == len(steps)
            and train_k["roi_align_bwd"] == len(steps) and train_k["roi_align_train_fwd"] == 0
            and train_k["roi_align"] == 0):
        raise AssertionError(f"training did not launch K4 and K3 once per step without K2: {train_k}")
    if not (infer_k["roi_align"] == n_detect and infer_k["roi_align_group_fwd"] == 0
            and infer_k["roi_align_train_fwd"] == 0):
        raise AssertionError(f"evaluation and scoring did not launch K1 once per detect: {infer_k}")
    if not all(math.isfinite(v) for d in losses for v in d.values()):
        raise AssertionError("non-finite training losses")
    # CALD's stage 2 (the reference's cls_kldiv) takes every candidate without
    # detections first, so a detector that finds nothing takes all
    # int(mr * budget) candidates: 9 for a budget of 8
    picked = history[0]["labeled"] - cfg.init_num
    if not (cfg.budget_num <= picked <= int(cfg.mr * cfg.budget_num)
            and history[1]["labeled"] == history[0]["labeled"]):
        raise AssertionError(f"the labeled set did not grow by the budget: {history}")
    if not all(math.isfinite(h["eval"]["mAP"]) for h in history):
        raise AssertionError("non-finite VOC mAP")
    ckpt = os.path.join(cfg.output_dir, "cycle_0")
    if not os.path.isfile(os.path.join(ckpt, "model.pt")):
        raise AssertionError("cycle_0/ was not written")

    # one score call through the window path: CALD_TPU_ROI_FLM=0, group 8
    model, _ = driver.build_model(cfg, num_classes)
    model.to(device)
    load_checkpoint(ckpt, model)
    score_fn = make_cald_score_fn(model, CALDConfig(), num_classes)
    batch = next(iter(driver._loaders(cfg, datasets[0], range(BATCH), batch_size=BATCH,
                                      train=False, canvases=canvases, group_ids=groups)))
    os.environ["CALD_TPU_ROI_FLM"] = "0"
    try:
        for k in kernels.values():
            k.launches = 0
        cons, _ = score_pool(score_fn, [batch], list(batch.image_idx),
                             torch.Generator(device=device).manual_seed(SEED))
        flm0 = {name: k.launches for name, k in kernels.items()}
    finally:
        os.environ.pop("CALD_TPU_ROI_FLM")
        os.environ.pop("CALD_TPU_ROI_GROUP")
    print(f"al loop: one score call with CALD_TPU_ROI_FLM=0: launches {flm0}, consistency "
          f"{np.array2string(cons, precision=4)}")
    if flm0["roi_align_group_fwd"] != 2 or flm0["roi_align"] != 0 or not np.isfinite(cons).all():
        raise AssertionError("CALD_TPU_ROI_FLM=0 scoring did not run K4 twice without K1")
    return {"history": history, "launches": launches, "steps": len(steps), "wall_s": wall,
            "trace": trace}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; there is no CPU path", file=sys.stderr)
        return 2
    from cald_tpu_torch.augment.suite import generator_draw
    from cald_tpu_torch.ops.bottleneck_cuda import fused_block_kernel, fused_stage_kernel
    from cald_tpu_torch.ops.roi_align_cuda import (
        roi_align_bwd_kernel, roi_align_group_fwd_kernel, roi_align_kernel,
        roi_align_train_fwd_kernel,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for gate in ("CALD_TPU_PALLAS_BNECK", "CALD_TPU_ROI_GROUP", "CALD_TPU_ROI_GROUP_PREC",
                 "CALD_TPU_ROI_FLM"):
        os.environ.pop(gate, None)        # phases 9-11 set the gates themselves
    device = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"card: torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    kernels = (roi_align_kernel, roi_align_train_fwd_kernel, roi_align_bwd_kernel)
    all_kernels = {"roi_align": roi_align_kernel, "roi_align_train_fwd": roi_align_train_fwd_kernel,
                   "roi_align_bwd": roi_align_bwd_kernel,
                   "roi_align_group_fwd": roi_align_group_fwd_kernel,
                   "bottleneck_block": fused_block_kernel, "bottleneck_stage": fused_stage_kernel}
    # one nvcc per source, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        built = list(ex.map(lambda k: (k.load(), time.perf_counter() - t0),
                              (roi_align_kernel, fused_block_kernel)))
    for k in all_kernels.values():
        k.load()
    print(f"build: roi_align kernels (K1, K2, K3, K4) ready in {built[0][1]:.2f} s, bottleneck "
          f"kernels (K5, K6) in {built[1][1]:.2f} s")

    kernel = kernel_phase(device)

    model = build_model(device)
    reference_check(model, device)
    score_fn, pool, launches = main_path(model, device, all_kernels, {"roi_align": 2})
    kernel["launches"] = launches["roi_align"]

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


    bneck_kernels = bottleneck_kernel_phase(device, card)
    fused = fused_path(device, all_kernels, card)
    bneck_kernels[0]["launches"] = fused["1"]["launches"]
    bneck_kernels[1]["launches"] = fused["stage"]["launches"]

    group_kernel = group_kernel_phase(device, card)
    with tempfile.TemporaryDirectory() as workdir:
        al = al_loop_phase(device, all_kernels, card, workdir)
    group_kernel["launches"] = al["launches"]["roi_align_group_fwd"]
    group_kernel["launches_per_step"] = al["launches"]["roi_align_group_fwd"] / al["steps"]

    print(json.dumps({"kernels": [kernel, train_kernels[0], train_kernels[1], group_kernel,
                                  *bneck_kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
