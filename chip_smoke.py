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
     that cycle) the device busy share and the kernels that took the most;
 12. group norms, the rest of the aug protocol, LT/C and LS/C: (a) the
     group-norm R50-FPN pyramid on the card against the CPU on a small
     input (f32 1e-3 of the largest value; bf16 against the CPU's f32, mean
     relative error < 0.06 and max < 0.08 per level); (b) ``al_loop`` with
     ``norm="group"`` and LS/C at phase 11's data and cut, nothing frozen,
     no pretrained backbone, CALD_TPU_ROI_GROUP unset: finite losses,
     labeled 16 -> 24, conv1/bn1/layer1 changed by training, one K2 and one
     K3 per step, one K1 per detect (LS/C: a base detect of 8 and one of 48
     noisy images per score batch), the peak device memory of the score
     call; (c) from cycle 0's checkpoint, one ``score_and_select`` with LT/C
     (one K1 per batch) and one with CALD 'FCDRGS' (two per batch, 6 augs
     in the aug detect): the budget selected, scores finite in [0, 1]; warm
     LS/C and LT/C score calls (ms/call, images/s, LS/C's peak memory) and
     group-norm training steps (ms/step); (d) tests/test_learnability.py's
     configuration on the card (tiny, group norms, 32 learnable 96x128
     images, 30 epochs, lr 0.005, steps 20/26): per-class AP50 > 0.7 for
     aeroplane, bicycle and bird and their mean > 0.85, with its wall time.
 13. LL4AL, VAAL and SSM: ``al_loop`` with each at phase 11's data and cut
     from phase 11's backbone (``ll4al_phase``, ``vaal_phase``,
     ``ssm_phase``: their docstrings list the checks);
 14. the other models, at phase 11's data and cut (2 cycles of 1 epoch,
     16 initial images, budget 8, score batch 8, bf16, frozen norms), each
     run checked for finite losses, the labeled set grown by the budget, a
     finite mAP, ``cycle_0/`` read back by ``--resume`` and valid slots of
     a detect from it labelled 1..20: (a) RetinaNet R50-FPN (21 classes, 9
     anchors a cell on P3-P7) from phase 11's backbone with CALD: its f32
     pyramid and head on the GPU against the CPU (1e-3), no RoI kernel, a
     warm training step at B=4, the CALD score call at B=8 on the 640x1024
     canvas (5 warm calls, peak memory) with the trained heads and with
     every anchor a candidate, and the latter's detect split into convs,
     postprocess and NMS; (b) RetinaNet with SSM (its NMS-0.3 detect
     against the standard one, in turns) and with LL4AL (its joint step on
     P3..P6 against the task step, in turns); (c) ``faster_mobilenet`` from
     a seeded torchvision-layout ``mobilenet_v3_large`` backbone that the
     phase writes as ``.npz``: one K1 per detect, one K2 and one K3 per
     step, and K1 against its plain version on the model's two stride-32
     levels (limits as phase 3's, the levels scaled to unit deviation); (d)
     ``retina_mobilenet`` from the same file, no RoI kernel;
 15. COCO at full width: (a) ``al_loop`` on a synthetic COCO tree that
     ``make_coco`` writes as ``.npy`` (48 train2017 and 16 val2017 images,
     half 480x640 and half 640x480, 80 categories, 1-8 boxes of 16-200 px),
     at the resolved COCO sizes (min 800 / max 1333: canvases 832x1344 and
     1344x832, 81 classes, pool cap 10000): R50-FPN, frozen norms, bf16,
     from a backbone written as phase 11's but calibrated on this data,
     CALD with FCDR, 2 cycles of 1 epoch, batch
     4, 16 initial images, budget 8, score batch 8 (``coco_al_phase``'s
     docstring lists the checks), the COCO evaluator's seconds per image, a
     warm CALD score call (B=8) and training step (B=4) on each canvas, the
     peak device memory; (b) K1 (B=8, N=1000) and K2/K3 (B=4, S=512)
     against their plain versions on both COCO canvases, at phases 3 and
     6's limits, with their times and bounds; (c) ``cli.train``'s ``main``
     on the same tree: one epoch with ``--output-dir``, then ``--resume``
     for a second. The native JPEG decoder is not built here: the card has
     no libjpeg headers or library.
 16. data parallelism, the shrink slice, CIFAR: (a) ``al_loop`` on two
     ranks, subprocesses of ``tests/torch_dp_worker.py`` sharing the card
     over gloo (NCCL refuses two ranks on one device), at phase 11's data
     and cut (batch 4 a rank, CALD 'FCDR', CALD_TPU_ROI_GROUP unset) from
     phase 11's backbone, then one ``--resume`` (``dp_al_phase``'s
     docstring lists the checks); (b) one f32 step of two ranks at B=2
     against this process over the same two halves (and, not gated, at
     B=4 in one pass) on the same batch and draws (``dp_step_phase``); (c) after phase 5, on phase 4's model and pool,
     CALD with ``shrink_slice``: 3 K1 a score call, K1 on the 512x832
     slice against its plain version at phase 3's limits with its time and
     bound, consistency and selection against the full canvas on the same
     draws, warm calls against phase 5's (``shrink_slice_phase``); (d)
     ``al_cifar_loop`` at full width (ResNet-18 width 64, batch 128,
     LossNet 128, f32) on ``synthetic_cifar``, cut to 5000/1000 images, 2
     cycles of 6 epochs: finite losses, the labeled set grown by 1000 a
     cycle, test accuracy above 50%, warm joint steps (``cifar_phase``).
     Times of two ranks sharing one card are not scaling numbers.
     ``python3 chip_smoke.py --nccl`` (not part of the smoke run) runs
     phase 16's helpers, (b) and (a) on two ranks over NCCL, a card a rank
     (one card: NCCL's refusal).

Every kernel's entry has its launches on the path that runs it (K1 phase 4,
K2 and K3 phase 7, K4 phase 11, K5 and K6 phase 9; K1's per LS/C, LT/C and
CALD 'FCDRGS' score call and K2/K3's per group-norm step from phase 12;
K1's per ``faster_mobilenet`` detect and K2/K3's per step,
``launches_mobilenet``, from phase 14; K1's per COCO detect and K2/K3's
per COCO step, ``launches_coco``, and their times on COCO's canvases,
``coco``, from phase 15; K1's time and bound on the shrink slice's
512x832 canvas and launches per such score call, ``shrink_slice``, and
K1/K2/K3's launches on rank 0 of the two-rank loop, ``launches_dp``, from
phase 16),
its time (K5 and K6: on weights restaged once; ``ms_with_restaging``
through the wrappers) and its plain version's, its bound (the larger of
its bytes over 3.35 TB/s and its operations over the peak of their type,
from this run's inputs) and ``library_ms`` null: no single PyTorch call
computes RoIAlign or a bottleneck.

The line before the last is a JSON object describing each kernel; the last is
``{"ok": true, "device": {...}}``. JAX is not imported.
"""

from __future__ import annotations

import copy
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


def roi_work(feats, rois, valid, levels, output_size: int = 7, sr: int = 2, scales=SCALES):
    """What a RoIAlign over these inputs must touch: (bytes of the level
    pixels that the valid rois' bilinear taps read, each once; operations,
    one multiply and one add per tap and channel: S*S*sr*sr samples x 4
    corners per valid roi)."""
    import torch

    from cald_tpu_torch.ops import roi_align as plain

    b, n = rois.shape[:2]
    c = feats[0].shape[-1]
    pyr = plain._Pyramid([f.shape for f in feats], scales, rois.device)
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


def special_rois(valid_hw) -> list:
    """Border-crossing, tiny, whole-image, overhanging and extreme-aspect
    rois for a valid region (on VOC's 600x1000: [980, 580, 1040, 640], ...)."""
    vh, vw = valid_hw
    return [[-20, -10, 60, 50], [vw - 20, vh - 20, vw + 40, vh + 40], [100, 100, 100.5, 100.5],
            [0, 0, vw, vh], [vw - 40, 10, vw + 160, 40], [5, 5, 6, 300]]


def roi_inputs(device, b: int = BATCH, n: int = 1000, c: int = 256, seed: int = SEED,
               canvas=CANVAS, valid_hw=VALID_HW):
    """Unit-normal P2..P5 levels of the canvas (640x1024 unless given), rois
    over the valid region with ~30% invalid slots, plus ``special_rois``."""
    import torch

    rng = np.random.default_rng(seed)
    shapes = [(canvas[0] // s, canvas[1] // s) for s in (4, 8, 16, 32)]
    feats = [torch.from_numpy(rng.normal(0, 1, (b, h, w, c)).astype(np.float32)).to(device)
             for h, w in shapes]
    cx = rng.uniform(0, valid_hw[1], (b, n))
    cy = rng.uniform(0, valid_hw[0], (b, n))
    sz = rng.uniform(4, 500, (b, n))
    ar = rng.uniform(0.25, 4.0, (b, n))
    w, h = sz * np.sqrt(ar), sz / np.sqrt(ar)
    rois = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)
    rois[:, :6] = special_rois(valid_hw)
    valid = rng.uniform(size=(b, n)) > 0.3
    valid[:, :6] = True
    rois[~valid] = 0.0
    return feats, torch.from_numpy(rois).to(device), torch.from_numpy(valid).to(device)


def kernel_phase(device, canvas=CANVAS, valid_hw=VALID_HW, label: str = "kernel") -> dict:
    """K1 against its plain version at B=8, N=1000 on the canvas (phase 3;
    phase 15(b) on COCO's canvases)."""
    import torch

    from cald_tpu_torch.ops import roi_align as plain
    from cald_tpu_torch.ops.roi_align_cuda import roi_align_kernel

    scales = SCALES
    feats, rois, valid = roi_inputs(device, canvas=canvas, valid_hw=valid_hw)
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
    print(f"{label}: roi_align B={BATCH} N=1000 C=256 on {canvas[0]}x{canvas[1]} "
          f"valid={int(valid.sum())}: "
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


def gt_boxes(rng, b: int, valid_hw=VALID_HW):
    """Seeded ground truth: 1-8 boxes per image inside the valid region, in
    MAX_BOXES slots, labels in 1..NUM_CLASSES-1."""
    boxes = np.zeros((b, MAX_BOXES, 4), np.float32)
    labels = np.zeros((b, MAX_BOXES), np.int32)
    valid = np.zeros((b, MAX_BOXES), bool)
    for i in range(b):
        k = int(rng.integers(1, 9))
        wh = rng.uniform(32, 400, (k, 2))
        xy = rng.uniform(0, 1, (k, 2)) * (np.array(valid_hw[::-1]) - wh)
        boxes[i, :k] = np.concatenate([xy, xy + wh], -1)
        labels[i, :k] = rng.integers(1, NUM_CLASSES, k)
        valid[i, :k] = True
    return boxes, labels, valid


def train_roi_inputs(device, c: int = 256, seed: int = SEED, canvas=CANVAS, valid_hw=VALID_HW):
    """The training path's RoIAlign inputs: unit-normal P2..P5 levels of the
    canvas and TRAIN_SAMPLES rois per image made like the sampler's: a
    quarter positives (seeded gt boxes, jittered), random negatives, the
    border-crossing, tiny and extreme-aspect cases of ``roi_inputs``, and
    about 25% invalid slots (which keep their boxes, as the sampler's do)."""
    import torch

    rng = np.random.default_rng(seed + 10)
    b, n = TRAIN_BATCH, TRAIN_SAMPLES
    shapes = [(canvas[0] // s, canvas[1] // s) for s in (4, 8, 16, 32)]
    feats = [torch.from_numpy(rng.normal(0, 1, (b, h, w, c)).astype(np.float32)).to(device)
             for h, w in shapes]
    gt, _, gv = gt_boxes(rng, b, valid_hw)
    cx = rng.uniform(0, valid_hw[1], (b, n))
    cy = rng.uniform(0, valid_hw[0], (b, n))
    sz = rng.uniform(4, 500, (b, n))
    ar = rng.uniform(0.25, 4.0, (b, n))
    w, h = sz * np.sqrt(ar), sz / np.sqrt(ar)
    rois = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    n_pos = n // 4
    for i in range(b):
        src = gt[i, rng.integers(0, gv[i].sum(), n_pos)]
        size = (src[:, 2:] - src[:, :2]).repeat(2, axis=1)
        rois[i, 6:6 + n_pos] = src + rng.normal(0, 0.08, (n_pos, 4)) * size
    rois[:, :6] = special_rois(valid_hw)
    valid = rng.uniform(size=(b, n)) > 0.25
    valid[:, :6] = True
    return (feats, torch.from_numpy(rois.astype(np.float32)).to(device),
            torch.from_numpy(valid).to(device))


def train_kernel_phase(device, canvas=CANVAS, valid_hw=VALID_HW,
                       label: str = "train kernels") -> list[dict]:
    """K2 and K3 against their plain versions at the training shapes (phase
    6; phase 15(b) on COCO's canvases)."""
    import torch

    from cald_tpu_torch.ops import roi_align as plain
    from cald_tpu_torch.ops.roi_align_cuda import roi_align_bwd_kernel, roi_align_train_fwd_kernel

    feats, rois, valid = train_roi_inputs(device, canvas=canvas, valid_hw=valid_hw)
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
    _, u_rois, u_valid = roi_inputs(device, b=TRAIN_BATCH, n=TRAIN_SAMPLES, c=1, canvas=canvas,
                                    valid_hw=valid_hw)
    u_levels = plain.roi_levels(u_rois, SCALES).contiguous()
    bwd_uniform_ms = cuda_ms(lambda: roi_align_bwd_kernel(
        cot, u_rois, u_valid, u_levels, shapes, spatial_scales=SCALES), 20)
    print(f"{label}: B={TRAIN_BATCH} S={TRAIN_SAMPLES} C=256 on {canvas[0]}x{canvas[1]} "
          f"valid={int(valid.sum())}: "
          f"K2 f32 max_abs_err={fwd_f32:.3e} (atol 1e-4), bf16 {fwd_bf16:.3e} (atol 5e-2); "
          f"K3 f32 max_abs_err={bwd_f32:.3e} (atol 1e-4), bf16 {bwd_bf16:.3e} (atol 5e-2 + "
          f"1e-2 rel); invalid out max={zero}, invalid-only gradient max={dead_max}")
    print(f"{label}: K2 bf16 {fwd_ms:.4f} ms, plain {fwd_plain_ms:.4f} ms; "
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


def calibrate_norms_(model, images, valid_hw, min_var: float = 0.0) -> None:
    """Set every frozen norm's mean/var to the statistics of its input on one
    batch, in forward order, so activations stay bounded through the 16
    bottlenecks (random kaiming weights grow them block by block). A
    variance below ``min_var`` (a channel the random weights leave dead)
    becomes ``min_var``, which caps that channel's gain once training wakes
    it."""
    import torch

    from cald_tpu_torch.models.layers import FrozenBatchNorm

    def pre_hook(mod, args):
        x = args[0].float()
        mod.mean.copy_(x.mean(dim=(0, 2, 3)))
        mod.var.copy_(x.var(dim=(0, 2, 3)).clamp_min(min_var))

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


class StageCounts:
    """While entered, patches ``cli.driver`` to record by stage of
    ``al_loop`` (the cycle trainings, evaluate, score_and_select, and VAAL's
    adversary epochs inside its training) each kernel's launches, the
    training steps and their losses (the task steps, LL4AL's joint steps and
    VAAL's VAE + discriminator steps apart), the detects (stage, images),
    the (stage, canvas) of every detect and task step (``canvases``), the
    first layers' parameters of each trained model, and the peak device
    memory of each score call. Every count is set to 0 on entry and read on
    exit (``launches``)."""

    FIRST_LAYERS = ("backbone.conv1", "backbone.bn1", "backbone.layer1")

    def __init__(self, driver, kernels: dict, device):
        self.driver, self.kernels, self.device = driver, kernels, device
        self.stages = {"train": [], "eval": [], "score": [], "adversary": []}
        self.steps, self.losses, self.detects, self.trained, self.score_peak = [], [], [], [], []
        self.ll_steps, self.vaal_steps = [], []
        self.canvases = set()
        self.stage = None

    def _counted(self, stage, fn):
        import torch

        def run(*args, **kwargs):
            before = {k: v.launches for k, v in self.kernels.items()}
            outer, self.stage = self.stage, stage
            if stage == "score" and self.device.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            out = fn(*args, **kwargs)
            if stage == "score" and self.device.type == "cuda":
                torch.cuda.synchronize()
                self.score_peak.append(torch.cuda.max_memory_allocated())
            if stage == "train":
                self.trained.append({n: p.detach().cpu().clone()
                                     for n, p in out[0].named_parameters()
                                     if n.startswith(self.FIRST_LAYERS)})
            self.stages[stage].append({k: v.launches - before[k] for k, v in self.kernels.items()})
            self.stage = outer
            return out
        return run

    def __enter__(self):
        from cald_tpu_torch.strategies.vaal import VAALTrainer

        driver, orig_epoch = self.driver, self.driver.train_one_epoch
        orig_ll, self._vaal_step = driver.make_ll_train_step, VAALTrainer.train_step
        self._detects = {cls: cls.detect for cls in (driver.FasterRCNN, driver.RetinaNet)}

        def epoch_counting(step_fn, *args, **kwargs):
            def step(*a):
                self.canvases.add((self.stage, tuple(a[0].shape[1:3])))
                m = step_fn(*a)
                self.losses.append({k: float(v) for k, v in m.items()})
                self.steps.append(1)
                return m
            return orig_epoch(step, *args, **kwargs)

        def ll_counting(*args, **kwargs):
            step_fn = orig_ll(*args, **kwargs)

            def step(*a, **k):
                m = step_fn(*a, **k)
                self.ll_steps.append({**{n: float(v) for n, v in m.items()},
                                      "detached": k["detach_features"]})
                return m
            return step

        def vaal_counting(trainer, *a):
            out = self._vaal_step(trainer, *a)
            self.vaal_steps.append(tuple(float(v) for v in out))
            return out

        def detect_counting(model, images, valid_hw):
            self.detects.append((self.stage, images.shape[0]))
            self.canvases.add((self.stage, tuple(images.shape[1:3])))
            return self._detects[type(model)](model, images, valid_hw)

        patches = {"train_cycle": self._counted("train", driver.train_cycle),
                   "_train_cycle_ll4al": self._counted("train", driver._train_cycle_ll4al),
                   "_train_cycle_vaal": self._counted("train", driver._train_cycle_vaal),
                   "_vaal_adversary_epoch": self._counted("adversary",
                                                          driver._vaal_adversary_epoch),
                   "evaluate": self._counted("eval", driver.evaluate),
                   "score_and_select": self._counted("score", driver.score_and_select),
                   "train_one_epoch": epoch_counting, "make_ll_train_step": ll_counting}
        self._saved = {k: getattr(driver, k) for k in patches}
        for k, v in patches.items():
            setattr(driver, k, v)
        for cls in self._detects:
            cls.detect = detect_counting
        VAALTrainer.train_step = vaal_counting
        for k in self.kernels.values():
            k.launches = 0
        return self

    def __exit__(self, *exc):
        from cald_tpu_torch.strategies.vaal import VAALTrainer

        self.launches = {name: k.launches for name, k in self.kernels.items()}
        for k, v in self._saved.items():
            setattr(self.driver, k, v)
        for cls, detect in self._detects.items():
            cls.detect = detect
        VAALTrainer.train_step = self._vaal_step
        return False

    def total(self, *stages) -> dict:
        return {k: sum(c[k] for st in stages for c in self.stages[st]) for k in self.kernels}


AL_TRAIN_IMAGES = 48
AL_TEST_IMAGES = 16
AL_IMAGE_HW = (375, 500)         # a typical VOC image


def write_calibrated_backbone(cfg, dataset, device) -> None:
    """Write ``cfg.pretrained_backbone``, the backbone users would pass as
    ImageNet weights: the seeded init with its frozen norms calibrated on
    one batch of ``dataset`` (phases 4 and 7)."""
    import torch

    from cald_tpu_torch.cli import driver
    from cald_tpu_torch.convert.torchvision_import import backbone_state_dict
    from cald_tpu_torch.data.batching import create_aspect_ratio_groups, default_canvases
    from cald_tpu_torch.models.init import random_init_

    model, _ = driver.build_model(cfg, len(dataset.class_names))
    random_init_(model, cfg.seed)
    model.to(device)
    groups = create_aspect_ratio_groups(dataset.aspect_ratios(), cfg.aspect_ratio_group_factor)
    calib = next(iter(driver._loaders(cfg, dataset, range(TRAIN_BATCH), batch_size=TRAIN_BATCH,
                                      train=False, group_ids=groups,
                                      canvases=default_canvases(cfg.min_size, cfg.max_size))))
    calibrate_norms_(model, torch.from_numpy(calib.images).to(device),
                     torch.from_numpy(calib.valid_hw).to(device))
    torch.save(backbone_state_dict(model), cfg.pretrained_backbone)


def al_loop_phase(device, kernels: dict, card: str, workdir: str) -> dict:
    """The active-learning loop on the card (phase 11): R50-FPN trained from
    a torchvision-layout backbone written here, CALD_TPU_ROI_GROUP=8, two
    cycles on a synthetic VOC set; launch counts per stage; one score call
    with CALD_TPU_ROI_FLM=0."""
    import torch

    from cald_tpu_torch.cli import driver
    from cald_tpu_torch.cli.config import ALConfig
    from cald_tpu_torch.data.batching import create_aspect_ratio_groups, default_canvases
    from cald_tpu_torch.engine.checkpoint import load_checkpoint
    from cald_tpu_torch.strategies.cald import CALDConfig, make_cald_score_fn, score_pool

    train_root, datasets = _al_data(workdir)
    cfg = ALConfig(data_path=train_root, strategy="cald", augs="FCDR", cycles=2, epochs=1,
                   batch_size=TRAIN_BATCH, init_num=16, budget_num=8, score_batch_size=BATCH,
                   workers=4, print_freq=1, output_dir=os.path.join(workdir, "out"),
                   profile_dir=os.path.join(workdir, "profile"),
                   pretrained_backbone=os.path.join(workdir, "backbone.pt"),
                   device=device.type).resolve()

    num_classes = len(datasets[0].class_names)
    write_calibrated_backbone(cfg, datasets[0], device)
    canvases = default_canvases(cfg.min_size, cfg.max_size)
    groups = create_aspect_ratio_groups(datasets[0].aspect_ratios(),
                                        cfg.aspect_ratio_group_factor)

    os.environ["CALD_TPU_ROI_GROUP"] = "8"
    counts = StageCounts(driver, kernels, device)
    with counts:
        t0 = time.perf_counter()
        history = driver.al_loop(cfg, datasets=datasets)
        wall = time.perf_counter() - t0
    launches, stage_counts, steps, losses = (counts.launches, counts.stages, counts.steps,
                                             counts.losses)
    n_detect = len(counts.detects)

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
    train_k, infer_k = counts.total("train"), counts.total("eval", "score")
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
            "trace": trace, "backbone": cfg.pretrained_backbone}


def group_pyramid_check(device) -> dict:
    """Phase 12(a): the R50-FPN pyramid with group norms (the seeded init,
    GroupNorm scale 1 and bias 0) on the card against the CPU on a small
    input: f32 on both with TF32 off (max error 1e-3 of the level's largest
    magnitude, as phase 4), and bf16 on the card against f32 on the CPU
    (per level, mean error < 0.06 of the mean magnitude and max error <
    0.08 of the largest; the CPU's own bf16 pyramid is 0.025-0.028 and at
    most 0.037 off)."""
    import torch

    from cald_tpu_torch.models.faster_rcnn import FasterRCNN, FasterRCNNConfig
    from cald_tpu_torch.models.init import random_init_

    cfg = FasterRCNNConfig(num_classes=NUM_CLASSES, norm="group", compute_dtype="float32")
    f32 = FasterRCNN(cfg).eval()
    random_init_(f32, SEED)
    bf16 = FasterRCNN(dataclasses.replace(cfg, compute_dtype="bfloat16")).eval()
    bf16.load_state_dict(f32.state_dict())
    images = torch.from_numpy(make_pool(BATCH, seed=SEED + 2)[0].images[:2, :128, :192].copy())
    hw = torch.tensor([[128, 192], [100, 150]], dtype=torch.int32)
    with torch.inference_mode():
        want = f32.features(images, hw)
    f32.to(device)
    bf16.to(device)
    with torch.inference_mode():
        got32 = [g.cpu() for g in f32.features(images.to(device), hw.to(device))]
        got16 = [g.float().cpu() for g in bf16.features(images.to(device), hw.to(device))]
    err32 = max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got32, want))
    mean16 = [((g - w).abs().mean() / w.abs().mean()).item() for g, w in zip(got16, want)]
    max16 = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got16, want)]
    print(f"group norm: R50-FPN pyramid on 2x128x192, f32 GPU vs CPU max relative error "
          f"{err32:.3e} (limit 1e-3); bf16 GPU vs f32 CPU per level: mean relative "
          f"{[f'{e:.4f}' for e in mean16]} (limit 0.06), max relative "
          f"{[f'{e:.4f}' for e in max16]} (limit 0.08)")
    if not (err32 <= 1e-3 and max(mean16) < 0.06 and max(max16) < 0.08):
        raise AssertionError("the group-norm pyramid on the GPU disagrees with the CPU path")
    return {"f32_max_rel": err32, "bf16_mean_rel": mean16, "bf16_max_rel": max16}


def _al_data(workdir: str):
    """Phase 11's synthetic VOC trees (48 trainval, 16 test, 375x500 .npy)
    under ``workdir``; returns (train root, (trainval, test) datasets)."""
    from cald_tpu_torch.data.synthetic import make_learnable_voc
    from cald_tpu_torch.data.voc import get_voc2007

    train_root = make_learnable_voc(os.path.join(workdir, "train"), AL_TRAIN_IMAGES,
                                    AL_IMAGE_HW, seed=SEED, image_format="npy")
    test_root = make_learnable_voc(os.path.join(workdir, "test"), AL_TEST_IMAGES, AL_IMAGE_HW,
                                   seed=SEED + 1, image_format="npy")
    return train_root, (get_voc2007(train_root, "trainval"), get_voc2007(test_root, "test"))


def _warm_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls after one warm-up
    call, host clock around work that ends in a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def group_al_phase(device, kernels: dict, card: str, workdir: str) -> dict:
    """Phase 12(b) and (c): ``al_loop`` with group norms and LS/C (nothing
    frozen, no pretrained backbone, CALD_TPU_ROI_GROUP unset), then LT/C
    and CALD 'FCDRGS' from cycle 0's checkpoint, and the warm LS/C and
    LT/C score calls and group-norm training steps."""
    import torch

    from cald_tpu_torch.augment.suite import generator_draw
    from cald_tpu_torch.cli import driver
    from cald_tpu_torch.cli.config import ALConfig
    from cald_tpu_torch.data.batching import create_aspect_ratio_groups, default_canvases
    from cald_tpu_torch.engine.checkpoint import load_checkpoint
    from cald_tpu_torch.engine.optim import make_sgd
    from cald_tpu_torch.engine.train import make_train_step
    from cald_tpu_torch.models.init import random_init_
    from cald_tpu_torch.models.matcher import generator_gumbel
    from cald_tpu_torch.strategies.lsc import make_lsc_score_fn
    from cald_tpu_torch.strategies.ltc import make_ltc_score_fn

    train_root, datasets = _al_data(workdir)
    cfg = ALConfig(data_path=train_root, norm="group", strategy="lsc", cycles=2, epochs=1,
                   batch_size=TRAIN_BATCH, init_num=16, budget_num=8, score_batch_size=BATCH,
                   workers=4, print_freq=1, output_dir=os.path.join(workdir, "out"),
                   device=device.type).resolve()
    num_classes = len(datasets[0].class_names)
    n_pool = AL_TRAIN_IMAGES - cfg.init_num
    n_score_batches = -(-n_pool // BATCH)

    # (b) the loop
    counts = StageCounts(driver, kernels, device)
    with counts:
        t0 = time.perf_counter()
        history = driver.al_loop(cfg, datasets=datasets)
        wall = time.perf_counter() - t0
    steps, train_k = len(counts.steps), counts.total("train")
    infer_k = counts.total("eval", "score")
    score_detects = [n for st, n in counts.detects if st == "score"]
    for h in history:
        print(f"group-norm al loop: cycle {h['cycle']}: labeled {h['labeled']}, mAP "
              f"{h['eval']['mAP']:.4f}; wall {h['time_s']:.2f} s (train "
              f"{h['split_s']['train']:.2f}, eval {h['split_s']['eval']:.2f}, score "
              f"{h['split_s']['score']:.2f}) on {card}")
    peak = max(counts.score_peak) if counts.score_peak else 0
    print(f"group-norm al loop: {steps} training steps, {len(counts.detects)} detects (scoring "
          f"{score_detects}); launches by stage {json.dumps(counts.stages)}; peak device "
          f"memory of the LS/C score call {peak / 2 ** 30:.2f} GiB; {wall:.2f} s on {card}")
    if not (steps > 0 and train_k["roi_align_train_fwd"] == steps
            and train_k["roi_align_bwd"] == steps and train_k["roi_align"] == 0
            and train_k["roi_align_group_fwd"] == 0):
        raise AssertionError(f"group-norm training did not launch K2 and K3 once per step: "
                             f"{train_k}")
    if not (infer_k["roi_align"] == len(counts.detects) and infer_k["roi_align_train_fwd"] == 0
            and infer_k["roi_align_group_fwd"] == 0):
        raise AssertionError(f"evaluation and scoring did not launch K1 once per detect: "
                             f"{infer_k}")
    if score_detects != [BATCH, 6 * BATCH] * n_score_batches:
        raise AssertionError(f"LS/C did not detect base + 6 noisy variants per batch: "
                             f"{score_detects}")
    if not all(math.isfinite(v) for d in counts.losses for v in d.values()):
        raise AssertionError("non-finite training losses under group norm")
    if [h["labeled"] for h in history] != [cfg.init_num + cfg.budget_num] * 2:
        raise AssertionError(f"LS/C did not grow the labeled set by the budget: {history}")
    fresh, _ = driver.build_model(cfg, num_classes)
    random_init_(fresh, cfg.seed)
    init = dict(fresh.named_parameters())
    trained = counts.trained[0]
    unchanged = [n for n, p in trained.items() if torch.equal(p, init[n].detach())]
    print(f"group-norm al loop: {len(trained)} parameters of conv1, bn1 and layer1, "
          f"{len(unchanged)} unchanged by training")
    if unchanged or not any(n.startswith("backbone.layer1") for n in trained):
        raise AssertionError(f"conv1/layer1 did not train under group norm: {unchanged[:5]}")

    # (c) LT/C and CALD 'FCDRGS' from cycle 0's checkpoint
    model, _ = driver.build_model(cfg, num_classes)
    model.to(device)
    pool, _, _ = load_checkpoint(os.path.join(cfg.output_dir, "cycle_0"), model)
    canvases = default_canvases(cfg.min_size, cfg.max_size)
    groups = create_aspect_ratio_groups(datasets[0].aspect_ratios(),
                                        cfg.aspect_ratio_group_factor)
    captured = {}

    def capture(name, fn):
        def run(*args, **kwargs):
            captured[name] = fn(*args, **kwargs)
            return captured[name]
        return run

    per_call = {"lsc": counts.total("score")["roi_align"] / (n_score_batches * (cfg.cycles - 1))}
    for strategy, hook in (("ltc", "run_ltc"), ("cald", "score_pool")):
        scfg = dataclasses.replace(cfg, strategy=strategy, augs="FCDRGS")
        orig = getattr(driver, hook)
        setattr(driver, hook, capture(strategy, orig))
        counts = StageCounts(driver, kernels, device)
        try:
            with counts:
                chosen = driver.score_and_select(scfg, model, datasets[0], pool, canvases, groups,
                                                 cycle=0, device=device)
        finally:
            setattr(driver, hook, orig)
        scores = np.asarray(captured[strategy][0] if strategy == "cald" else captured[strategy])
        sizes = [n for _, n in counts.detects]
        k1 = counts.launches["roi_align"]
        per_call[strategy] = k1 / n_score_batches
        print(f"{strategy} from cycle 0 (augs {scfg.augs}): selected {len(chosen)}, detects "
              f"{sizes}, launches {counts.launches}, scores "
              f"{np.array2string(scores, precision=4, max_line_width=200)}")
        want_sizes = ([BATCH] if strategy == "ltc" else [BATCH, 6 * BATCH]) * n_score_batches
        lo, hi = ((cfg.budget_num, cfg.budget_num) if strategy == "ltc"
                  else (cfg.budget_num, int(cfg.mr * cfg.budget_num)))
        if not (sizes == want_sizes and k1 == len(sizes) and sum(counts.launches.values()) == k1):
            raise AssertionError(f"{strategy}: not one K1 per detect ({sizes}, {counts.launches})")
        if not (lo <= len(chosen) <= hi and len(set(chosen.tolist())) == len(chosen)
                and set(chosen.tolist()) <= set(pool.unlabeled.tolist())):
            raise AssertionError(f"{strategy}: the selection is not the budget: {chosen}")
        if not (np.isfinite(scores).all() and scores.min() >= 0.0 and scores.max() <= 1.0):
            raise AssertionError(f"{strategy}: scores not finite or outside [0, 1]")

    # warm score calls and training steps on one batch
    batch = next(iter(driver._loaders(cfg, datasets[0], range(BATCH), batch_size=BATCH,
                                      train=False, canvases=canvases, group_ids=groups)))
    images = torch.from_numpy(batch.images).to(device)
    valid_hw = torch.from_numpy(batch.valid_hw).to(device)
    lsc_fn, ltc_fn = make_lsc_score_fn(model), make_ltc_score_fn(model)
    draw = generator_draw(torch.Generator(device=device).manual_seed(SEED + 7))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lsc_ms = _warm_ms(lambda: lsc_fn(images, valid_hw, draw), 3)
    lsc_peak = torch.cuda.max_memory_allocated()
    ltc_ms = _warm_ms(lambda: ltc_fn(images, valid_hw), 5)
    tb = next(iter(driver._loaders(cfg, datasets[0], range(TRAIN_BATCH), batch_size=TRAIN_BATCH,
                                   train=True, canvases=canvases, group_ids=groups, seed=SEED)))
    tbatch = [torch.from_numpy(np.asarray(a)).to(device) for a in (
        tb.images, tb.valid_hw, tb.boxes, tb.labels, tb.box_valid)]
    step = make_train_step(model, make_sgd(model, FIXED_LR))
    gumbel = generator_gumbel(torch.Generator(device=device).manual_seed(SEED + 8))
    step_ms = _warm_ms(lambda: step(*tbatch, gumbel), 5)
    print(f"group-norm time: LS/C score call of B={BATCH} ({6 * BATCH} noisy images) "
          f"{lsc_ms:.1f} ms/call, {BATCH / lsc_ms * 1e3:.2f} images/s, peak device memory "
          f"{lsc_peak / 2 ** 30:.2f} GiB; LT/C score call {ltc_ms:.1f} ms/call, "
          f"{BATCH / ltc_ms * 1e3:.2f} images/s; training step of B={TRAIN_BATCH} "
          f"{step_ms:.1f} ms/step, {TRAIN_BATCH / step_ms * 1e3:.2f} images/s on {card}")
    del model, fresh
    torch.cuda.empty_cache()
    return {"history": history, "steps": steps, "train_launches": train_k,
            "score_peak_bytes": peak, "launches_per_score_call": per_call,
            "lsc_ms": lsc_ms, "lsc_peak_bytes": lsc_peak, "ltc_ms": ltc_ms, "step_ms": step_ms,
            "wall_s": wall}


LEARN_EPOCHS = 30                # tests/test_learnability.py's configuration


def learnability_phase(device, kernels: dict, card: str, workdir: str) -> dict:
    """Phase 12(d): the JAX package's learnability configuration on the card
    (tiny, group norms, 32 learnable 96x128 images, 30 epochs, lr 0.005,
    steps 20/26, random, 1 cycle): per-class AP50 > 0.7 for aeroplane,
    bicycle and bird, and their mean > 0.85."""
    from cald_tpu_torch.cli import driver
    from cald_tpu_torch.cli.config import ALConfig
    from cald_tpu_torch.data.synthetic import make_learnable_voc
    from cald_tpu_torch.data.voc import get_voc2007

    root = make_learnable_voc(os.path.join(workdir, "learn"), 32, image_format="npy")
    ds = get_voc2007(root, "trainval")
    cfg = ALConfig(dataset="voc2007", data_path=root, model="faster", strategy="random",
                   tiny=True, norm="group", cycles=1, epochs=LEARN_EPOCHS, batch_size=4,
                   init_num=32, budget_num=1, score_batch_size=4, workers=4, min_size=96,
                   max_size=128, max_boxes=8, print_freq=100000, lr=0.005, lr_steps=(20, 26),
                   aspect_ratio_group_factor=0, output_dir=os.path.join(workdir, "learn_out"),
                   device=device.type).resolve()
    counts = StageCounts(driver, kernels, device)
    with counts:
        t0 = time.perf_counter()
        history = driver.al_loop(cfg, datasets=(ds, ds))
        wall = time.perf_counter() - t0
    steps, train_k = len(counts.steps), counts.total("train")
    infer_k = counts.total("eval", "score")
    per_class = history[0]["eval"]["per_class_ap50"]
    present = {k: per_class.get(k, 0.0) for k in ("aeroplane", "bicycle", "bird")}
    mean = float(np.mean(list(present.values())))
    print(f"learnability: tiny group-norm detector, {LEARN_EPOCHS} epochs, {steps} steps: "
          f"AP50 {json.dumps({k: round(v, 4) for k, v in present.items()})}, mean {mean:.4f} "
          f"(limits 0.7 each, 0.85 mean); launches train {train_k}, eval {infer_k}; wall "
          f"{wall:.2f} s on {card}")
    if not (train_k["roi_align_train_fwd"] == steps == train_k["roi_align_bwd"]
            and infer_k["roi_align"] == len(counts.detects)):
        raise AssertionError("the learnability run did not go through K2/K3 and K1")
    if not (all(v > 0.7 for v in present.values()) and mean > 0.85):
        raise AssertionError(f"the tiny detector did not learn: {present}")
    return {"ap50": present, "mean": mean, "steps": steps, "wall_s": wall, "cfg": cfg,
            "dataset": ds, "checkpoint": os.path.join(cfg.output_dir, "cycle_0")}


# Phase 13. VAAL's recipe as the JAX package gives it (VAE SGD at lr/10 with
# momentum on 0..255 pixels, the KLD an unnormalised batch sum) diverges at
# the reference lr in both packages: on the CPU at the reference widths the
# VAE loss passes 1e31 at the 4th step from lr 0.0025 and is NaN by the 8th
# from 2.5e-4; from 2.5e-5 it stays near 3e3 over 12 steps. Part (b) runs at
# 2.5e-5 so that its finite-loss check means something.
P13_VAAL_LR = 2.5e-5
P13_BUDGET = 8


def _p13_cfg(workdir: str, backbone: str, device, **kw):
    """Phase 11's cut (2 cycles of 1 epoch, batch 4, 16 initial images,
    budget 8, score batch 8) from phase 11's torchvision-layout backbone."""
    from cald_tpu_torch.cli.config import ALConfig

    base = dict(data_path=os.path.join(workdir, "train"), cycles=2, epochs=1,
                batch_size=TRAIN_BATCH, init_num=16, budget_num=P13_BUDGET,
                score_batch_size=BATCH, workers=4, print_freq=1, pretrained_backbone=backbone,
                device=device.type)
    return ALConfig(**{**base, **kw}).resolve()


def _check_inference(counts, what: str) -> int:
    """One K1 per detect of evaluation and scoring and no other RoI kernel
    there; returns the number of those detects."""
    k = counts.total("eval", "score")
    n = sum(1 for st, _ in counts.detects if st in ("eval", "score"))
    if not (k["roi_align"] == n and k["roi_align_train_fwd"] == 0 and k["roi_align_bwd"] == 0
            and k["roi_align_group_fwd"] == 0):
        raise AssertionError(f"{what}: evaluation and scoring did not launch K1 once per "
                             f"detect ({n} detects): {k}")
    return n


def _check_labeled(history, cfg, what: str):
    if [h["labeled"] for h in history] != [cfg.init_num + cfg.budget_num] * cfg.cycles:
        raise AssertionError(f"{what}: the labeled set did not grow by the budget: {history}")


def _print_cycles(history, label: str, card: str):
    for h in history:
        print(f"{label}: cycle {h['cycle']}: labeled {h['labeled']}, mAP {h['eval']['mAP']:.4f}; "
              f"wall {h['time_s']:.2f} s (train {h['split_s']['train']:.2f}, eval "
              f"{h['split_s']['eval']:.2f}, score {h['split_s']['score']:.2f}) on {card}")


def ll4al_phase(device, kernels: dict, card: str, workdir: str, backbone: str) -> dict:
    """Phase 13(a): ``al_loop`` with LL4AL, 2 epochs a cycle of which the
    second detaches LossNet's features; one K2 and one K3 per joint step, no
    RoI kernel in LossNet's scoring; on one fixed batch with fixed draws,
    the detector's update with detached features against its update at
    ll_weight 0 (held to the spread of two identical ll_weight-0 steps);
    the warm joint step against the frozen task step, in turns."""
    import torch

    from cald_tpu_torch.cli import driver
    from cald_tpu_torch.data.batching import create_aspect_ratio_groups, default_canvases
    from cald_tpu_torch.engine.checkpoint import load_extra
    from cald_tpu_torch.engine.optim import RESNET_FROZEN_L3, make_sgd
    from cald_tpu_torch.engine.train import make_train_step
    from cald_tpu_torch.models.init import random_init_
    from cald_tpu_torch.models.matcher import generator_gumbel
    from cald_tpu_torch.strategies.ll4al import make_ll_train_step

    _, datasets = _al_data(workdir)
    cfg = _p13_cfg(workdir, backbone, device, strategy="ll4al", epochs=2, task_epochs=1,
                   output_dir=os.path.join(workdir, "ll4al_out"))
    num_classes = len(datasets[0].class_names)
    counts = StageCounts(driver, kernels, device)
    with counts:
        t0 = time.perf_counter()
        history = driver.al_loop(cfg, datasets=datasets)
        wall = time.perf_counter() - t0
    joint, train_k, score_k = counts.ll_steps, counts.total("train"), counts.total("score")
    _print_cycles(history, "ll4al al loop", card)
    print(f"ll4al al loop: {len(joint)} joint steps ({sum(s['detached'] for s in joint)} with "
          f"detached features), last task loss {joint[-1]['task_loss']:.4f}, LossNet loss "
          f"{joint[-1]['ll_loss']:.4f}; launches by stage {json.dumps(counts.stages)}; "
          f"{wall:.2f} s on {card}")
    if not (joint and {s["detached"] for s in joint} == {False, True} and not counts.steps):
        raise AssertionError("ll4al: the joint and the detached epochs did not both run")
    if not all(math.isfinite(s[k]) for s in joint for k in ("task_loss", "ll_loss", "loss")):
        raise AssertionError("ll4al: non-finite task or LossNet loss")
    if not (train_k["roi_align_train_fwd"] == len(joint) == train_k["roi_align_bwd"]
            and train_k["roi_align"] == 0 and train_k["roi_align_group_fwd"] == 0):
        raise AssertionError(f"ll4al: training did not launch K2 and K3 once per joint step: "
                             f"{train_k}")
    if any(score_k.values()):
        raise AssertionError(f"ll4al: LossNet scoring launched a RoI kernel: {score_k}")
    _check_inference(counts, "ll4al")
    _check_labeled(history, cfg, "ll4al")
    # every LossNet parameter moves but the last bias, which the ranking
    # loss's pairwise differences cancel (it gets no gradient)
    model, _ = driver.build_model(cfg, num_classes)
    fresh = driver._new_lossnet(model, cfg, "cpu").state_dict()
    for cycle in range(cfg.cycles):
        trained = load_extra(os.path.join(cfg.output_dir, f"cycle_{cycle}"))["ll_params"]
        still = [k for k, v in fresh.items() if torch.equal(v, trained[k])]
        if still != ["linear.bias"]:
            raise AssertionError(f"ll4al: LossNet parameters unmoved in cycle {cycle}: {still}")

    # the fixed batch: detached features against ll_weight 0
    canvases = default_canvases(cfg.min_size, cfg.max_size)
    groups = create_aspect_ratio_groups(datasets[0].aspect_ratios(), cfg.aspect_ratio_group_factor)
    tb = next(iter(driver._loaders(cfg, datasets[0], range(TRAIN_BATCH), batch_size=TRAIN_BATCH,
                                   train=True, canvases=canvases, group_ids=groups, seed=SEED)))
    tbatch = driver._tensors(tb, device)
    random_init_(model, cfg.seed)
    driver._apply_pretrained_backbone(model, cfg)
    model.to(device)
    init = {k: v.clone() for k, v in model.state_dict().items()}

    def update(ll_weight: float, detach: bool) -> dict:
        model.load_state_dict(init)
        lossnet = driver._new_lossnet(model, cfg, device)
        step = make_ll_train_step(model, lossnet,
                                  make_sgd(model, FIXED_LR, frozen_prefixes=RESNET_FROZEN_L3),
                                  make_sgd(lossnet, FIXED_LR), ll_weight=ll_weight)
        before = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
        step(*tbatch, generator_gumbel(torch.Generator(device=device).manual_seed(SEED + 9)),
             detach_features=detach)
        return {n: p.detach() - before[n] for n, p in model.named_parameters() if p.requires_grad}

    def rel(a: dict, b: dict) -> float:
        return max(((a[n] - b[n]).abs().max() / b[n].abs().max().clamp_min(1e-30)).item()
                   for n in b)

    detached, alone, again = update(cfg.ll_weight, True), update(0.0, False), update(0.0, False)
    noise, err = rel(again, alone), rel(detached, alone)
    limit = max(4 * noise, 1e-3)
    print(f"ll4al fixed batch: the detector's update with detached features against ll_weight 0, "
          f"max relative difference per tensor {err:.3e}; two ll_weight-0 steps differ by "
          f"{noise:.3e} (K3's atomics); limit {limit:.3e}")
    if not err <= limit:
        raise AssertionError("ll4al: detached features changed the detector's update")

    # warm steps in turns: the frozen task step, the joint step
    model.load_state_dict(init)
    lossnet = driver._new_lossnet(model, cfg, device)
    joint_step = make_ll_train_step(model, lossnet, make_sgd(model, FIXED_LR, frozen_prefixes=
                                                             RESNET_FROZEN_L3),
                                    make_sgd(lossnet, FIXED_LR), ll_weight=cfg.ll_weight)
    task_step = make_train_step(model, make_sgd(model, FIXED_LR, frozen_prefixes=RESNET_FROZEN_L3))
    gumbel = generator_gumbel(torch.Generator(device=device).manual_seed(SEED + 8))
    times = {"frozen": [], "joint": []}
    for name in ("frozen", "joint", "joint", "frozen"):
        fn = ((lambda: task_step(*tbatch, gumbel)) if name == "frozen"
              else (lambda: joint_step(*tbatch, gumbel, detach_features=False)))
        times[name].append(_warm_ms(fn, 5))
    print(f"ll4al time: joint step of B={TRAIN_BATCH} {times['joint']} ms, frozen task step "
          f"{times['frozen']} ms (in turns) on {card}")
    del model, lossnet, init
    torch.cuda.empty_cache()
    return {"history": history, "joint_steps": len(joint), "train_launches": train_k,
            "fixed_batch_rel": err, "noise_rel": noise, "joint_ms": times["joint"],
            "frozen_ms": times["frozen"], "wall_s": wall}


def vaal_phase(device, kernels: dict, card: str, workdir: str, backbone: str) -> dict:
    """Phase 13(b): ``al_loop`` with VAAL (the VAE at the reference widths,
    lr ``P13_VAAL_LR``): one K2 and one K3 per task step, no RoI kernel in
    the adversary epochs or VAAL scoring, finite VAE and discriminator
    losses, both nets moved, scores in [-1, 0]; warm VAE + discriminator
    steps, score calls and their peak device memory."""
    import torch

    from cald_tpu_torch.augment.suite import generator_draw
    from cald_tpu_torch.cli import driver
    from cald_tpu_torch.data.batching import create_aspect_ratio_groups, default_canvases
    from cald_tpu_torch.engine.checkpoint import load_extra

    _, datasets = _al_data(workdir)
    cfg = _p13_cfg(workdir, backbone, device, strategy="vaal", lr=P13_VAAL_LR,
                   output_dir=os.path.join(workdir, "vaal_out"))
    scores = []
    orig_select = driver.vaal_select
    driver.vaal_select = lambda s, budget: scores.append(s) or orig_select(s, budget)
    counts = StageCounts(driver, kernels, device)
    try:
        with counts:
            t0 = time.perf_counter()
            history = driver.al_loop(cfg, datasets=datasets)
            wall = time.perf_counter() - t0
    finally:
        driver.vaal_select = orig_select
    steps, adv = len(counts.steps), counts.vaal_steps
    train_k, adv_k, score_k = (counts.total("train"), counts.total("adversary"),
                               counts.total("score"))
    _print_cycles(history, "vaal al loop", card)
    print(f"vaal al loop (lr {cfg.lr}): {steps} task steps, {len(adv)} VAE + discriminator "
          f"steps, last vae_loss {adv[-1][0]:.2f} dis_loss {adv[-1][1]:.4f}; scores "
          f"{np.array2string(np.concatenate(scores), precision=4, max_line_width=200)}; "
          f"launches by stage {json.dumps(counts.stages)}; peak device memory of the score "
          f"call {max(counts.score_peak, default=0) / 2 ** 30:.2f} GiB; {wall:.2f} s on {card}")
    if not (steps and adv and all(math.isfinite(v) for a in adv for v in a)
            and all(math.isfinite(v) for d in counts.losses for v in d.values())):
        raise AssertionError("vaal: non-finite task, VAE or discriminator loss")
    if not (train_k["roi_align_train_fwd"] == steps == train_k["roi_align_bwd"]
            and train_k["roi_align"] == 0 and train_k["roi_align_group_fwd"] == 0):
        raise AssertionError(f"vaal: training did not launch K2 and K3 once per task step: "
                             f"{train_k}")
    if any(adv_k.values()) or any(score_k.values()):
        raise AssertionError(f"vaal: a RoI kernel in the adversary epochs ({adv_k}) or in "
                             f"VAAL scoring ({score_k})")
    s = np.concatenate(scores)
    if not (np.isfinite(s).all() and s.min() >= -1.0 and s.max() <= 0.0):
        raise AssertionError("vaal: scores not finite or outside [-1, 0]")
    _check_inference(counts, "vaal")
    _check_labeled(history, cfg, "vaal")
    for cycle in range(cfg.cycles):
        carry = load_extra(os.path.join(cfg.output_dir, f"cycle_{cycle}"))
        fresh = driver._make_vaal_trainer(cfg, 1, cycle, device)
        for key, net in (("vaal_vae", fresh.vae), ("vaal_d", fresh.disc)):
            still = [k for k, v in net.state_dict().items()
                     if torch.equal(v.cpu(), carry[key][k])]
            if still:
                raise AssertionError(f"vaal: {key} parameters did not move in cycle {cycle}: "
                                     f"{still}")
        del fresh

    # warm steps and score calls
    canvases = default_canvases(cfg.min_size, cfg.max_size)
    groups = create_aspect_ratio_groups(datasets[0].aspect_ratios(), cfg.aspect_ratio_group_factor)

    def images(idx, b, train):
        batch = next(iter(driver._loaders(cfg, datasets[0], idx, batch_size=b, train=train,
                                          canvases=canvases, group_ids=groups, seed=SEED)))
        return torch.from_numpy(batch.images).to(device)

    lab, unlab = images(range(TRAIN_BATCH), TRAIN_BATCH, True), images(
        range(TRAIN_BATCH, 2 * TRAIN_BATCH), TRAIN_BATCH, True)
    pool = images(range(BATCH), BATCH, False)
    trainer = driver._make_vaal_trainer(cfg, 4, 0, device)
    draw = generator_draw(torch.Generator(device=device).manual_seed(SEED + 10))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = _warm_ms(lambda: trainer.train_step(lab, unlab, draw), 5)
    step_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    score_ms = _warm_ms(lambda: trainer.unlabeled_scores(pool), 5)
    score_peak = torch.cuda.max_memory_allocated()
    print(f"vaal time: VAE + discriminator step on {TRAIN_BATCH} + {TRAIN_BATCH} canvases "
          f"{step_ms:.1f} ms/step (peak device memory {step_peak / 2 ** 30:.2f} GiB); score "
          f"call of B={BATCH} {score_ms:.1f} ms/call, {BATCH / score_ms * 1e3:.2f} images/s "
          f"(peak {score_peak / 2 ** 30:.2f} GiB) on {card}")
    del trainer
    torch.cuda.empty_cache()
    return {"history": history, "task_steps": steps, "vaal_steps": len(adv),
            "train_launches": train_k, "step_ms": step_ms, "score_ms": score_ms,
            "step_peak_bytes": step_peak, "score_peak_bytes": score_peak, "wall_s": wall}


def ssm_phase(device, kernels: dict, card: str, workdir: str, backbone: str,
              learn: dict) -> dict:
    """Phase 13(c): ``al_loop`` with SSM at full width (an untrained detector:
    stage 1 sends every image to labeling), then ``score_and_select`` with
    SSM on the learnability run's trained detector and its own set, which
    reaches stage 2 and the cross-validator; one K1 per pool detect and per
    re-detect; the SSM-mode detect against the standard one on R50, in
    turns."""
    import torch

    from cald_tpu_torch.cli import driver
    from cald_tpu_torch.data.batching import create_aspect_ratio_groups, default_canvases
    from cald_tpu_torch.data.pool import ALPoolState
    from cald_tpu_torch.engine.checkpoint import load_checkpoint
    from cald_tpu_torch.strategies import ssm

    flags, redetects, easy, votes = [], [], [], []
    orig = {"pool": driver._ssm_pool_detections, "host": driver._detect_host_fn,
            "judge": ssm.judge_uv, "verify": ssm.CrossValidator.verify}

    def pool_detections(*a, **k):
        out = orig["pool"](*a, **k)
        flags.extend(d["al"] for d in out.values())
        return out

    def detect_host_fn(*a, **k):
        run = orig["host"](*a, **k)
        return lambda images: redetects.append(len(images)) or run(images)

    def judge_uv(*a, **k):
        out = orig["judge"](*a, **k)
        easy.append(out[0])
        return out

    def verify(*a, **k):
        votes.append(orig["verify"](*a, **k))
        return votes[-1]

    driver._ssm_pool_detections, driver._detect_host_fn = pool_detections, detect_host_fn
    ssm.judge_uv, ssm.CrossValidator.verify = judge_uv, verify
    try:
        # (i) the loop at full width
        _, datasets = _al_data(workdir)
        cfg = _p13_cfg(workdir, backbone, device, strategy="ssm")
        counts = StageCounts(driver, kernels, device)
        with counts:
            t0 = time.perf_counter()
            history = driver.al_loop(cfg, datasets=datasets)
            wall = time.perf_counter() - t0
        _print_cycles(history, "ssm al loop", card)
        n_infer = _check_inference(counts, "ssm")
        pool_sizes = [n for st, n in counts.detects if st == "score"]
        print(f"ssm al loop: {len(flags)} pool images, {sum(flags)} sent to labeling by stage 1; "
              f"score detects {pool_sizes} ({len(redetects)} re-detects); {n_infer} detects with "
              f"K1 {counts.launches['roi_align']}; {wall:.2f} s on {card}")
        _check_labeled(history, cfg, "ssm")
        if not (flags and all(flags)):
            raise AssertionError("ssm: the untrained detector's pool did not all go to stage 1")

        # (ii) cross-validation on the trained tiny group-norm detector
        flags.clear()
        lcfg = dataclasses.replace(learn["cfg"], strategy="ssm", budget_num=P13_BUDGET)
        ds = learn["dataset"]
        model, _ = driver.build_model(lcfg, len(ds.class_names))
        model.to(device)
        load_checkpoint(learn["checkpoint"], model)
        pool = ALPoolState.initial(len(ds), len(ds) // 2, SEED)
        state: dict = {}
        counts = StageCounts(driver, kernels, device)
        with counts:
            chosen = driver.score_and_select(
                lcfg, model, ds, pool, default_canvases(lcfg.min_size, lcfg.max_size),
                create_aspect_ratio_groups(ds.aspect_ratios(), lcfg.aspect_ratio_group_factor),
                cycle=0, device=device, strategy_state=state)
        n_detects = len(counts.detects)
        print(f"ssm cross-validation (trained tiny group-norm detector, {len(pool.unlabeled)} "
              f"pool and {len(pool.labeled)} labeled images): stage 1 sent {sum(flags)} of "
              f"{len(flags)} to labeling; {sum(easy)} easy boxes of {len(easy)} judged; "
              f"{len(votes)} verifications ({sum(votes)} passed) with {sum(redetects)} paste "
              f"re-detects; {n_detects} detects, K1 {counts.launches['roi_align']}; selected "
              f"{sorted(chosen.tolist())}; gamma 0.15 -> {state['gamma']:.2f}, clslambda "
              f"{np.array2string(state['clslambda'][:3], precision=4)}...")
        if not (sum(easy) > 0 and sum(redetects) > 0):
            raise AssertionError("ssm: no easy box or no paste re-detect: the cross-validator "
                                 "was not reached")
        if not (counts.launches["roi_align"] == n_detects
                and sum(counts.launches.values()) == n_detects):
            raise AssertionError(f"ssm: not one K1 per pool detect and re-detect: "
                                 f"{counts.launches}, {n_detects} detects")
        if not (abs(state["gamma"] - 0.20) < 1e-12 and np.isfinite(state["clslambda"]).all()):
            raise AssertionError(f"ssm: gamma {state['gamma']} did not rise by 0.05, or "
                                 "clslambda is not finite")
        if not (len(chosen) == P13_BUDGET and set(chosen.tolist()) <= set(pool.unlabeled.tolist())):
            raise AssertionError(f"ssm: the selection is not the budget: {chosen}")
        cv = {"easy": sum(easy), "judged": len(easy), "verifications": len(votes),
              "passed": sum(votes), "redetects": sum(redetects), "detects": n_detects}
        del model
    finally:
        driver._ssm_pool_detections, driver._detect_host_fn = orig["pool"], orig["host"]
        ssm.judge_uv, ssm.CrossValidator.verify = orig["judge"], orig["verify"]

    # (iii) the SSM-mode detect against the standard one, R50 with spread heads
    model = build_model(device)
    ssm_model = copy.copy(model)
    ssm_model.cfg = dataclasses.replace(model.cfg, box_nms_thresh=0.3, ssm_mode=True)
    batch = make_pool(BATCH, seed=SEED + 4)[0]
    images = torch.from_numpy(batch.images).to(device)
    hw = torch.from_numpy(batch.valid_hw).to(device)
    times, valid = {"standard": [], "ssm": []}, {}
    with torch.inference_mode():
        for name in ("standard", "ssm", "ssm", "standard"):
            m = model if name == "standard" else ssm_model
            times[name].append(_warm_ms(lambda: m.detect(images, hw), 5))
            valid[name] = int(m.detect(images, hw).valid.sum())
    print(f"ssm time: detect of B={BATCH} on R50 in turns, standard (NMS 0.5, 100 slots) "
          f"{times['standard']} ms, SSM mode (no pre-NMS filter semantics, NMS 0.3 over 4096 "
          f"candidates, 300 slots) {times['ssm']} ms; valid detections {valid} on {card}")
    del model, ssm_model
    torch.cuda.empty_cache()
    return {"history": history, "cv": cv, "detect_ms": times, "wall_s": wall}


P14_SPREAD_BIAS = -1.5            # cls_logits bias of the timing variant: sigmoid 0.18
# the seeded MobileNet's calibrated variances are at least this (its random
# depthwise and squeeze-excite weights leave channels dead; at var 0 such a
# channel's gain, 1/sqrt(1e-5), blows training up once a step wakes it)
P14_MIN_VAR = 1e-2


def _p14_run(driver, kernels: dict, device, card: str, workdir: str, datasets, label: str,
             backbone: str, **kw) -> dict:
    """One ``al_loop`` of phase 14 (phase 11's cut: 2 cycles of 1 epoch,
    one selection) with its launches by stage, and its checks: finite
    losses, the labeled set grown by the budget (CALD: up to int(mr *
    budget), as phase 11), a finite mAP per cycle, ``cycle_0/`` written
    and read back by ``--resume`` (the same number selected again), and the
    valid slots of a detect from that checkpoint (score threshold 0, so
    that every slot fills) carrying labels in 1..20."""
    import torch

    from cald_tpu_torch.data.batching import create_aspect_ratio_groups, default_canvases
    from cald_tpu_torch.engine.checkpoint import load_checkpoint

    out = os.path.join(workdir, label.replace(" ", "_"))
    cfg = _p13_cfg(workdir, backbone, device, output_dir=out, **kw)
    counts = StageCounts(driver, kernels, device)
    with counts:
        t0 = time.perf_counter()
        history = driver.al_loop(cfg, datasets=datasets)
        wall = time.perf_counter() - t0
    _print_cycles(history, label, card)
    steps = counts.losses + [{k: v for k, v in s.items() if k != "detached"}
                             for s in counts.ll_steps]
    print(f"{label}: {len(steps)} training steps, last losses {steps[-1] if steps else None}; "
          f"{len(counts.detects)} detects; launches by stage {json.dumps(counts.stages)}; "
          f"{wall:.2f} s on {card}")
    if not (steps and all(math.isfinite(v) for d in steps for v in d.values())):
        raise AssertionError(f"{label}: no training step, or non-finite losses")
    picked = history[0]["labeled"] - cfg.init_num
    top = int(cfg.mr * cfg.budget_num) if cfg.strategy == "cald" else cfg.budget_num
    if not (cfg.budget_num <= picked <= top and history[1]["labeled"] == history[0]["labeled"]):
        raise AssertionError(f"{label}: the labeled set did not grow by the budget: {history}")
    if not all(math.isfinite(h["eval"]["mAP"]) for h in history):
        raise AssertionError(f"{label}: non-finite VOC mAP")

    ckpt = os.path.join(out, "cycle_0")
    resumed = driver.al_loop(dataclasses.replace(cfg, resume=ckpt, output_dir="",
                                                 eval_every_cycle=False), datasets=datasets)
    same = resumed[0]["labeled_digest"] == history[0]["labeled_digest"]
    print(f"{label}: --resume {ckpt}: cycle 0 {resumed[0]['eval']}, labeled "
          f"{resumed[0]['labeled']} (the same images: {same})")
    if not (resumed[0]["eval"] == {"resumed": True}
            and resumed[0]["labeled"] == history[0]["labeled"]):
        raise AssertionError(f"{label}: --resume from cycle_0 did not select the budget again")

    num_classes = len(datasets[0].class_names)
    model, _ = driver.build_model(cfg, num_classes)
    model.to(device)
    load_checkpoint(ckpt, model)
    low = driver._variant(model, **({"score_thresh": 0.0} if isinstance(model, driver.RetinaNet)
                                    else {"box_score_thresh": 0.0}))
    canvases = default_canvases(cfg.min_size, cfg.max_size)
    groups = create_aspect_ratio_groups(datasets[1].aspect_ratios(),
                                        cfg.aspect_ratio_group_factor)
    batch = next(iter(driver._loaders(cfg, datasets[1], range(BATCH), batch_size=BATCH,
                                      train=False, canvases=canvases, group_ids=groups)))
    with torch.inference_mode():
        dets = low.detect(torch.from_numpy(batch.images).to(device),
                          torch.from_numpy(batch.valid_hw).to(device))
    labels = dets.labels[dets.valid].tolist()
    print(f"{label}: a detect of the test batch from cycle_0 at score threshold 0: "
          f"{len(labels)} valid slots, labels {min(labels, default=None)}.."
          f"{max(labels, default=None)}")
    if not (labels and min(labels) >= 1 and max(labels) < num_classes):
        raise AssertionError(f"{label}: valid detections with labels outside 1..20")
    del model, low
    torch.cuda.empty_cache()
    return {"cfg": cfg, "history": history, "counts": counts, "steps": len(steps),
            "wall_s": wall}


def _no_roi_kernels(run: dict, label: str):
    """RetinaNet runs no RoIAlign: no RoI kernel in any stage."""
    launches = run["counts"].launches
    if any(launches.values()):
        raise AssertionError(f"{label}: a RetinaNet run launched a RoI kernel: {launches}")


def retina_reference_check(model, device) -> float:
    """The f32 RetinaNet pyramid and head outputs on the GPU against the CPU
    path of the same weights on a small input (TF32 off); returns the max
    relative error (of each tensor's largest magnitude)."""
    import torch

    f32 = type(model)(dataclasses.replace(model.cfg, compute_dtype="float32")).eval()
    f32.load_state_dict(model.state_dict())
    images = torch.from_numpy(make_pool(BATCH, seed=SEED + 2)[0].images[:2, :128, :192].copy())
    hw = torch.tensor([[128, 192], [100, 150]], dtype=torch.int32)

    def outputs(m, im, h):
        with torch.inference_mode():
            pyramid = m.features(im, h)
            return [*pyramid, *m.head(pyramid)]

    want = outputs(f32, images, hw)
    f32.to(device)
    got = outputs(f32, images.to(device), hw.to(device))
    err = max(((g.cpu() - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want))
    print(f"retina reference: f32 P3..P7 and head logits/regressions GPU vs CPU on 2x128x192, "
          f"max relative error {err:.3e} (limit 1e-3)")
    if not err <= 1e-3:
        raise AssertionError("the RetinaNet pyramid or head on the GPU disagrees with the CPU")
    return err


def retina_head_flops(pyramid, cfg) -> float:
    """Operations of RetinaNet's head on one image of this pyramid: 8 shared
    3x3 256->256 convs and the two output convs at every position."""
    c, a = cfg.fpn_channels, len(cfg.anchor_sizes[0]) * len(cfg.aspect_ratios)
    positions = sum(f.shape[-2] * f.shape[-1] for f in pyramid)
    return 2.0 * 9 * c * (8 * c + a * cfg.num_classes + a * 4) * positions


def retina_timings(model, device, card: str) -> dict:
    """(a)'s timing at B=8 on the 640x1024 canvas: the CALD score call (5
    warm calls, peak memory) on the trained model and on a variant whose
    cls_logits bias is ``P14_SPREAD_BIAS`` (every anchor a candidate: the
    postprocess and NMS at their widest), and that variant's detect split
    into the pyramid + head convs, the postprocess and its NMS (synced
    timers around ``batched_nms``)."""
    import torch

    from cald_tpu_torch.models import retinanet
    from cald_tpu_torch.strategies.cald import CALDConfig, make_cald_score_fn
    from cald_tpu_torch.augment.suite import generator_draw

    spread = copy.deepcopy(model)
    with torch.no_grad():
        spread.head.cls_logits.bias.fill_(P14_SPREAD_BIAS)
    batch = make_pool(BATCH, seed=SEED + 5)[0]
    images = torch.from_numpy(batch.images).to(device)
    hw = torch.from_numpy(batch.valid_hw).to(device)
    draw = generator_draw(torch.Generator(device=device).manual_seed(SEED + 3))
    out: dict = {}
    for name, m in (("trained", model), ("spread", spread)):
        score_fn = make_cald_score_fn(m, CALDConfig(), NUM_CLASSES)
        with torch.inference_mode():
            score_fn(images, hw, draw)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = _warm_ms(lambda: score_fn(images, hw, draw), 5)
            peak = torch.cuda.max_memory_allocated()
            valid = int(m.detect(images, hw).valid.sum())
        out[name] = {"score_ms": ms, "peak_gib": peak / 2 ** 30, "valid": valid}
        print(f"retina time: CALD score call of B={BATCH} on {CANVAS}, {name} heads: {ms:.1f} "
              f"ms/call, {BATCH / ms * 1e3:.2f} images/s, peak {peak / 2 ** 30:.2f} GiB, "
              f"{valid} valid detections in the base detect on {card}")

    nms_ms = []
    orig_nms = retinanet.batched_nms

    def timed_nms(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = orig_nms(*a, **k)
        torch.cuda.synchronize()
        nms_ms.append((time.perf_counter() - t0) * 1e3)
        return r

    with torch.inference_mode():
        conv_ms = _warm_ms(lambda: spread.head(spread.features(images, hw)), 5)
        detect_ms = _warm_ms(lambda: spread.detect(images, hw), 5)
        pyramid = spread.features(images, hw)
        retinanet.batched_nms = timed_nms
        try:
            _warm_ms(lambda: spread.detect(images, hw), 5)
        finally:
            retinanet.batched_nms = orig_nms
    nms = float(np.mean(nms_ms[1:]))
    flops = retina_head_flops(pyramid, spread.cfg)
    print(f"retina time: detect of B={BATCH} (spread heads) {detect_ms:.1f} ms: pyramid + head "
          f"convs {conv_ms:.1f} ms, postprocess {detect_ms - conv_ms - nms:.1f} ms + NMS "
          f"{nms:.1f} ms (synced); the head is {flops / 1e12:.4f} TFLOP per image over "
          f"{sum(f.shape[-2] * f.shape[-1] for f in pyramid)} P3..P7 positions on {card}")
    del spread
    torch.cuda.empty_cache()
    return {**out, "detect_ms": detect_ms, "conv_ms": conv_ms, "nms_ms": nms,
            "head_tflop_per_image": flops / 1e12}


def retina_phase(device, kernels: dict, card: str, workdir: str, backbone: str) -> dict:
    """Phase 14(a)-(b): RetinaNet R50-FPN at full width from phase 11's
    torchvision-layout backbone: the f32 GPU/CPU check, ``al_loop`` with
    CALD (and a warm training step, the CALD score call and the detect's
    split), then with SSM (its NMS-0.3 detect against the standard one, in
    turns) and LL4AL (its joint step on P3..P6 against the task step, in
    turns); no RoI kernel anywhere."""
    import torch

    from cald_tpu_torch.cli import driver
    from cald_tpu_torch.data.batching import create_aspect_ratio_groups, default_canvases
    from cald_tpu_torch.engine.checkpoint import load_checkpoint
    from cald_tpu_torch.engine.optim import RESNET_FROZEN_L3, make_sgd
    from cald_tpu_torch.engine.train import make_train_step
    from cald_tpu_torch.models.init import random_init_
    from cald_tpu_torch.strategies.ll4al import make_ll_train_step

    _, datasets = _al_data(workdir)
    num_classes = len(datasets[0].class_names)
    cfg = _p13_cfg(workdir, backbone, device, model="retina")
    model, frozen = driver.build_model(cfg, num_classes)
    random_init_(model, cfg.seed)
    driver._apply_pretrained_backbone(model, cfg)
    model.eval()
    retina_reference_check(model, device)

    run = _p14_run(driver, kernels, device, card, workdir, datasets, "retina cald", backbone,
                   model="retina")
    _no_roi_kernels(run, "retina cald")

    # a warm training step at B=4 on the loop's canvas, from the fresh weights
    canvases = default_canvases(cfg.min_size, cfg.max_size)
    groups = create_aspect_ratio_groups(datasets[0].aspect_ratios(), cfg.aspect_ratio_group_factor)
    tb = next(iter(driver._loaders(cfg, datasets[0], range(TRAIN_BATCH), batch_size=TRAIN_BATCH,
                                   train=True, canvases=canvases, group_ids=groups, seed=SEED)))
    tbatch = driver._tensors(tb, device)
    model.to(device).train()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, make_sgd(model, FIXED_LR, frozen_prefixes=frozen))
    step_ms = _warm_ms(lambda: step(*tbatch, None), 5)
    print(f"retina time: training step of B={TRAIN_BATCH} on {tuple(tb.images.shape[1:3])}: "
          f"{step_ms:.1f} ms/step on {card}")

    model.eval()
    load_checkpoint(os.path.join(run["cfg"].output_dir, "cycle_0"), model)
    timing = retina_timings(model, device, card)

    ssm = _p14_run(driver, kernels, device, card, workdir, datasets, "retina ssm", backbone,
                   model="retina", strategy="ssm")
    _no_roi_kernels(ssm, "retina ssm")
    spread = copy.deepcopy(model)
    with torch.no_grad():
        spread.head.cls_logits.bias.fill_(P14_SPREAD_BIAS)
    ssm_model = driver._variant(spread, nms_thresh=0.3)
    batch = make_pool(BATCH, seed=SEED + 4)[0]
    images = torch.from_numpy(batch.images).to(device)
    hw = torch.from_numpy(batch.valid_hw).to(device)
    detect_ms = {"standard": [], "ssm": []}
    with torch.inference_mode():
        for name in ("standard", "ssm", "ssm", "standard"):
            m = spread if name == "standard" else ssm_model
            detect_ms[name].append(_warm_ms(lambda: m.detect(images, hw), 5))
    print(f"retina ssm time: detect of B={BATCH} on {CANVAS} (spread heads) in turns, standard "
          f"(NMS 0.5) {detect_ms['standard']} ms, SSM (NMS 0.3) {detect_ms['ssm']} ms on {card}")
    del spread, ssm_model

    ll4al = _p14_run(driver, kernels, device, card, workdir, datasets, "retina ll4al", backbone,
                     model="retina", strategy="ll4al")
    _no_roi_kernels(ll4al, "retina ll4al")
    model.load_state_dict(init)
    model.train()
    lossnet = driver._new_lossnet(model, cfg, device)
    if lossnet.num_levels != 4:
        raise AssertionError("retina: LossNet does not read P3..P6")
    joint = make_ll_train_step(model, lossnet, make_sgd(model, FIXED_LR, frozen_prefixes=frozen),
                               make_sgd(lossnet, FIXED_LR), ll_weight=cfg.ll_weight)
    task = make_train_step(model, make_sgd(model, FIXED_LR, frozen_prefixes=frozen))
    step_times = {"task": [], "joint": []}
    for name in ("task", "joint", "joint", "task"):
        fn = ((lambda: task(*tbatch, None)) if name == "task"
              else (lambda: joint(*tbatch, None, detach_features=False)))
        step_times[name].append(_warm_ms(fn, 5))
    print(f"retina ll4al time: joint step of B={TRAIN_BATCH} (LossNet on P3..P6) "
          f"{step_times['joint']} ms, task step {step_times['task']} ms (in turns) on {card}")
    del model, lossnet, init
    torch.cuda.empty_cache()
    return {"cald": run, "ssm": ssm, "ll4al": ll4al, "step_ms": step_ms, "timing": timing,
            "ssm_detect_ms": detect_ms, "ll4al_step_ms": step_times}


def mobilenet_kernel_check(model, device, card: str) -> dict:
    """K1 against its plain version on faster_mobilenet's two stride-32
    levels at B=8 on the 640x1024 canvas, with the model's own 1000
    proposals per image (every roi maps to the first level), the levels
    scaled to unit standard deviation: bf16 levels against the plain f32
    version (atol 5e-2) and f32 levels (atol 1e-4, TF32 off), as phase 3;
    the kernel's and the plain version's times and the bound."""
    import torch

    from cald_tpu_torch.models.rpn import select_proposals
    from cald_tpu_torch.ops import roi_align as plain
    from cald_tpu_torch.ops.roi_align_cuda import roi_align_kernel

    batch = make_pool(BATCH, seed=SEED + 6)[0]
    images = torch.from_numpy(batch.images).to(device)
    hw = torch.from_numpy(batch.valid_hw).to(device)
    cfg = model.cfg
    with torch.inference_mode():
        pyramid = model.features(images, hw)
        objectness, deltas = model.rpn_head(pyramid)
        anchors, counts = model._anchors(pyramid, device)
        rois, _, valid = select_proposals(objectness, deltas, anchors, counts, hw,
                                          pre_nms_top_n=cfg.rpn_pre_nms_top_n_test,
                                          post_nms_top_n=cfg.rpn_post_nms_top_n_test,
                                          nms_thresh=cfg.rpn_nms_thresh)
        rois, valid = rois.contiguous(), valid.contiguous()
        feats, scales = model._roi_levels(pyramid)
        # scaled to unit standard deviation, so that phase 3's limits apply
        sd = torch.cat([f.float().reshape(-1) for f in feats]).std()
        feats = [(f.float() / sd).to(f.dtype).contiguous() for f in feats]
        feats32 = [f.float() for f in feats]
        want = plain.multi_scale_roi_align(feats32, rois, spatial_scales=scales, valid=valid)
        got = roi_align_kernel(feats, rois, valid, spatial_scales=scales)
        got32 = roi_align_kernel(feats32, rois, valid, spatial_scales=scales)
        torch.cuda.synchronize()
        levels = plain.roi_levels(rois, scales)
        err_bf16 = (got.float() - want)[valid].abs().max().item()
        err_f32 = (got32 - want)[valid].abs().max().item()
        ms = cuda_ms(lambda: roi_align_kernel(feats, rois, valid, spatial_scales=scales), 20)
        plain_ms = cuda_ms(lambda: plain.multi_scale_roi_align(
            feats, rois, spatial_scales=scales, valid=valid), 5)
    level_bytes, n_ops = roi_work(feats, rois, valid, levels, scales=scales)
    b = bound(level_bytes + got.numel() * 2 + roi_index_bytes(rois, valid, levels), n_ops,
              F32_OPS_S)
    print(f"mobilenet kernel: roi_align on the two stride-32 levels {[tuple(f.shape) for f in feats]}"
          f" ({feats[0].dtype}), {int(valid.sum())} valid rois of {rois.shape[1]} per image x "
          f"{rois.shape[0]}, level 0 for all: {bool((levels == 0).all())}; bf16 max_abs_err "
          f"{err_bf16:.3e} (atol 5e-2), f32 {err_f32:.3e} (atol 1e-4); K1 {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}) on {card}")
    if not (err_bf16 <= 5e-2 and err_f32 <= 1e-4 and bool((levels == 0).all())):
        raise AssertionError("faster_mobilenet: K1 disagrees with its plain version, or a roi "
                             "left the first level")
    return {"max_abs_err": err_bf16, "max_abs_err_f32": err_f32, "ms": ms, "plain_ms": plain_ms,
            **b}


def mobilenet_phase(device, kernels: dict, card: str, workdir: str) -> dict:
    """Phase 14(c)-(d): ``faster_mobilenet`` from a seeded torchvision-layout
    ``mobilenet_v3_large`` backbone that the phase writes as ``.npz`` (the
    seeded init, frozen norms calibrated on one batch of the data): one K1
    per detect and one K2 and one K3 per training step, K1 against its plain
    version on the model's two-level pyramid; then ``retina_mobilenet`` from
    the same file, with no RoI kernel."""
    import torch

    from cald_tpu_torch.cli import driver
    from cald_tpu_torch.convert.torchvision_import import backbone_state_dict
    from cald_tpu_torch.data.batching import create_aspect_ratio_groups, default_canvases
    from cald_tpu_torch.engine.checkpoint import load_checkpoint
    from cald_tpu_torch.models.init import random_init_

    _, datasets = _al_data(workdir)
    num_classes = len(datasets[0].class_names)
    path = os.path.join(workdir, "mobilenet_v3_large.npz")
    cfg = _p13_cfg(workdir, path, device, model="faster_mobilenet")
    model, _ = driver.build_model(cfg, num_classes)
    random_init_(model, cfg.seed)
    model.to(device)
    canvases = default_canvases(cfg.min_size, cfg.max_size)
    groups = create_aspect_ratio_groups(datasets[0].aspect_ratios(), cfg.aspect_ratio_group_factor)
    calib = next(iter(driver._loaders(cfg, datasets[0], range(TRAIN_BATCH), batch_size=TRAIN_BATCH,
                                      train=False, canvases=canvases, group_ids=groups)))
    calibrate_norms_(model, torch.from_numpy(calib.images).to(device),
                     torch.from_numpy(calib.valid_hw).to(device), min_var=P14_MIN_VAR)
    np.savez(path, **{k: v.numpy() for k, v in backbone_state_dict(model).items()})
    del model

    run = _p14_run(driver, kernels, device, card, workdir, datasets, "faster_mobilenet cald",
                   path, model="faster_mobilenet")
    counts = run["counts"]
    train_k = counts.total("train")
    if not (train_k["roi_align_train_fwd"] == run["steps"] == train_k["roi_align_bwd"]
            and train_k["roi_align"] == 0 and train_k["roi_align_group_fwd"] == 0):
        raise AssertionError(f"faster_mobilenet: training did not launch K2 and K3 once per "
                             f"step: {train_k}")
    n_detects = _check_inference(counts, "faster_mobilenet")

    model, _ = driver.build_model(cfg, num_classes)
    model.to(device).eval()
    load_checkpoint(os.path.join(run["cfg"].output_dir, "cycle_0"), model)
    check = mobilenet_kernel_check(model, device, card)
    del model
    torch.cuda.empty_cache()

    retina = _p14_run(driver, kernels, device, card, workdir, datasets, "retina_mobilenet cald",
                      path, model="retina_mobilenet")
    _no_roi_kernels(retina, "retina_mobilenet cald")
    return {"faster": run, "retina": retina, "check": check,
            "launches": {"detects": n_detects, "roi_align": counts.total("eval", "score")["roi_align"],
                         "steps": run["steps"], "roi_align_train_fwd": train_k["roi_align_train_fwd"],
                         "roi_align_bwd": train_k["roi_align_bwd"]}}


COCO_TRAIN_IMAGES = 48
COCO_TEST_IMAGES = 16
COCO_IMAGE_HW = ((480, 640), (640, 480))     # (h, w): half landscape, half portrait
COCO_BOX_SIZE = (16.0, 200.0)                # box sides drawn from, in image pixels
COCO_MIN_MAX = (800, 1333)                   # ALConfig.resolve's COCO sizes
COCO_CANVASES = ((832, 1344), (1344, 832))   # default_canvases(800, 1333)
COCO_VALID_HW = ((800, 1067), (1067, 800))   # 480x640 at 800 / 480


def _coco_data(workdir: str):
    """Phase 15's synthetic COCO tree (48 train2017 and 16 val2017 ``.npy``
    images, 80 categories, 1-8 boxes of 16-200 px an image) under
    ``workdir``; returns (root, (train, val) datasets)."""
    from cald_tpu_torch.data.coco import get_coco
    from cald_tpu_torch.data.synthetic import make_coco

    root = os.path.join(workdir, "coco")
    for split, n, seed in (("train", COCO_TRAIN_IMAGES, SEED), ("val", COCO_TEST_IMAGES, SEED + 1)):
        make_coco(root, num_images=n, hw=COCO_IMAGE_HW, num_classes=80, seed=seed, split=split,
                  image_format="npy", max_objects=8, box_size=COCO_BOX_SIZE)
    return root, (get_coco(root, "train"), get_coco(root, "val"))


def coco_kernel_phase(device, card: str) -> dict:
    """Phase 15(b): K1 (B=8, N=1000) and K2/K3 (B=4, S=512) against their
    plain versions on both COCO canvases, at phases 3 and 6's limits."""
    out = {}
    for canvas, valid_hw in zip(COCO_CANVASES, COCO_VALID_HW):
        key = f"{canvas[0]}x{canvas[1]}"
        k1 = kernel_phase(device, canvas, valid_hw, label=f"coco kernel {key}")
        k2, k3 = train_kernel_phase(device, canvas, valid_hw, label=f"coco train kernels {key}")
        out[key] = {"roi_align": k1, "roi_align_train_fwd": k2, "roi_align_bwd": k3}
        for name, e in out[key].items():
            print(f"coco kernels {key}: {name} {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, "
                  f"bound {e['bound_ms']:.4f} ms ({e['bound_by']}, "
                  f"{e['bound_bytes'] / 1e6:.1f} MB), share {e['bound_ms'] / e['ms']:.3f}, "
                  f"max_abs_err {e['max_abs_err']:.3e} on {card}")
    return out


COCO_LOGIT_STDS = (1.0, 1.5, 2.0, 3.0, 4.0)  # class-logit spreads tried for the loaded score call
COCO_EVAL_DETS = 100    # jittered ground-truth detections an image for the loaded evaluator


def spread_classes_(model, images, valid_hw, stds, seed: int) -> tuple[float, float]:
    """Redraw the box predictor's class weights (seeded normal, bias 0)
    and scale them so that one detect's class logits have standard
    deviation ``std`` across the classes (mean over the proposals), for
    each ``std`` of ``stds``; keep the one that puts the most candidates
    above the 0.05 filter (``postprocess_load``). The classes of a proposal
    then score like normal draws, a few of COCO's 80 pass the filter for
    most proposals, and the postprocess gets more candidates than its NMS
    input cap (the caller checks it). A trained model's background row
    dominates: scaling its weights leaves every foreground score below
    0.05. Returns (std, gain)."""
    import torch

    cls = model.box_predictor.cls_score
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        cls.weight.copy_(torch.randn(cls.weight.shape, generator=g).to(cls.weight))
        cls.bias.zero_()
    logits = []
    hook = cls.register_forward_hook(lambda m, a, out: logits.append(out.float()))
    try:
        with torch.inference_mode():
            model.detect(images, valid_hw)
    finally:
        hook.remove()
    unit = logits[0].std(dim=-1).mean().item()
    best, weight = None, cls.weight.detach().clone()
    for std in stds:
        with torch.no_grad():
            cls.weight.copy_(weight * (std / unit))
        n = sum(postprocess_load(model, images, valid_hw)["candidates"])
        if best is None or n > best[0]:
            best = (n, std)
    with torch.no_grad():
        cls.weight.copy_(weight * (best[1] / unit))
    return best[1], best[1] / unit


def postprocess_load(model, images, valid_hw) -> dict:
    """One detect's postprocess work: the valid proposals per image, the
    candidates above the score filter per image, the NMS input cap they are
    cut to, and the valid detections per image."""
    import torch

    from cald_tpu_torch.models import faster_rcnn, roi_heads

    seen, orig_nms, orig_post = [], roi_heads.batched_nms, faster_rcnn.postprocess_detections

    def counting_nms(*a, **k):
        seen.append((k["valid"].sum(dim=1).tolist(), k["pre_nms_size"]))
        return orig_nms(*a, **k)

    def counting_post(class_logits, box_regression, proposals, prop_valid, *a, **k):
        seen.append(prop_valid.sum(dim=1).tolist())
        return orig_post(class_logits, box_regression, proposals, prop_valid, *a, **k)

    roi_heads.batched_nms, faster_rcnn.postprocess_detections = counting_nms, counting_post
    try:
        with torch.inference_mode():
            dets = model.detect(images, valid_hw)
    finally:
        roi_heads.batched_nms, faster_rcnn.postprocess_detections = orig_nms, orig_post
    proposals, (candidates, cap) = seen
    return {"proposals": proposals, "candidates": candidates, "cap": cap,
            "valid": dets.valid.sum(dim=1).tolist()}


def profile_ms(fn) -> dict:
    """One call of ``fn`` (after a warm-up call) under ``torch.profiler``:
    the wall milliseconds to the synchronize (the profiler's overhead
    included), the device-busy milliseconds (the union of the CUDA events'
    intervals), the number of device events, and the five kernels with the
    most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end, by_name = 0.0, -math.inf, {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall, "device_ms": busy / 1e3, "events": len(spans),
            "top": [(name[:60], ms) for name, ms in top]}


def jittered_detections(dataset, per_image: int, seed: int) -> list[dict]:
    """``per_image`` detections an image for the COCO evaluator: ground-truth
    boxes moved by 10% of their size, a fifth of them relabelled at random,
    scores uniform in (0.05, 1)."""
    rng = np.random.default_rng(seed)
    num_classes = len(dataset.class_names)
    results = []
    for i in range(len(dataset)):
        rec = dataset.record(i)
        src = rng.integers(0, len(rec.boxes), per_image)
        wh = np.tile(rec.boxes[src, 2:] - rec.boxes[src, :2], 2)
        labels = np.where(rng.uniform(size=per_image) < 0.2,
                          rng.integers(1, num_classes, per_image), rec.labels[src])
        results.append({"dataset_index": i, "image_id": rec.image_id,
                        "boxes": (rec.boxes[src] + rng.normal(0, 0.1, wh.shape) * wh).astype(
                            np.float32),
                        "scores": rng.uniform(0.05, 1.0, per_image).astype(np.float32),
                        "labels": labels.astype(np.int32)})
    return results


def coco_al_phase(device, kernels: dict, card: str, workdir: str) -> dict:
    """Phase 15(a): ``al_loop`` on the synthetic COCO tree at COCO's
    resolved sizes (min 800 / max 1333, canvases 832x1344 and 1344x832, 81
    classes, pool cap 10000): Faster R-CNN R50-FPN, frozen norms, bf16, from
    a backbone written as phase 11's is but calibrated on this data (phase
    11's, calibrated on VOC's smooth images, starts COCO's random-pixel
    images at a classifier loss of ~60 and diverges within 3 steps), CALD
    with FCDR, 2 cycles of 1 epoch, batch 4, 16 initial images, budget 8,
    score batch 8. Checks finite losses, the
    labeled set grown by the budget, the 12 COCO stats finite, both canvases
    in training, evaluation and scoring, one K2 and one K3 per step, one K1
    per detect and the expected detects per stage; then a warm CALD score
    call (B=8) and a warm training step (B=4) on each canvas, the COCO
    evaluator's seconds per image and the peak device memory. Cycle 0's
    model finds nothing above 0.05 on these images, so its score calls and
    evaluations run on empty work: the score call is timed again on a copy
    with its class head redrawn and spread (``spread_classes_``: more
    candidates an image than the postprocess's 2048 NMS input cap, checked,
    and 100 detections), the evaluator again on 100 jittered ground-truth
    detections an image (AP50 above 0 checked), and one warm step and one
    loaded score call are traced with ``torch.profiler`` (device-busy
    against wall time)."""
    import torch

    from cald_tpu_torch.augment.suite import generator_draw
    from cald_tpu_torch.cli import driver
    from cald_tpu_torch.cli.config import ALConfig
    from cald_tpu_torch.data.batching import create_aspect_ratio_groups, default_canvases
    from cald_tpu_torch.data.pool import ALPoolState
    from cald_tpu_torch.engine import evaluate as ev
    from cald_tpu_torch.engine.checkpoint import load_checkpoint
    from cald_tpu_torch.engine.optim import RESNET_FROZEN_L3, make_sgd
    from cald_tpu_torch.engine.train import make_train_step
    from cald_tpu_torch.models.matcher import generator_gumbel
    from cald_tpu_torch.strategies.cald import CALDConfig, make_cald_score_fn

    root, datasets = _coco_data(workdir)
    train_ds, test_ds = datasets
    cfg = ALConfig(dataset="coco", data_path=root, strategy="cald", augs="FCDR", cycles=2,
                   epochs=1, batch_size=TRAIN_BATCH, init_num=16, budget_num=8,
                   score_batch_size=BATCH, workers=4, print_freq=1,
                   output_dir=os.path.join(workdir, "out"),
                   pretrained_backbone=os.path.join(workdir, "backbone.pt"),
                   device=device.type).resolve()
    canvases = default_canvases(cfg.min_size, cfg.max_size)
    if not ((cfg.min_size, cfg.max_size) == COCO_MIN_MAX
            and (cfg.num_classes, cfg.pool_cap) == (81, 10000)
            and tuple((c.height, c.width) for c in canvases) == COCO_CANVASES
            and len(train_ds.class_names) == 81):
        raise AssertionError(f"COCO's resolved sizes are not the reference's: {cfg}, {canvases}")
    write_calibrated_backbone(cfg, train_ds, device)
    groups = create_aspect_ratio_groups(train_ds.aspect_ratios(), cfg.aspect_ratio_group_factor)
    test_groups = create_aspect_ratio_groups(test_ds.aspect_ratios(),
                                             cfg.aspect_ratio_group_factor)
    # the detects al_loop must run: one per evaluation batch, two per score batch
    n_eval = len(driver._loaders(cfg, test_ds, range(len(test_ds)), batch_size=BATCH, train=False,
                                 canvases=canvases, group_ids=test_groups))
    subset = ALPoolState.initial(len(train_ds), cfg.init_num, cfg.seed).subsample_pool(
        cfg.pool_cap, np.random.default_rng(cfg.seed + 100))
    n_score = len(driver._loaders(cfg, train_ds, subset, batch_size=BATCH, train=False,
                                  canvases=canvases, group_ids=groups))

    eval_s = []
    coco_eval = ev.coco_evaluate_detections

    def timed_eval(results, dataset, **kw):
        t0 = time.perf_counter()
        stats = coco_eval(results, dataset, **kw)
        eval_s.append(time.perf_counter() - t0)
        return stats

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = StageCounts(driver, kernels, device)
    ev.coco_evaluate_detections = timed_eval
    try:
        with counts:
            t0 = time.perf_counter()
            history = driver.al_loop(cfg, datasets=datasets)
            wall = time.perf_counter() - t0
    finally:
        ev.coco_evaluate_detections = coco_eval
    peak = torch.cuda.max_memory_allocated()

    steps = len(counts.steps)
    by_stage = {st: sum(1 for s, _ in counts.detects if s == st) for st in ("eval", "score")}
    for h in history:
        e = h["eval"]
        print(f"coco al loop: cycle {h['cycle']}: labeled {h['labeled']}, AP {e['AP']:.4f}, "
              f"AP50 {e['AP50']:.4f}; wall {h['time_s']:.2f} s (train {h['split_s']['train']:.2f}, "
              f"eval {h['split_s']['eval']:.2f}, score {h['split_s']['score']:.2f}) on {card}; "
              f"stats {json.dumps(e)}")
    per_image = [s / len(test_ds) for s in eval_s]
    print(f"coco al loop: {steps} training steps, detects {by_stage} (want eval "
          f"{2 * n_eval}, score {2 * n_score}); launches by stage {json.dumps(counts.stages)}; "
          f"canvases {sorted(counts.canvases, key=str)}; COCO evaluator "
          f"{[f'{s:.3f}' for s in eval_s]} s over {len(test_ds)} images "
          f"({[f'{s * 1e3:.2f}' for s in per_image]} ms/image); peak device memory "
          f"{peak / 2 ** 30:.2f} GiB (score calls {max(counts.score_peak, default=0) / 2 ** 30:.2f}); "
          f"{wall:.2f} s on {card}")
    train_k, infer_k = counts.total("train"), counts.total("eval", "score")
    if not (steps > 0 and train_k["roi_align_train_fwd"] == steps
            and train_k["roi_align_bwd"] == steps and train_k["roi_align"] == 0
            and train_k["roi_align_group_fwd"] == 0):
        raise AssertionError(f"training did not launch K2 and K3 once per step: {train_k}")
    if not (infer_k["roi_align"] == len(counts.detects)
            and by_stage == {"eval": 2 * n_eval, "score": 2 * n_score}
            and infer_k["roi_align_train_fwd"] == 0 and infer_k["roi_align_bwd"] == 0):
        raise AssertionError(f"evaluation and scoring did not launch K1 once per detect: "
                             f"{infer_k}, {by_stage}")
    want_seen = {(st, c) for st in ("train", "eval", "score") for c in COCO_CANVASES}
    if not want_seen <= counts.canvases:
        raise AssertionError(f"not every stage ran on both canvases: "
                             f"{sorted(counts.canvases, key=str)}")
    if not all(math.isfinite(v) for d in counts.losses for v in d.values()):
        raise AssertionError("non-finite training losses")
    picked = history[0]["labeled"] - cfg.init_num
    if not (cfg.budget_num <= picked <= int(cfg.mr * cfg.budget_num)
            and history[1]["labeled"] == history[0]["labeled"]):
        raise AssertionError(f"the labeled set did not grow by the budget: {history}")
    if not all(len(h["eval"]) == 12 and all(math.isfinite(v) for v in h["eval"].values())
               for h in history):
        raise AssertionError("the 12 COCO stats are not all finite")

    # warm CALD score calls (B=8) and training steps (B=4) on each canvas,
    # from cycle 0's model
    model, _ = driver.build_model(cfg, len(train_ds.class_names))
    model.to(device)
    load_checkpoint(os.path.join(cfg.output_dir, "cycle_0"), model)
    score_fn = make_cald_score_fn(model, CALDConfig(), cfg.num_classes)
    loaded, _ = driver.build_model(cfg, len(train_ds.class_names))
    loaded.to(device)
    load_checkpoint(os.path.join(cfg.output_dir, "cycle_0"), loaded)
    loaded_fn = make_cald_score_fn(loaded, CALDConfig(), cfg.num_classes)
    draw = generator_draw(torch.Generator(device=device).manual_seed(SEED + 15))
    gumbel = generator_gumbel(torch.Generator(device=device).manual_seed(SEED + 16))
    step = make_train_step(model, make_sgd(model, FIXED_LR, frozen_prefixes=RESNET_FROZEN_L3))
    score_batches = {(b.images.shape[1], b.images.shape[2]): b for b in driver._loaders(
        cfg, train_ds, range(len(train_ds)), batch_size=BATCH, train=False, canvases=canvases,
        group_ids=groups) if len(b.image_idx) == BATCH}
    train_batches = {(b.images.shape[1], b.images.shape[2]): b for b in driver._loaders(
        cfg, train_ds, range(len(train_ds)), batch_size=TRAIN_BATCH, train=True,
        canvases=canvases, group_ids=groups, seed=SEED) if len(b.image_idx) == TRAIN_BATCH}
    timing, profiles = {}, {}
    for canvas in COCO_CANVASES:
        sb, tb = score_batches[canvas], train_batches[canvas]
        images = torch.from_numpy(sb.images).to(device)
        valid_hw = torch.from_numpy(sb.valid_hw).to(device)
        if not timing:
            spread, gain = spread_classes_(loaded, images, valid_hw, COCO_LOGIT_STDS,
                                           SEED + 18)
        score_fn(images, valid_hw, draw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        calls = [_warm_ms(lambda: score_fn(images, valid_hw, draw), 1) for _ in range(3)]
        score_peak = torch.cuda.max_memory_allocated()
        tbatch = [torch.from_numpy(np.asarray(a)).to(device) for a in (
            tb.images, tb.valid_hw, tb.boxes, tb.labels, tb.box_valid)]
        steps_ms = [_warm_ms(lambda: step(*tbatch, gumbel), 1) for _ in range(3)]
        load = postprocess_load(loaded, images, valid_hw)
        loaded_calls = [_warm_ms(lambda: loaded_fn(images, valid_hw, draw), 1) for _ in range(3)]
        key = f"{canvas[0]}x{canvas[1]}"
        timing[key] = {"score_ms_min": min(calls), "score_ms_median": float(np.median(calls)),
                       "score_peak_bytes": score_peak, "step_ms_min": min(steps_ms),
                       "step_ms_median": float(np.median(steps_ms)),
                       "loaded_score_ms_min": min(loaded_calls),
                       "loaded_score_ms_median": float(np.median(loaded_calls)),
                       "logit_std": spread, **load}
        print(f"coco time {key}: CALD score call of B={BATCH} min {min(calls):.1f} / median "
              f"{np.median(calls):.1f} ms ({BATCH / np.median(calls) * 1e3:.2f} images/s), peak "
              f"{score_peak / 2 ** 30:.2f} GiB; training step of B={TRAIN_BATCH} min "
              f"{min(steps_ms):.1f} / median {np.median(steps_ms):.1f} ms on {card}")
        print(f"coco time {key}: loaded CALD score call of B={BATCH} (class head redrawn, "
              f"logits spread to std {spread}, gain {gain:.3g}) min "
              f"{min(loaded_calls):.1f} / median {np.median(loaded_calls):.1f} ms; base detect: "
              f"valid proposals per image "
              f"{load['proposals']}, candidates above 0.05 {load['candidates']} (NMS input cap "
              f"{load['cap']}), valid detections {load['valid']} on {card}")
        if not (min(load["candidates"]) > load["cap"] and min(load["valid"]) > 0):
            raise AssertionError(f"the loaded score call's detect is not past the NMS input "
                                 f"cap: {load}")
        if not profiles:
            profiles = {"step": profile_ms(lambda: step(*tbatch, gumbel)),
                        "loaded_score": profile_ms(lambda: loaded_fn(images, valid_hw, draw))}
            for name, prof in profiles.items():
                unprofiled = (timing[key]["step_ms_median"] if name == "step"
                              else timing[key]["loaded_score_ms_median"])
                print(f"coco profile {key} {name}: wall {prof['wall_ms']:.1f} ms under the "
                      f"profiler ({unprofiled:.1f} ms without), device busy "
                      f"{prof['device_ms']:.1f} ms ({prof['device_ms'] / unprofiled:.3f} of the "
                      f"unprofiled wall), {prof['events']} device events; top "
                      f"{[(n, round(ms, 2)) for n, ms in prof['top']]} on {card}")
    del model, score_fn, step, loaded, loaded_fn
    torch.cuda.empty_cache()

    quiet = lambda *_: None  # noqa: E731
    t0 = time.perf_counter()
    loaded_stats = ev.coco_evaluate_detections(
        jittered_detections(test_ds, COCO_EVAL_DETS, SEED + 17), test_ds, print_fn=quiet)
    loaded_eval_s = time.perf_counter() - t0
    print(f"coco evaluator on {COCO_EVAL_DETS} jittered ground-truth detections an image: "
          f"{loaded_eval_s:.3f} s over {len(test_ds)} images "
          f"({loaded_eval_s / len(test_ds) * 1e3:.2f} ms/image), AP {loaded_stats['AP']:.4f}, "
          f"AP50 {loaded_stats['AP50']:.4f} on {card}")
    if not (len(loaded_stats) == 12 and loaded_stats["AP50"] > 0
            and all(math.isfinite(v) for v in loaded_stats.values())):
        raise AssertionError(f"the COCO evaluator on jittered ground truth: {loaded_stats}")
    return {"history": history, "steps": steps, "launches": counts.launches,
            "detects": by_stage, "eval_s": eval_s, "eval_s_per_image": per_image,
            "peak_bytes": peak, "timing": timing, "profiles": profiles,
            "loaded_eval_s_per_image": loaded_eval_s / len(test_ds), "wall_s": wall, "root": root,
            "backbone": cfg.pretrained_backbone, "train_launches": train_k}


def coco_train_cli_phase(device, kernels: dict, card: str, workdir: str, root: str,
                         backbone: str) -> dict:
    """Phase 15(c): ``python -m cald_tpu_torch.cli.train``'s ``main`` on the
    phase's COCO tree: one epoch with ``--output-dir``, then ``--resume``
    from its ``last/`` for the second; finite losses, the epoch carried
    across the resume, the 12 COCO stats finite, one K2 and one K3 per step
    and one K1 per evaluation detect."""
    from cald_tpu_torch.cli import driver
    from cald_tpu_torch.cli import train as train_cli
    from cald_tpu_torch.engine.checkpoint import peek_checkpoint

    out = os.path.join(workdir, "train_out")
    argv = ["--dataset", "coco", "--data-path", root, "-b", str(TRAIN_BATCH),
            "--score-batch-size", str(BATCH), "-j", "4", "--print-freq", "4",
            "--pretrained-backbone", backbone, "--output-dir", out, "--device", device.type]
    runs = []
    t0 = time.perf_counter()
    for extra in (["--epochs", "1"], ["--epochs", "2", "--resume", os.path.join(out, "last")]):
        counts = StageCounts(driver, kernels, device)
        with counts:
            run = train_cli.main(argv + extra)
        meta = peek_checkpoint(os.path.join(out, "last"))[2]
        runs.append((run, meta, counts))
        steps = len(counts.steps)
        print(f"coco cli.train {' '.join(extra)}: start epoch {run['start_epoch']}, losses "
              f"{run['losses']}, saved epoch {meta['epoch']}, {steps} steps, "
              f"{len(counts.detects)} detects, launches {counts.launches}, AP "
              f"{run['eval']['AP']:.4f}")
        k = counts.launches
        if not (steps > 0 and k["roi_align_train_fwd"] == steps and k["roi_align_bwd"] == steps
                and k["roi_align"] == len(counts.detects) > 0 and k["roi_align_group_fwd"] == 0):
            raise AssertionError(f"cli.train: not one K2/K3 per step and one K1 per detect: {k}")
        if not all(math.isfinite(v) for d in counts.losses for v in d.values()):
            raise AssertionError("cli.train: non-finite training losses")
        if not (len(run["eval"]) == 12 and all(math.isfinite(v) for v in run["eval"].values())):
            raise AssertionError("cli.train: the 12 COCO stats are not all finite")
    (first, meta0, _), (second, meta1, _) = runs
    if not (first["start_epoch"] == 0 and list(first["losses"]) == [0] and meta0["epoch"] == 0
            and second["start_epoch"] == 1 and list(second["losses"]) == [1]
            and meta1["epoch"] == 1):
        raise AssertionError("cli.train: the epoch did not carry across --resume")
    wall = time.perf_counter() - t0
    print(f"coco cli.train: two runs {wall:.2f} s on {card}")
    return {"losses": {**first["losses"], **second["losses"]}, "eval": second["eval"],
            "steps": [len(c.steps) for _, _, c in runs], "wall_s": wall}


# --------------------------------------------------------------------------
# phase 16: multi-process data parallelism, the shrink slice, CIFAR
# --------------------------------------------------------------------------

DP_WORLD = 2                     # ranks, both on the one card, over gloo
SLICE_CANVAS = (512, 832)        # ceil64(0.8 x 640x1024): the resize's detect canvas
SLICE_VALID_HW = (480, 800)      # 0.8 x VALID_HW
DP_LR = 0.01
# the CIFAR demo at full width (ResNet-18 width 64, batch 128, LossNet 128),
# cut from 50000/10000 images, subset 10000, addendum 1000, 3 trials x 10
# cycles x 200 epochs (milestone 160, detach after 120)
CIFAR_CUT = dict(num_train=5000, batch=128, subset=2000, addendum=1000, trials=1, cycles=2,
                 epochs=6, milestones=(5,), epoch_loss=4, width=64, interm_dim=128, seed=SEED)
CIFAR_TEST = 1000


def dp_worker():
    """``tests/torch_dp_worker.py``, the rank script of phase 16: each rank
    is a subprocess of it (it imports torch and the port only)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_dp_worker

    return torch_dp_worker


def dp_al_phase(device, card: str, workdir: str, backbone: str, backend: str = "gloo") -> dict:
    """Phase 16(a): ``al_loop`` on two ranks sharing the card over gloo, at
    phase 11's data and cut (batch 4 a rank, CALD 'FCDR', CALD_TPU_ROI_GROUP
    unset) from phase 11's backbone, then one ``--resume`` from cycle 0's
    checkpoint. Checks: both ranks' histories alike (labeled digests and
    mAP), labeled 16 -> 24 (or 25, phase 11's rule), every epoch at the
    agreed step count, one K2 and one K3 a step and one K1 a detect on each
    rank, the checkpoints written by rank 0 alone, the resumed run's
    selections those of the uninterrupted run."""
    worker = dp_worker()
    train_root, _ = _al_data(workdir)
    out = os.path.join(workdir, "out")
    cfg = dict(data_path=train_root, strategy="cald", augs="FCDR", cycles=2, epochs=1,
               batch_size=TRAIN_BATCH, init_num=16, budget_num=8, score_batch_size=BATCH,
               workers=4, print_freq=1, output_dir=out, pretrained_backbone=backbone,
               device=device.type)
    payload = {"task": "al_loop", "cfg": cfg, "count_kernels": True,
               "datasets": {"train": (train_root, "trainval"),
                            "test": (os.path.join(workdir, "test"), "test")}}
    runs = {}
    t0 = time.perf_counter()
    for label, extra in (("run", {}), ("resume", {"resume": os.path.join(out, "cycle_0"),
                                                   "output_dir": ""})):
        t = time.perf_counter()
        ranks = worker.launch({**payload, "cfg": {**cfg, **extra}},
                              os.path.join(workdir, label), world=DP_WORLD, backend=backend,
                              timeout=600)
        runs[label] = ranks
        for r, res in enumerate(ranks):
            for h in res["history"]:
                if "split_s" in h:
                    print(f"dp al loop ({backend}) {label} rank {r}: cycle {h['cycle']}: labeled "
                          f"{h['labeled']}, mAP {h['eval'].get('mAP')}; wall {h['time_s']:.2f} s (train "
                          f"{h['split_s']['train']:.2f}, eval {h['split_s']['eval']:.2f}, "
                          f"score {h['split_s']['score']:.2f}) on {card}, {DP_WORLD} ranks "
                          + ("sharing the card (not a scaling number)" if backend == "gloo"
                             else "on their own cards"))
            print(f"dp al loop {label} rank {r}: agreed steps a epoch {res['steps']}, run "
                  f"{res['steps_run']}; {len(res['detects'])} detects; launches "
                  f"{res['launches']}; checkpoint writes {res['saves']}")
        print(f"dp al loop {label}: {time.perf_counter() - t:.2f} s for both ranks' processes")
        keys = [[(h.get("labeled_digest"), h.get("eval", {}).get("mAP")) for h in res["history"]]
                for res in ranks]
        if any(k != keys[0] for k in keys):
            raise AssertionError(f"dp al loop {label}: the ranks' histories differ: {keys}")
        for res in ranks:
            steps, k = sum(res["steps_run"]), res["launches"]
            if not (res["steps_run"] == res["steps"] == ranks[0]["steps"]):
                raise AssertionError(f"dp al loop {label}: epochs not at the agreed step count")
            if not (k["roi_align_train_fwd"] == steps and k["roi_align_bwd"] == steps
                    and k["roi_align"] == len(res["detects"]) > 0
                    and k["roi_align_group_fwd"] == 0):
                raise AssertionError(f"dp al loop {label}: not one K2/K3 a step and one K1 a "
                                     f"detect: {k}, {steps} steps, {len(res['detects'])} detects")
        if label == "run":
            hist = ranks[0]["history"]
            picked = hist[0]["labeled"] - cfg["init_num"]
            if not (cfg["budget_num"] <= picked <= int(1.2 * cfg["budget_num"])
                    and hist[1]["labeled"] == hist[0]["labeled"]):
                raise AssertionError(f"dp al loop: the labeled set did not grow by the budget")
            if not all(math.isfinite(h["eval"]["mAP"]) for h in hist):
                raise AssertionError("dp al loop: non-finite VOC mAP")
            if not (ranks[0]["saves"] == 2 and all(r["saves"] == 0 for r in ranks[1:])
                    and os.path.isfile(os.path.join(out, "cycle_0", "model.pt"))):
                raise AssertionError("dp al loop: the checkpoints were not written by rank 0 alone")
    digests = [[h.get("labeled_digest") for h in runs[k][0]["history"]] for k in runs]
    print(f"dp al loop: labeled digests {digests[0]} uninterrupted, {digests[1]} resumed")
    if digests[0] != digests[1]:
        raise AssertionError("dp al loop: the resumed run selected otherwise")
    steps = sum(runs["run"][0]["steps_run"])
    return {"history": runs["run"][0]["history"], "steps": steps,
            "launches": runs["run"][0]["launches"], "wall_s": time.perf_counter() - t0}


def dp_step_phase(device, card: str, workdir: str, backend: str = "gloo") -> dict:
    """Phase 16(b): one training step of phase 7's R50-FPN in f32 (TF32 off,
    conv1 and layer1 frozen, SGD lr 0.01) on the global batch of 4 images,
    three ways from the same weights and draws: two ranks at B=2 (the rows
    of the draws each), this process over the same two halves with their
    gradients accumulated (the ranks' arithmetic without the collectives),
    and this process at B=4 in one pass. Checks: the ranks bit-equal; the
    ranks against the halves: the losses within 1e-5 relative and every
    parameter's change within 1e-3 of the step's largest change (K3's
    atomics add in a different order from run to run). The one pass at B=4
    is printed beside them, not gated: cuDNN picks other algorithms for
    B=4 than for B=2, and the detector's sampled rois follow rounding where
    proposal scores nearly tie (on the CPU one process on 1 and on 4
    threads differs by 7e-4 of the largest change)."""
    import torch

    from cald_tpu_torch.engine.optim import RESNET_FROZEN_L3, make_sgd
    from cald_tpu_torch.engine.train import make_train_step
    from cald_tpu_torch.models.faster_rcnn import FasterRCNN
    from cald_tpu_torch.models.matcher import generator_gumbel

    worker = dp_worker()
    model = build_model(device, compute_dtype="float32", amplify_heads=False).train()
    spec = {"kind": "faster", "cfg": model.cfg, "device": device.type,
            "state_dict": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}}
    bt = make_train_batches(1)[0]
    batch = (bt.images, bt.valid_hw, bt.boxes, bt.labels, bt.box_valid)
    tensors = [torch.from_numpy(a).to(device) for a in batch]
    draw = generator_gumbel(torch.Generator(device=device).manual_seed(SEED + 16))
    draws = {}

    def recording(stream, shape):
        out = draw(stream, shape)
        draws[stream] = out.cpu().numpy()
        return out

    def params(m):
        return {n: p.detach().cpu() for n, p in m.named_parameters()}

    step = make_train_step(model, make_sgd(model, DP_LR, frozen_prefixes=RESNET_FROZEN_L3))
    one_pass = {k: float(v) for k, v in step(*tensors, recording).items()}
    one_pass_params = params(model)

    halves = FasterRCNN(model.cfg)
    halves.load_state_dict(spec["state_dict"])
    halves.to(device).train()
    opt = make_sgd(halves, DP_LR, frozen_prefixes=RESNET_FROZEN_L3)
    opt.zero_grad(set_to_none=True)
    metrics: dict = {}
    b = TRAIN_BATCH // DP_WORLD
    for h in range(DP_WORLD):
        rows = slice(h * b, (h + 1) * b)
        losses, _ = halves.loss(*(t[rows] for t in tensors),
                                lambda i, shape: torch.from_numpy(draws[i][rows]).to(device))
        total = sum(losses.values())
        (total / DP_WORLD).backward()
        for k, v in {**losses, "loss": total}.items():
            metrics[k] = metrics.get(k, 0.0) + v.item() / DP_WORLD
    opt.step()
    want = params(halves)
    del model, halves
    torch.cuda.empty_cache()

    t = time.perf_counter()
    ranks = worker.launch({"task": "step", "model": spec, "batch": batch, "draws": draws,
                           "lr": DP_LR, "frozen": RESNET_FROZEN_L3},
                          os.path.join(workdir, "step"), world=DP_WORLD, backend=backend,
                          timeout=600)
    before = spec["state_dict"]

    def errors(got_metrics, got):
        loss = max(abs(got_metrics[k] - v) / abs(v) for k, v in metrics.items())
        scale = max(float((w - before[n]).abs().max()) for n, w in want.items())
        change = max(float((got[n] - w).abs().max()) for n, w in want.items()) / scale
        return loss, change

    loss_err, change_err = max(errors(r["metrics"], r["params"]) for r in ranks)
    pass_loss, pass_change = errors(one_pass, one_pass_params)
    same = all(torch.equal(r["params"][n], ranks[0]["params"][n]) for r in ranks[1:]
               for n in want)
    print(f"dp step ({backend}): R50-FPN f32, {DP_WORLD} ranks x B={b} against this process over the "
          f"same halves: losses {metrics}, max relative loss error {loss_err:.3e} (limit "
          f"1e-5), changes max error {change_err:.3e} of the largest change (limit 1e-3); "
          f"ranks bit-equal {same}; one pass at B={TRAIN_BATCH} against the halves: loss "
          f"{pass_loss:.3e}, changes {pass_change:.3e} (not gated); "
          f"{time.perf_counter() - t:.2f} s for the ranks' processes on {card}")
    if not (loss_err <= 1e-5 and change_err <= 1e-3 and same):
        raise AssertionError("the two-rank step is not the step of the global batch")
    return {"loss_err": loss_err, "change_err": change_err, "one_pass_loss_err": pass_loss,
            "one_pass_change_err": pass_change}


def shrink_slice_phase(model, device, pool, kernels: dict, full_ms: float, card: str) -> dict:
    """Phase 16(c), on phase 4's model and pool: the CALD scorer with
    ``shrink_slice``: three K1 launches a score call (base, the three
    full-canvas augs, the resize on 512x832), K1 at the slice's shapes
    against its plain version at phase 3's limits with its time and bound,
    the consistency and selection against the full canvas on the same
    draws, and warm score calls against phase 5's."""
    import torch

    from cald_tpu_torch.augment.suite import generator_draw
    from cald_tpu_torch.strategies.cald import (
        CALDConfig, cald_select, make_cald_score_fn, score_pool,
    )

    shapes = []
    detect = model.detect

    def counting_detect(images, valid_hw):
        shapes.append(tuple(images.shape[:3]))
        return detect(images, valid_hw)

    out = {}
    for shrink in (True, False):
        cfg = CALDConfig(shrink_slice=shrink)
        fn = make_cald_score_fn(model, cfg, NUM_CLASSES)
        gen = torch.Generator(device=device).manual_seed(SEED)
        model.detect = counting_detect
        try:
            shapes.clear()
            for k in kernels.values():
                k.launches = 0
            cons, corrs = score_pool(fn, pool, list(range(BATCH * len(pool))), gen)
            launches = {n: k.launches for n, k in kernels.items()}
        finally:
            del model.detect
        labeled_mean = np.random.default_rng(SEED).uniform(0, 2, NUM_CLASSES - 1)
        out[shrink] = {"fn": fn, "cons": cons, "launches": launches, "shapes": list(shapes),
                       "selected": cald_select(cons, corrs, labeled_mean, BUDGET, cfg)}
    s, f = out[True], out[False]
    per_call = s["launches"]["roi_align"] / len(pool)
    diff = np.abs(s["cons"] - f["cons"])
    overlap = len(set(s["selected"].tolist()) & set(f["selected"].tolist())) / BUDGET
    print(f"shrink slice: detect shapes {s['shapes'][:3]} a score call; launches {s['launches']} "
          f"over {len(pool)} calls ({per_call:g} K1 a call); consistency against the full "
          f"canvas on the same draws: mean |diff| {diff.mean():.4e}, max {diff.max():.4e}; "
          f"selections {s['selected'].tolist()} vs {f['selected'].tolist()}, overlap "
          f"{overlap:.3f}")
    if not (per_call == 3 and s["shapes"][:3] == [(BATCH, *CANVAS), (3 * BATCH, *CANVAS),
                                                    (BATCH, *SLICE_CANVAS)]):
        raise AssertionError("the shrink slice did not detect three times a call on its canvases")
    if not (np.isfinite(s["cons"]).all() and s["cons"].min() >= 0 and s["cons"].max() <= 1):
        raise AssertionError("shrink slice: consistency not finite or outside [0, 1]")
    entry = kernel_phase(device, canvas=SLICE_CANVAS, valid_hw=SLICE_VALID_HW,
                         label="shrink slice kernel")
    images = torch.from_numpy(pool[0].images).to(device)
    valid_hw = torch.from_numpy(pool[0].valid_hw).to(device)
    draw = generator_draw(torch.Generator(device=device).manual_seed(SEED + 3))
    ms = _warm_ms(lambda: s["fn"](images, valid_hw, draw), 5)
    print(f"shrink slice: 5 warm score calls of B={BATCH}: {ms:.1f} ms/call against the full "
          f"canvas's {full_ms:.1f} (phase 5), {BATCH / ms * 1e3:.2f} images/s on {card}")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "bound_bytes", "max_abs_err",
            "max_abs_err_f32")
    return {"kernel": {**{k: entry[k] for k in keys}, "launches_per_score_call": per_call},
            "mean_abs_diff": float(diff.mean()), "overlap": overlap, "score_ms": ms}


def cifar_phase(device, card: str) -> dict:
    """Phase 16(d): ``al_cifar_loop`` at full width (CIFAR_CUT) on
    ``synthetic_cifar``, f32 (TF32 off): finite losses, the labeled set
    grown by ``addendum`` each cycle, test accuracy above 50% after the last
    cycle (tests/test_cifar.py's limit); then warm joint steps at batch 128
    (ms, images/s)."""
    import torch

    from cald_tpu_torch.cifar import (
        CifarALConfig, CifarLL4AL, al_cifar_loop, augment_draws, synthetic_cifar,
    )

    cfg = CifarALConfig(**CIFAR_CUT)
    data = synthetic_cifar(num_train=cfg.num_train, num_test=CIFAR_TEST, seed=SEED)
    losses = []
    step = CifarLL4AL.train_step

    def recording(self, *a, **k):
        m = step(self, *a, **k)
        losses.append(m["loss"])
        return m

    CifarLL4AL.train_step = recording
    t0 = time.perf_counter()
    try:
        hist = al_cifar_loop(cfg, *data, print_fn=lambda line: print(f"cifar: {line}"),
                             device=device)
    finally:
        CifarLL4AL.train_step = step
    wall = time.perf_counter() - t0
    finite = bool(torch.isfinite(torch.stack(losses)).all())
    print(f"cifar: {len(losses)} joint steps, losses finite {finite}, history {hist}; "
          f"{wall:.2f} s on {card}")
    if not finite:
        raise AssertionError("cifar: non-finite losses")
    if [h["labeled"] for h in hist] != [cfg.addendum * (c + 1) for c in range(cfg.cycles)]:
        raise AssertionError("cifar: the labeled set did not grow by the addendum")
    if not hist[-1]["acc"] > 50.0:
        raise AssertionError(f"cifar: test accuracy {hist[-1]['acc']} not above 50%")

    model = CifarLL4AL(cfg, cfg.addendum // cfg.batch, device)
    images = torch.from_numpy(data[0][: cfg.batch]).to(device)
    labels = torch.from_numpy(data[1][: cfg.batch]).to(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    ms = _warm_ms(lambda: model.train_step(images, labels, *augment_draws(gen, cfg.batch),
                                           detach=False), 20)
    print(f"cifar: 20 warm joint steps at batch {cfg.batch}, width {cfg.width}: {ms:.2f} "
          f"ms/step, {cfg.batch / ms * 1e3:.1f} images/s on {card}")
    return {"history": hist, "step_ms": ms, "wall_s": wall}


def nccl_check() -> int:
    """``chip_smoke.py --nccl``, outside the smoke run: phase 16's helpers
    on two ranks over NCCL, one card a rank (``rank % device_count``). With
    one card NCCL refuses the second rank on the same device: prints the
    ranks' message and exits 0. With two or more the helpers must give
    their definitions' results, and phase 16(a)'s loop and (b)'s step run
    over NCCL, a card a rank."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    n = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as workdir:
        try:
            out = dp_worker().launch({"task": "helpers", "n": 7}, workdir, world=DP_WORLD,
                                     backend="nccl", timeout=300)
        except RuntimeError as e:
            print(f"nccl: {DP_WORLD} ranks on {n} card(s) failed:\n{e}")
            return 0 if n < DP_WORLD else 1
        print(f"nccl: {DP_WORLD} ranks on {n} cards: {out}")
        idx = np.arange(7)
        padded = np.concatenate([idx, idx[:1]])
        for r, res in enumerate(out):
            if not (np.array_equal(res["shard"], padded[r::DP_WORLD])
                    and np.array_equal(res["merge"], np.arange(6.0) * 3)
                    and res["sync_len"] == 3 and res["gather"] == [0.0, 0.0, 1.0, 1.0]
                    and [o["rank"] for o in res["objects"]] == [0, 1]):
                raise AssertionError(f"nccl: rank {r}'s helpers are wrong: {res}")
        from cald_tpu_torch.ops.roi_align_cuda import roi_align_kernel

        roi_align_kernel.load()
        device = torch.device("cuda", 0)
        dp_step_phase(device, card, workdir, backend="nccl")
        from cald_tpu_torch.cli.config import ALConfig

        train_root, datasets = _al_data(os.path.join(workdir, "p11"))
        cfg = ALConfig(data_path=train_root, batch_size=TRAIN_BATCH, device="cuda",
                       pretrained_backbone=os.path.join(workdir, "backbone.pt")).resolve()
        write_calibrated_backbone(cfg, datasets[0], device)
        dp_al_phase(device, card, os.path.join(workdir, "p16"), cfg.pretrained_backbone,
                    backend="nccl")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; there is no CPU path", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--nccl"]:
        return nccl_check()
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
    shrink = shrink_slice_phase(model, device, pool, all_kernels, dt / reps * 1e3, card)
    kernel["shrink_slice"] = shrink["kernel"]
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
        al = al_loop_phase(device, all_kernels, card, os.path.join(workdir, "p11"))
        group_kernel["launches"] = al["launches"]["roi_align_group_fwd"]
        group_kernel["launches_per_step"] = al["launches"]["roi_align_group_fwd"] / al["steps"]

        t12 = time.perf_counter()
        group_pyramid_check(device)
        group = group_al_phase(device, all_kernels, card, os.path.join(workdir, "p12"))
        learn = learnability_phase(device, all_kernels, card, os.path.join(workdir, "p12"))
        print(f"phase 12: {time.perf_counter() - t12:.2f} s on {card}")
        kernel["launches_per_score_call"] = group["launches_per_score_call"]
        for entry, name in zip(train_kernels, ("roi_align_train_fwd", "roi_align_bwd")):
            entry["launches_group_norm_per_step"] = group["train_launches"][name] / group["steps"]

        t13 = time.perf_counter()
        p13 = os.path.join(workdir, "p13")
        ll4al = ll4al_phase(device, all_kernels, card, p13, al["backbone"])
        vaal = vaal_phase(device, all_kernels, card, p13, al["backbone"])
        ssm = ssm_phase(device, all_kernels, card, p13, al["backbone"], learn)
        print(f"phase 13: {time.perf_counter() - t13:.2f} s on {card}")

        t14 = time.perf_counter()
        p14 = os.path.join(workdir, "p14")
        retina = retina_phase(device, all_kernels, card, p14, al["backbone"])
        mobile = mobilenet_phase(device, all_kernels, card, p14)
        print(f"phase 14: {time.perf_counter() - t14:.2f} s on {card}")

        t15 = time.perf_counter()
        p15 = os.path.join(workdir, "p15")
        coco = coco_al_phase(device, all_kernels, card, p15)
        coco_kernels = coco_kernel_phase(device, card)
        coco_train_cli_phase(device, all_kernels, card, p15, coco["root"], coco["backbone"])
        print(f"phase 15: {time.perf_counter() - t15:.2f} s on {card}")

        t16 = time.perf_counter()
        p16 = os.path.join(workdir, "p16")
        dp = dp_al_phase(device, card, p16, al["backbone"])
        dp_step_phase(device, card, p16)
        cifar_phase(device, card)
        print(f"phase 16: {time.perf_counter() - t16:.2f} s on {card}")
    dl = dp["launches"]
    kernel["launches_dp"] = {"launches_rank0": dl["roi_align"]}
    for entry, name in zip(train_kernels, ("roi_align_train_fwd", "roi_align_bwd")):
        entry["launches_dp"] = {"launches_rank0": dl[name], "steps_rank0": dp["steps"]}
    ml = mobile["launches"]
    kernel["launches_mobilenet"] = {"launches": ml["roi_align"], "detects": ml["detects"],
                                    "per_detect": ml["roi_align"] / ml["detects"]}
    kernel["mobilenet_two_levels"] = mobile["check"]
    for entry, name in zip(train_kernels, ("roi_align_train_fwd", "roi_align_bwd")):
        entry["launches_mobilenet"] = {"launches": ml[name], "steps": ml["steps"],
                                       "per_step": ml[name] / ml["steps"]}
    kernel["launches_ssm"] = {k: ssm["cv"][k] for k in ("detects", "redetects")}
    for entry, name in zip(train_kernels, ("roi_align_train_fwd", "roi_align_bwd")):
        entry["launches_ll4al"] = {"launches": ll4al["train_launches"][name],
                                   "joint_steps": ll4al["joint_steps"]}
        entry["launches_vaal"] = {"launches": vaal["train_launches"][name],
                                  "task_steps": vaal["task_steps"]}

    coco_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "bound_bytes", "max_abs_err",
                 "max_abs_err_f32")
    cl = coco["launches"]
    kernel["launches_coco"] = {"launches": cl["roi_align"], "detects": coco["detects"]}
    for entry, name in zip(train_kernels, ("roi_align_train_fwd", "roi_align_bwd")):
        entry["launches_coco"] = {"launches": cl[name], "steps": coco["steps"]}
    for entry, name in zip((kernel, *train_kernels),
                           ("roi_align", "roi_align_train_fwd", "roi_align_bwd")):
        entry["coco"] = {key: {k: v[name][k] for k in coco_keys}
                         for key, v in coco_kernels.items()}

    print(json.dumps({"kernels": [kernel, train_kernels[0], train_kernels[1], group_kernel,
                                  *bneck_kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
