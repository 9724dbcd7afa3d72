"""How far scoring variants move CALD's scores and selection (port of
``experiments/scoring_deviation.py``).

A group-norm Faster R-CNN R50-FPN (the driver's ``build_model``, bf16) is
trained briefly on synthetic scenes, then a pool is scored through
``make_cald_score_fn`` in several configurations on the same weights and
the same augmentation draws: the reference-faithful path (RPN 1000/1000,
the full canvas), trimmed RPN counts, the shrink slice, the window RoIAlign
(``CALD_TPU_ROI_FLM=0``: K2, or K4 under ``CALD_TPU_ROI_GROUP``) instead of
K1, float32 numerics, and the faithful path with re-rolled augmentations,
whose distance from the faithful path is the floor a variant is judged
against. Each configuration is compared with ``faithful``: per-image score
deltas, rank correlation, stage-1 candidate overlap and the Jaccard index
of the two-stage selections.

    python -m cald_tpu_torch.experiments.scoring_deviation [--steps 300]
        [--pool 512] [--budget 50] [--seeds 3] [--seed-start 0]
        [--score-batch 32] [--bank 96] [--model faster|retina]
        [--device cuda|cpu] [--tiny] [--hw 600 1000]

``DEVIATION_CONFIGS`` picks the configuration set (``CONFIG_SETS``): unset
for the default set, or ``gate``, ``mild``, ``mild640``, ``shrink``,
``flm`` or ``r5``; ``--model retina`` always runs the RetinaNet top-k set. Prints
one JSON line per (seed, config) and a summary block. ``--tiny`` and
``--hw`` shrink the run for the CPU.

Random streams: the scenes are the JAX script's (NumPy, the same seeds);
the training's sampling noise comes from a ``torch.Generator`` seeded with
the seed, the augmentation draws from one seeded with ``7000 + seed``,
fresh for every configuration so that all see the same draws, and
``faithful(keyB)``'s from one seeded as JAX folds 9999 into its key
(``cli.driver.stream_generator``).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import time

import numpy as np
import torch

from cald_tpu_torch.augment.suite import generator_draw
from cald_tpu_torch.cli.config import ALConfig
from cald_tpu_torch.cli.driver import _scoring_model, build_model, run_device, stream_generator
from cald_tpu_torch.engine.optim import make_sgd
from cald_tpu_torch.engine.schedules import lr_scheduler, multistep_with_warmup
from cald_tpu_torch.engine.train import make_train_step
from cald_tpu_torch.models.init import random_init_
from cald_tpu_torch.models.matcher import generator_gumbel
from cald_tpu_torch.strategies.cald import CALDConfig, cald_select, make_cald_score_fn

CANVAS = (640, 1024)
VALID = (600, 1000)
NUM_CLASSES = 21
MAX_BOXES = 8
ALT_KEY = 9999                  # JAX's fold_in(key, 9999) for faithful(keyB)

# class-coded base colors (20 fg classes), textured so features are non-flat
_PALETTE = np.stack([
    np.array([(37 * (i + 3)) % 200 + 30,
              (91 * (i + 7)) % 200 + 30,
              (53 * (i + 11)) % 200 + 30], np.float32)
    for i in range(NUM_CLASSES - 1)
])

_FAITHFUL = dict(rpn_pre=0, rpn_post=0, shrink=False)
_KEY_B = dict(_FAITHFUL, alt_key=True)
# the configuration sets of the JAX script, by DEVIATION_CONFIGS; ``flm``
# False is the window RoIAlign (CALD_TPU_ROI_FLM=0), True K1, absent the
# environment's choice; ``f32`` scores the same weights in float32
# (``float32_copy``)
CONFIG_SETS = {
    "default": {
        "faithful": _FAITHFUL,
        "faithful+slice": dict(rpn_pre=0, rpn_post=0, shrink=True),
        "fast(400/256)": dict(rpn_pre=400, rpn_post=256, shrink=False),
        "fast+slice": dict(rpn_pre=400, rpn_post=256, shrink=True),
        "fast(400/128)": dict(rpn_pre=400, rpn_post=128, shrink=True),
    },
    # the selection gate: the port's bf16 Hopper path against float32, the
    # window RoIAlign, the adopted trim and the slice, each beside the floor
    "gate": {
        "faithful": dict(_FAITHFUL, flm=True),
        "faithful(keyB)": dict(_KEY_B, flm=True),
        "f32": dict(_FAITHFUL, flm=True, f32=True),
        "window": dict(_FAITHFUL, flm=False),
        "mild(1000/768)": dict(rpn_pre=0, rpn_post=768, shrink=False, flm=True),
        "faithful+slice": dict(rpn_pre=0, rpn_post=0, shrink=True, flm=True),
    },
    "mild640": {
        "faithful": _FAITHFUL,
        "faithful(keyB)": _KEY_B,
        "mild(1000/768)": dict(rpn_pre=0, rpn_post=768, shrink=False),
        "mild(1000/640)": dict(rpn_pre=0, rpn_post=640, shrink=False),
    },
    "shrink": {
        "faithful": dict(_FAITHFUL, flm=False),
        "faithful(keyB)": dict(_KEY_B, flm=False),
        "faithful+slice": dict(rpn_pre=0, rpn_post=0, shrink=True, flm=False),
        "mild(1000/768)": dict(rpn_pre=0, rpn_post=768, shrink=False, flm=False),
        "768+slice": dict(rpn_pre=0, rpn_post=768, shrink=True, flm=False),
    },
    "r5": {
        "faithful": dict(_FAITHFUL, flm=False),
        "faithful(keyB)": dict(_KEY_B, flm=False),
        "mild(1000/768)": dict(rpn_pre=0, rpn_post=768, shrink=False, flm=False),
        "faithful+flm": dict(_FAITHFUL, flm=True),
        "768+flm": dict(rpn_pre=0, rpn_post=768, shrink=False, flm=True),
        "faithful+slice": dict(rpn_pre=0, rpn_post=0, shrink=True, flm=False),
        "768+slice": dict(rpn_pre=0, rpn_post=768, shrink=True, flm=False),
    },
    "flm": {
        "faithful": dict(_FAITHFUL, flm=False),
        "faithful(keyB)": dict(_KEY_B, flm=False),
        "faithful+flm": dict(_FAITHFUL, flm=True),
        "768+flm": dict(rpn_pre=0, rpn_post=768, shrink=False, flm=True),
    },
    "mild": {
        "faithful": _FAITHFUL,
        "faithful(keyB)": _KEY_B,
        "mild(1000/768)": dict(rpn_pre=0, rpn_post=768, shrink=False),
        "mild(1000/512)": dict(rpn_pre=0, rpn_post=512, shrink=False),
        "mild(600/384)": dict(rpn_pre=600, rpn_post=384, shrink=False),
    },
    # RetinaNet's trim analog (per-level topk_candidates); rpn_pre unused
    "retina": {
        "faithful": _FAITHFUL,
        "faithful(keyB)": _KEY_B,
        "topk768": dict(rpn_pre=0, rpn_post=768, shrink=False),
        "topk512": dict(rpn_pre=0, rpn_post=512, shrink=False),
    },
}


def canvas_for(hw) -> tuple[int, int]:
    """The canvas a scene of ``hw`` is pasted on: each side rounded up to
    a multiple of 64 (``CANVAS`` for ``VALID``)."""
    return tuple(int(math.ceil(s / 64)) * 64 for s in hw)


def make_scene(rng: np.random.Generator, hw=VALID):
    """One scene of ``hw`` (600x1000 unless given): textured background +
    1..6 textured objects (rectangles/ellipses, sizes 60..380 px, aspects
    0.4..2.5, may overlap)."""
    h, w = hw
    base = rng.uniform(60, 180, (3,)).astype(np.float32)
    img = np.broadcast_to(base, (h, w, 3)).copy()
    # low-frequency background texture
    low = rng.normal(0, 18, (h // 50 + 2, w // 50 + 2, 3)).astype(np.float32)
    ys = np.linspace(0, low.shape[0] - 1.001, h)
    xs = np.linspace(0, low.shape[1] - 1.001, w)
    yi, xi = ys.astype(int), xs.astype(int)
    img += low[yi][:, xi]
    img += rng.normal(0, 6, (h, w, 3))

    boxes, labels = [], []
    for _ in range(int(rng.integers(1, 7))):
        c = int(rng.integers(1, NUM_CLASSES))
        area = rng.uniform(60, 380) ** 2
        aspect = rng.uniform(0.4, 2.5)
        bh = int(np.clip(np.sqrt(area * aspect), 24, h - 2))
        bw = int(np.clip(np.sqrt(area / aspect), 24, w - 2))
        y1 = int(rng.integers(0, h - bh))
        x1 = int(rng.integers(0, w - bw))
        patch = _PALETTE[c - 1] + rng.normal(0, 14, (bh, bw, 3))
        # radial soft edge so boxes are learnable but not trivial
        yy = np.linspace(-1, 1, bh)[:, None]
        xx = np.linspace(-1, 1, bw)[None, :]
        if rng.random() < 0.5:          # ellipse
            mask = (yy ** 2 + xx ** 2) <= 1.0
        else:                           # rectangle with jittered border
            mask = (np.abs(yy) <= 0.98) & (np.abs(xx) <= 0.98)
        region = img[y1:y1 + bh, x1:x1 + bw]
        region[mask] = patch[mask]
        boxes.append([x1, y1, x1 + bw, y1 + bh])
        labels.append(c)
    return (np.clip(img, 0, 255).astype(np.float32),
            np.asarray(boxes, np.float32), np.asarray(labels, np.int32))


def batch_scenes(rng, n, hw=VALID):
    """n scenes pasted onto the canvas (``canvas_for(hw)``); returns images,
    valid_hw, boxes, labels and box validity as NumPy arrays."""
    imgs = np.zeros((n, *canvas_for(hw), 3), np.float32)
    boxes = np.zeros((n, MAX_BOXES, 4), np.float32)
    labels = np.zeros((n, MAX_BOXES), np.int32)
    valid = np.zeros((n, MAX_BOXES), bool)
    for i in range(n):
        im, bx, lb = make_scene(rng, hw)
        imgs[i, :hw[0], :hw[1]] = im
        k = min(len(bx), MAX_BOXES)
        boxes[i, :k] = bx[:k]
        labels[i, :k] = lb[:k]
        valid[i, :k] = True
    valid_hw = np.tile(np.asarray(hw, np.int32), (n, 1))
    return imgs, valid_hw, boxes, labels, valid


def labeled_class_mean(rng, n: int, hw=VALID) -> np.ndarray:
    """Mean per-image class histogram of ``n`` more scenes (the stage-2
    labeled set); draws from ``rng`` as ``batch_scenes(rng, n, hw)`` does."""
    counts = np.zeros((n, NUM_CLASSES - 1))
    for i in range(n):
        for label in make_scene(rng, hw)[2][:MAX_BOXES]:
            counts[i, label - 1] += 1
    return counts.mean(axis=0)


def detector_config(model: str = "faster", tiny: bool = False, device: str = "cuda") -> ALConfig:
    """The driver configuration whose ``build_model`` gives the experiment's
    group-norm detector (``faster`` or ``retina``, or its tiny miniature)."""
    return ALConfig(model=model, norm="group", tiny=tiny, device=device)


def train_model(cfg: ALConfig, seed: int, steps: int, batch: int = 4, bank_size: int = 96,
                hw=VALID):
    """Train ``cfg``'s group-norm detector from its seeded init on a bank of
    scenes of ``hw`` generated first (scene synthesis is host-bound: pay it
    once, sample batches from it): SGD at momentum 0.9 and weight decay 1e-4 over every
    parameter (nothing is frozen under group norm), lr 0.0025 after a
    linear warmup over min(200, steps // 2) steps. Raises
    ``FloatingPointError`` on a non-finite loss. Returns the model and every
    step's loss."""
    device = torch.device(cfg.device)
    model, frozen = build_model(cfg, NUM_CLASSES)
    random_init_(model, seed)
    model.to(device)
    rng = np.random.default_rng(seed)
    t0 = time.time()
    bank = batch_scenes(rng, bank_size, hw)
    print(f"  scene bank ({bank_size}) in {time.time() - t0:.0f}s", flush=True)
    optimizer = make_sgd(model, 0.0025, momentum=0.9, weight_decay=1e-4,
                         frozen_prefixes=frozen)
    scheduler = lr_scheduler(optimizer, multistep_with_warmup(
        0.0025, steps, milestones=(), gamma=1.0, warmup_iters=min(200, steps // 2)))
    step_fn = make_train_step(model, optimizer, scheduler)
    draw = generator_gumbel(torch.Generator(device=device).manual_seed(seed))
    losses = []
    t0 = time.time()
    for s in range(steps):
        idx = rng.choice(bank_size, batch, replace=False)
        metrics = step_fn(*(torch.from_numpy(a[idx]).to(device) for a in bank), draw)
        losses.append(metrics["loss"])
        if s % 100 == 0 or s == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            if not math.isfinite(m["loss"]):
                raise FloatingPointError(f"step {s}: non-finite loss {m}")
            print(f"  step {s}: loss {m['loss']:.3f}", flush=True)
    losses = torch.stack(losses).cpu().numpy() if losses else np.zeros((0,))
    if not np.isfinite(losses).all():
        raise FloatingPointError(f"non-finite losses at steps {np.where(~np.isfinite(losses))[0]}")
    print(f"  trained {steps} steps in {time.time() - t0:.0f}s", flush=True)
    return model.eval(), losses


def float32_copy(model):
    """The same weights computing in float32 throughout (the input, the
    augmentations and every layer)."""
    f32 = type(model)(dataclasses.replace(model.cfg, compute_dtype="float32"))
    f32.load_state_dict(model.state_dict())
    return f32.to(next(model.parameters()).device).eval()


def score_pool(model, pool_imgs, pool_hw, *, rpn_pre, rpn_post, shrink: bool,
               score_batch: int, key: int, alt_key: bool = False, flm: bool | None = None,
               f32: bool = False, draw_at=None):
    """Score the pool in one configuration; returns (consistency (N,),
    cls_corrs (N, C-1)). ``f32`` scores ``float32_copy(model)`` with TF32
    off (the process's TF32 settings are restored after). ``draw_at(i)``
    gives the draws of the batch that starts at pool position i; by default
    every batch draws from one generator seeded with ``key`` (or ``key``'s
    keyB stream with ``alt_key``) on the model's device."""
    device = next(model.parameters()).device
    if draw_at is None:
        gen = (stream_generator(device, key, ALT_KEY) if alt_key
               else torch.Generator(device=device).manual_seed(key))
        draw = generator_draw(gen)
        draw_at = lambda i: draw                                # noqa: E731
    variant = _scoring_model(ALConfig(score_rpn_pre_nms=rpn_pre, score_rpn_post_nms=rpn_post),
                             float32_copy(model) if f32 else model)
    fn = make_cald_score_fn(variant, CALDConfig(shrink_slice=shrink), NUM_CLASSES)
    previous = os.environ.get("CALD_TPU_ROI_FLM")
    if flm is not None:
        os.environ["CALD_TPU_ROI_FLM"] = "1" if flm else "0"
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    if f32:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        cs, corrs = [], []
        for i in range(0, len(pool_imgs), score_batch):
            c, corr = fn(torch.from_numpy(pool_imgs[i:i + score_batch]).to(device),
                         torch.from_numpy(pool_hw[i:i + score_batch]).to(device), draw_at(i))
            cs.append(c.double().cpu().numpy())
            corrs.append(corr.double().cpu().numpy())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        if previous is None:
            os.environ.pop("CALD_TPU_ROI_FLM", None)
        else:
            os.environ["CALD_TPU_ROI_FLM"] = previous
    # a configuration's copy and its allocator blocks go before the next
    del fn, variant
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return np.concatenate(cs), np.concatenate(corrs, axis=0)


def config_set(model: str, name: str | None) -> dict:
    """The configurations of a run: RetinaNet's set for ``model`` retina,
    else ``CONFIG_SETS[name or "default"]``."""
    if model == "retina":
        if name:
            # the mild/mild640 sweeps are Faster-R-CNN-only; the retina
            # set would silently shadow them
            raise SystemExit("DEVIATION_CONFIGS only applies to --model faster; "
                             "--model retina always runs the retina topk sweep")
        return CONFIG_SETS["retina"]
    if (name or "default") not in CONFIG_SETS or name == "retina":
        raise SystemExit(f"unknown DEVIATION_CONFIGS {name!r}")
    return CONFIG_SETS[name or "default"]


def compare(c, sel, cand, base_c, base_sel, base_cand, n_cand: int) -> dict:
    """A configuration's scores, selection and stage-1 candidates against
    ``faithful``'s."""
    from scipy.stats import spearmanr

    return {
        "mean_abs_dc": float(np.mean(np.abs(c - base_c))),
        "max_abs_dc": float(np.max(np.abs(c - base_c))),
        "spearman": float(spearmanr(c, base_c).statistic),
        "stage1_overlap": len(cand & base_cand) / n_cand,
        "selection_jaccard": len(sel & base_sel) / len(sel | base_sel),
    }


def main(argv=None) -> dict:
    """Run the sweep; returns {config: [its record for each seed]}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--pool", type=int, default=512)
    ap.add_argument("--budget", type=int, default=50)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--seed-start", type=int, default=0,
                    help="first seed (resume a partial sweep)")
    ap.add_argument("--score-batch", type=int, default=32)
    ap.add_argument("--bank", type=int, default=96, help="training scenes per seed")
    ap.add_argument("--model", default="faster", choices=["faster", "retina"])
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="the miniature backbone (CPU runs)")
    ap.add_argument("--hw", type=int, nargs=2, default=VALID, metavar=("H", "W"),
                    help="the scenes' size (default 600 1000)")
    args = ap.parse_args(argv)
    configs = config_set(args.model, os.environ.get("DEVIATION_CONFIGS"))
    device = run_device(ALConfig(device=args.device))
    dcfg = detector_config(args.model, args.tiny, str(device))
    hw = tuple(args.hw)

    cfg = CALDConfig()
    n_cand = int(cfg.mutual_range * args.budget)
    summary = {k: [] for k in configs if k != "faithful"}
    for seed in range(args.seed_start, args.seeds):
        print(f"== seed {seed} ==", flush=True)
        model, _ = train_model(dcfg, seed, args.steps, bank_size=args.bank, hw=hw)
        rng = np.random.default_rng(1000 + seed)
        pool_imgs, pool_hw, *_ = batch_scenes(rng, args.pool, hw)
        # labeled set for the stage-2 class histogram
        labeled_mean = labeled_class_mean(rng, 100, hw)

        results = {}
        for name, ckw in configs.items():
            t0 = time.time()
            c, corr = score_pool(model, pool_imgs, pool_hw, score_batch=args.score_batch,
                                 key=7000 + seed, **ckw)
            sel = cald_select(c, corr, labeled_mean, args.budget, cfg)
            cand = np.argsort(c, kind="stable")[:n_cand]
            results[name] = (c, set(sel.tolist()), set(cand.tolist()))
            print(f"  {name}: scored {args.pool} in {time.time() - t0:.0f}s  "
                  f"mean c={c.mean():.4f} std={c.std():.4f} "
                  f"zero-score frac={float(np.mean(c == 0)):.2f}", flush=True)

        base = results["faithful"]
        for name in summary:
            rec = {"seed": seed, "config": name,
                   **compare(*results[name], *base, n_cand=n_cand)}
            summary[name].append(rec)
            print(json.dumps(rec), flush=True)
        del model
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    print("== summary (mean over seeds) ==")
    for name, recs in summary.items():
        if recs:
            agg = {k: round(float(np.mean([r[k] for r in recs])), 4)
                   for k in recs[0] if k not in ("seed", "config")}
            print(json.dumps({"config": name, **agg}))
    return summary


if __name__ == "__main__":
    main()
