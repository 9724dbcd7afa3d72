"""Which rounding of the bf16 scoring path moves the CALD selection: the
selection gate's protocol (``cald_tpu_torch.experiments.scoring_deviation``
with ``DEVIATION_CONFIGS=gate``) with the bf16 path split into its parts.

    python3 precision_split.py [--seeds 4] [--seed-start 0] [--steps 300]
        [--bank 96] [--pool 512] [--budget 50] [--score-batch 32]
        [--device cuda|cpu] [--tiny] [--hw 600 1000] [--out FILE]

Per seed the group-norm R50-FPN is trained as the gate trains it
(``train_model``: 300 steps at B=4 on 96 scenes), then one pool of 512
scenes is scored on the same weights and the same augmentation draws in
each configuration of ``CONFIGS``:

- ``faithful``: bf16 as shipped (configuration (i));
- ``faithful(keyB)``: the same with re-rolled augmentations, whose
  Jaccard against ``faithful`` is the re-roll floor ``floor_port``;
- ``f32``: float32 throughout, TF32 off (``float32_copy``);
- ``f32(keyB)``: ``f32`` with re-rolled augmentations (the float32 floor);
- ``bf16, no reduced-precision reduction`` (ii): bf16 as shipped with
  ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
  off, so cuBLAS reduces bf16 products in float32;
- ``f32 but the input cast`` (iii): float32, except that the normalized
  input of every detect is rounded to bf16 (a pre-hook on the backbone);
- ``f32 but the augmentations' cast`` (iv): float32, except that the
  augmentations run on images cast to bf16, as the shipped score function
  casts them (``build_aug_batch`` wrapped while that configuration scores);
- ``f32 but the trunk`` (v): the backbone's and the FPN's convolutions in
  bf16, everything else float32 (the trunk's first convolution rounds its
  input);
- ``f32 but the heads`` (vi): the RPN head, the box head and the predictor
  in bf16, everything else float32.

Every configuration but (i), (ii) and ``faithful(keyB)`` scores with TF32
off. A configuration is a copy of the trained model whose ``Conv``/``Dense``
``dtype`` attributes are set per part; the package is not changed, and the
process's flags are restored after each configuration. Prints one JSON line
per (seed, configuration) with its Jaccard, Spearman, stage-1 overlap and
mean |Δc| against ``faithful`` and against ``f32``, then the means over the
seeds beside ``floor_port``; ``--out`` also writes them as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from cald_tpu_torch.cli.config import ALConfig
from cald_tpu_torch.cli.driver import run_device
from cald_tpu_torch.experiments import scoring_deviation as sd
from cald_tpu_torch.models.layers import Conv, Dense
from cald_tpu_torch.strategies import cald
from cald_tpu_torch.strategies.cald import CALDConfig, cald_select

TRUNK = ("backbone", "fpn")
HEADS = ("rpn_head", "box_head", "box_predictor")
# name: the float32 copy's bf16 ``parts`` (absent: the trained model itself,
# bf16 as shipped), ``input_cast``, ``aug_cast``, re-rolled augmentations
# (``alt_key``), cuBLAS's reduced-precision bf16 reduction off (``no_reduced``)
CONFIGS = {
    "faithful": None,
    "faithful(keyB)": dict(alt_key=True),
    "f32": dict(parts=()),
    "f32(keyB)": dict(parts=(), alt_key=True),
    "bf16, no reduced-precision reduction": dict(no_reduced=True),
    "f32 but the input cast": dict(parts=(), input_cast=True),
    "f32 but the augmentations' cast": dict(parts=(), aug_cast=True),
    "f32 but the trunk": dict(parts=TRUNK),
    "f32 but the heads": dict(parts=HEADS),
}


def split_copy(model, parts=(), input_cast: bool = False):
    """A float32 copy of ``model`` (its weights, ``dtype`` None: the input
    and the augmentations stay float32) whose convolutions and dense layers
    under the top-level modules ``parts`` compute in bf16 and all others in
    float32; with ``input_cast`` the backbone's input is rounded to bf16
    first, as the shipped path casts the normalized input."""
    copy = type(model)(dataclasses.replace(model.cfg, compute_dtype="float32"))
    copy.load_state_dict(model.state_dict())
    copy = copy.to(next(model.parameters()).device).eval()
    for name, m in copy.named_modules():
        if isinstance(m, (Conv, Dense)):
            m.dtype = torch.bfloat16 if name.split(".")[0] in parts else torch.float32
    if input_cast:
        copy.backbone.register_forward_pre_hook(
            lambda mod, args, kwargs: ((args[0].to(torch.bfloat16).float(), *args[1:]), kwargs),
            with_kwargs=True)
    return copy


@contextlib.contextmanager
def flags(tf32_off: bool, reduced: bool):
    """TF32 for float32 products off (``tf32_off``, else as the process has
    it) and cuBLAS's reduced-precision bf16 reduction set for the block,
    restored after."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32, matmul.allow_bf16_reduced_precision_reduction)
    if tf32_off:
        matmul.allow_tf32 = cudnn.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = reduced
    try:
        yield
    finally:
        (matmul.allow_tf32, cudnn.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = saved


@contextlib.contextmanager
def aug_cast(on: bool):
    """While open, the score function's augmentations run on images cast to
    bf16 (the shipped bf16 path's cast) whatever the model's dtype."""
    build = cald.build_aug_batch
    if on:
        cald.build_aug_batch = lambda images, *a, **kw: build(images.to(torch.bfloat16), *a, **kw)
    try:
        yield
    finally:
        cald.build_aug_batch = build


def score(model, name: str, pool_imgs, pool_hw, *, score_batch: int, key: int):
    """The pool's (consistency, cls_corrs) in configuration ``name``."""
    spec = CONFIGS[name] or {}
    shipped = "parts" not in spec
    variant = model if shipped else split_copy(model, spec["parts"], spec.get("input_cast", False))
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    with flags(not shipped, reduced and not spec.get("no_reduced", False)), \
            aug_cast(spec.get("aug_cast", False)):
        return sd.score_pool(variant, pool_imgs, pool_hw, rpn_pre=0, rpn_post=0, shrink=False,
                             score_batch=score_batch, key=key,
                             alt_key=spec.get("alt_key", False), flm=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--pool", type=int, default=512)
    ap.add_argument("--budget", type=int, default=50)
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--seed-start", type=int, default=0)
    ap.add_argument("--score-batch", type=int, default=32)
    ap.add_argument("--bank", type=int, default=96)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="the miniature backbone (CPU runs)")
    ap.add_argument("--hw", type=int, nargs=2, default=sd.VALID, metavar=("H", "W"))
    ap.add_argument("--out", default=None, help="also write the records here as JSON")
    args = ap.parse_args(argv)
    device = run_device(ALConfig(device=args.device))
    if device.type == "cuda":
        import subprocess

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
              f"{torch.cuda.get_device_name(0)}", flush=True)
    dcfg = sd.detector_config("faster", args.tiny, str(device))
    hw = tuple(args.hw)
    ccfg = CALDConfig()
    n_cand = int(ccfg.mutual_range * args.budget)
    records = []
    for seed in range(args.seed_start, args.seeds):
        print(f"== seed {seed} ==", flush=True)
        model, _ = sd.train_model(dcfg, seed, args.steps, bank_size=args.bank, hw=hw)
        rng = np.random.default_rng(1000 + seed)
        pool_imgs, pool_hw, *_ = sd.batch_scenes(rng, args.pool, hw)
        labeled_mean = sd.labeled_class_mean(rng, 100, hw)
        results = {}
        for name in CONFIGS:
            t0 = time.time()
            c, corr = score(model, name, pool_imgs, pool_hw, score_batch=args.score_batch,
                            key=7000 + seed)
            sel = cald_select(c, corr, labeled_mean, args.budget, ccfg)
            cand = np.argsort(c, kind="stable")[:n_cand]
            results[name] = (c, set(sel.tolist()), set(cand.tolist()))
            print(f"  {name}: scored {args.pool} in {time.time() - t0:.1f}s, mean c "
                  f"{c.mean():.4f}, zero-score frac {float(np.mean(c == 0)):.2f}", flush=True)
        for name in CONFIGS:
            rec = {"seed": seed, "config": name}
            for ref in ("faithful", "f32"):
                if name != ref:
                    got = sd.compare(*results[name], *results[ref], n_cand=n_cand)
                    rec.update({f"{k}_vs_{ref}": round(v, 4) for k, v in got.items()})
            records.append(rec)
            print(json.dumps(rec), flush=True)
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()

    print("== means over the seeds ==")
    floor = float(np.mean([r["selection_jaccard_vs_faithful"] for r in records
                           if r["config"] == "faithful(keyB)"]))
    floor_f32 = float(np.mean([r["selection_jaccard_vs_f32"] for r in records
                               if r["config"] == "f32(keyB)"]))
    means = {}
    for name in CONFIGS:
        rs = [r for r in records if r["config"] == name]
        keys = [k for k in rs[0] if k not in ("seed", "config")]
        means[name] = {k: round(float(np.mean([r[k] for r in rs])), 4) for k in keys}
        print(json.dumps({"config": name, **means[name], "floor_port": round(floor, 4),
                          "floor_f32": round(floor_f32, 4)}))
    out = {"records": records, "means": means, "floor_port": floor, "floor_f32": floor_f32}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
