"""The learnability recipe of tests/test_learnability.py over several seeds
on the CPU, in the JAX package or in the port, each run held to the test's
limits (per-class AP50 > 0.7 for aeroplane, bicycle and bird, their mean >
0.85).

    python tests/learnability_seeds.py --package jax|torch [--lr 0.005]
        [--seeds 0-7] [--procs 4] [--threads 2]

The recipe: the tiny Faster R-CNN with group norms, 32 learnable 96x128
images, 30 epochs at batch 4 (8 steps an epoch, a warmup of 7 steps), lr
steps at epochs 20 and 26; ``--seed`` sets the initial weights, the
shuffling and the sampling draws. On the CPU a run is deterministic for a
given seed and thread count, so a seed that fails here fails every time:
the spread over seeds is the recipe's own, with no run-to-run arithmetic
in it.

Each seed runs in a process of its own, ``--procs`` at a time (the port's
on ``--threads`` threads). Prints one JSON line a seed (how the run ended,
the three AP50s, pass or fail, the seconds; for the port also the largest
and the median gradient norm of its SGD steps) and a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("aeroplane", "bicycle", "bird")


def recipe(root: str, seed: int, lr: float) -> dict:
    """tests/test_learnability.py's configuration at ``seed`` and ``lr``."""
    return dict(dataset="voc2007", data_path=root, model="faster", strategy="random",
                tiny=True, norm="group", cycles=1, epochs=30, batch_size=4, init_num=32,
                budget_num=1, score_batch_size=4, workers=2, min_size=96, max_size=128,
                max_boxes=8, print_freq=100000, lr=lr, lr_steps=(20, 26),
                aspect_ratio_group_factor=0, seed=seed)


def run_torch(seed: int, lr: float, work: str) -> tuple[dict, dict]:
    import torch

    from cald_tpu_torch.cli.config import ALConfig
    from cald_tpu_torch.cli.driver import al_loop
    from cald_tpu_torch.data.synthetic import make_learnable_voc
    from cald_tpu_torch.data.voc import get_voc2007

    norms: list = []
    sgd_step = torch.optim.SGD.step

    def recording_step(self, *a, **kw):
        grads = [q.grad.float().norm() for g in self.param_groups for q in g["params"]
                 if q.grad is not None]
        norms.append(torch.stack(grads).norm().item())
        return sgd_step(self, *a, **kw)

    torch.optim.SGD.step = recording_step
    root = make_learnable_voc(os.path.join(work, "data"), 32, image_format="npy")
    ds = get_voc2007(root, "trainval")
    cfg = ALConfig(**recipe(root, seed, lr), device="cpu").resolve()
    extra: dict = {}
    try:
        per_class = al_loop(cfg, datasets=(ds, ds))[0]["eval"]["per_class_ap50"]
    finally:
        finite = [n for n in norms if np.isfinite(n)]
        extra = {"steps": len(norms), "grad_norm_max": max(finite, default=None),
                 "grad_norm_median": float(np.median(finite)) if finite else None}
    return per_class, extra


def run_jax(seed: int, lr: float, work: str) -> tuple[dict, dict]:
    from cald_tpu.cli.config import ALConfig
    from cald_tpu.cli.driver import al_loop
    from cald_tpu.data import get_voc2007
    from cald_tpu.data.synthetic import make_learnable_voc

    root = make_learnable_voc(os.path.join(work, "data"), num_images=32)
    ds = get_voc2007(root, "trainval")
    cfg = ALConfig(**recipe(root, seed, lr)).resolve()
    return al_loop(cfg, datasets=(ds, ds))[0]["eval"]["per_class_ap50"], {}


def one(package: str, seed: int, lr: float) -> dict:
    t0 = time.perf_counter()
    out: dict = {"package": package, "seed": seed, "lr": lr}
    with tempfile.TemporaryDirectory() as work:
        try:
            per_class, extra = (run_jax if package == "jax" else run_torch)(seed, lr, work)
            ap = {k: round(float(per_class.get(k, 0.0)), 4) for k in CLASSES}
            mean = float(np.mean(list(ap.values())))
            out.update(end="ok", ap50=ap, mean=round(mean, 4),
                       passed=all(v > 0.7 for v in ap.values()) and mean > 0.85, **extra)
        except FloatingPointError as e:
            out.update(end=f"FloatingPointError: {str(e)[:80]}", passed=False)
    out["s"] = round(time.perf_counter() - t0, 1)
    return out


def seed_list(spec: str) -> list[int]:
    if "-" in spec:
        a, b = spec.split("-")
        return list(range(int(a), int(b) + 1))
    return [int(s) for s in spec.split(",")]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--package", choices=["jax", "torch"], required=True)
    p.add_argument("--lr", type=float, default=0.005)
    p.add_argument("--seeds", default="0-7", help="a range a-b or a list a,b,c")
    p.add_argument("--procs", type=int, default=4)
    p.add_argument("--threads", type=int, default=2)
    p.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args()

    if args.one is not None:
        if args.package == "torch":
            import torch

            torch.set_num_threads(args.threads)
        print(json.dumps(one(args.package, args.one, args.lr)), flush=True)
        return 0

    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS=str(args.threads),
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    rows, seeds = [], seed_list(args.seeds)
    for i in range(0, len(seeds), args.procs):
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--package", args.package, "--lr",
             str(args.lr), "--threads", str(args.threads), "--one", str(s)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env, cwd=ROOT)
            for s in seeds[i:i + args.procs]]
        for s, proc in zip(seeds[i:i + args.procs], procs):
            lines = [ln for ln in proc.communicate()[0].splitlines() if ln.startswith("{")]
            row = json.loads(lines[-1]) if lines else {
                "package": args.package, "seed": s, "lr": args.lr,
                "end": f"exit code {proc.returncode}", "passed": False}
            rows.append(row)
            print(json.dumps(row), flush=True)
    ok = sum(bool(r["passed"]) for r in rows)
    print(f"learnability_seeds: {args.package}, lr {args.lr}: {ok} of {len(rows)} seeds passed "
          f"(failed: {[r['seed'] for r in rows if not r['passed']]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
