"""The AL-curve recipes' training over several seeds on the CPU, in the JAX
package or in the port: which seeds' losses go non-finite.

    python tests/curve_seeds.py --package jax|torch --recipe hard|imbalanced
        [--seeds 0-7] [--cycles 1] [--init N] [--epochs E] [--procs 4]
        [--threads 2] [--jax-init] [--trace]

The recipes are those of ``experiments/selection_effectiveness_hard.py``
(``hard``: 400 hard/easy images at 192x256, 50 initial, 14 epochs at batch
8, lr 0.005; ``--init 120 --epochs 16`` is its round-4 setting) and
``experiments/selection_effectiveness.py`` (``imbalanced``: 60 images at
96x128, 12 initial and 6 a cycle, 16 epochs at batch 4, lr 0.005), run
with the ``random`` strategy and no evaluation. Each cycle trains a fresh
model on the labeled set, and random's labeled sets are the same in both
packages (the same initial pool and draws), so both packages train on the
same images at every cycle; ``--cycles 1`` is the first training only.

On the CPU a run is deterministic for a given seed and thread count, so
the spread over seeds is the recipe's own. Each seed runs in a process of
its own, ``--procs`` at a time, on ``--threads`` threads: the port's
``torch.set_num_threads``, and for both packages the process's CPU
affinity, ``--threads`` cores of its own when ``procs * threads`` cores
exist (XLA sizes its CPU thread pool by the affinity, not by
``OMP_NUM_THREADS``). Prints one JSON
line a seed (how the run ended, the cycle it reached, the seconds; for the
port also its SGD steps and their largest and median gradient norm) and a
summary line. ``--jax-init`` starts the port's every cycle from the JAX
package's initial weights for the seed (its driver's ``model.init`` with
``jax.random.key(seed)``, converted), in place of the port's own draw.
``--trace`` adds every training step's losses (and, for the port, its
gradient norm) to the seed's line, to find the first loss that runs away.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def recipe(name: str, root: str, seed: int, cycles: int, init: int | None,
           epochs: int | None) -> dict:
    """The experiment scripts' configurations, ``random`` and no evaluation."""
    if name == "hard":
        epochs = epochs or 14
        return dict(dataset="voc2007", data_path=root, model="faster", strategy="random",
                    tiny=True, norm="group", cycles=cycles, epochs=epochs, batch_size=8,
                    init_num=init or 50, budget_num=50, score_batch_size=16, workers=4,
                    min_size=192, max_size=256, max_boxes=8, print_freq=100000, lr=0.005,
                    lr_steps=(epochs - 4, epochs - 2), aspect_ratio_group_factor=0,
                    seed=seed, eval_every_cycle=False)
    return dict(dataset="voc2007", data_path=root, model="faster", strategy="random",
                tiny=True, norm="group", cycles=cycles, epochs=epochs or 16, batch_size=4,
                init_num=init or 12, budget_num=6, score_batch_size=8, workers=4,
                min_size=96, max_size=128, max_boxes=8, print_freq=100000, lr=0.005,
                lr_steps=(12, 14), aspect_ratio_group_factor=0, seed=seed,
                eval_every_cycle=False)


def pool(package: str, name: str, work: str, seed: int) -> str:
    if package == "jax":
        from cald_tpu.data.synthetic import make_hard_easy_voc, make_learnable_voc
    else:
        from cald_tpu_torch.data.synthetic import make_hard_easy_voc, make_learnable_voc
    if name == "hard":
        return make_hard_easy_voc(os.path.join(work, "train"), num_images=400, hard_frac=0.3,
                                  seed=100 + seed)
    return make_learnable_voc(os.path.join(work, "train"), num_images=60, seed=100 + seed,
                              class_probs=(0.55, 0.35, 0.10))


def run(package: str, name: str, seed: int, args, work: str, extra: dict) -> None:
    """One run; for the port, ``extra`` gets its SGD steps and their
    gradient norms, also when it stops."""
    root = pool(package, name, work, seed)
    cfg = recipe(name, root, seed, args.cycles, args.init, args.epochs)
    trace: list = []
    if package == "jax":
        from cald_tpu.cli.config import ALConfig
        from cald_tpu.cli.driver import al_loop
        from cald_tpu.data import get_voc2007

        import cald_tpu.cli.driver as jdriver

        if args.trace:
            make = jdriver.make_train_step

            def tracing_make(model, *a, **kw):
                step = make(model, *a, **kw)

                def traced(state, *sa):
                    state, metrics = step(state, *sa)
                    trace.append({k: float(v) for k, v in metrics.items()})
                    return state, metrics
                return traced

            jdriver.make_train_step = tracing_make
        ds = get_voc2007(root, "trainval")
        try:
            al_loop(ALConfig(**cfg).resolve(), datasets=(ds, ds))
        finally:
            if args.trace:
                extra["trace"] = trace
        return
    import torch

    from cald_tpu_torch.cli.config import ALConfig
    from cald_tpu_torch.cli.driver import al_loop
    from cald_tpu_torch.data.voc import get_voc2007

    norms: list = []
    sgd_step = torch.optim.SGD.step

    def recording_step(self, *a, **kw):
        grads = [q.grad.float().norm() for g in self.param_groups for q in g["params"]
                 if q.grad is not None]
        norms.append(torch.stack(grads).norm().item())
        return sgd_step(self, *a, **kw)

    torch.optim.SGD.step = recording_step
    if args.trace:
        import cald_tpu_torch.cli.driver as tdriver

        make = tdriver.make_train_step

        def tracing_make(*a, **kw):
            step = make(*a, **kw)

            def traced(*sa):
                metrics = step(*sa)
                trace.append({**{k: float(v) for k, v in metrics.items()},
                              "grad_norm": norms[-1]})
                return metrics
            return traced

        tdriver.make_train_step = tracing_make
    if args.jax_init:
        import cald_tpu_torch.cli.driver as driver

        driver.random_init_ = lambda model, seed: model.load_state_dict(
            jax_weights(cfg, seed, model.cfg.num_classes))
    ds = get_voc2007(root, "trainval")
    try:
        al_loop(ALConfig(**cfg, device="cpu").resolve(), datasets=(ds, ds))
    finally:
        finite = [n for n in norms if np.isfinite(n)]
        if args.trace:
            extra["trace"] = trace
        extra.update(steps=len(norms), grad_norm_max=max(finite, default=None),
                     grad_norm_median=float(np.median(finite)) if finite else None,
                     grad_norm_first=norms[0] if norms else None,
                     grad_norm_last=norms[-1] if norms else None)


def jax_weights(cfg: dict, seed: int, num_classes: int) -> dict:
    """The JAX driver's initial weights for ``cfg`` and ``seed`` as a state
    dict of the port (the parameters do not depend on the example's size)."""
    import jax
    import jax.numpy as jnp

    from cald_tpu.cli.config import ALConfig
    from cald_tpu.cli.driver import build_model
    from cald_tpu_torch.convert.from_flax import flax_to_state_dict

    model, _ = build_model(ALConfig(**cfg).resolve(), num_classes)
    example = (jnp.zeros((1, cfg["min_size"], cfg["max_size"], 3)), jnp.zeros((1, 2), jnp.int32))
    return flax_to_state_dict(jax.jit(model.init)(jax.random.key(seed), *example))


def one(package: str, name: str, seed: int, args) -> dict:
    t0 = time.perf_counter()
    out: dict = {"package": package, "recipe": name, "seed": seed,
                 **({"jax_init": True} if args.jax_init else {})}
    extra: dict = {}
    with tempfile.TemporaryDirectory() as work:
        try:
            run(package, name, seed, args, work, extra)
            out["end"] = "ok"
        except FloatingPointError as e:
            out["end"] = f"FloatingPointError: {str(e)[:160]}"
    out.update(extra)
    out["s"] = round(time.perf_counter() - t0, 1)
    return out


def pin(slot: int, threads: int, procs: int):
    """A ``preexec_fn`` that gives the ``slot``-th process of a round its
    own ``threads`` cores, or None where there are too few."""
    cores = sorted(os.sched_getaffinity(0))
    if procs * threads > len(cores):
        return None
    mine = set(cores[slot * threads:(slot + 1) * threads])
    return lambda: os.sched_setaffinity(0, mine)


def seed_list(spec: str) -> list[int]:
    if "-" in spec:
        a, b = spec.split("-")
        return list(range(int(a), int(b) + 1))
    return [int(s) for s in spec.split(",")]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--package", choices=["jax", "torch"], required=True)
    p.add_argument("--recipe", choices=["hard", "imbalanced"], required=True)
    p.add_argument("--seeds", default="0-7", help="a range a-b or a list a,b,c")
    p.add_argument("--cycles", type=int, default=1)
    p.add_argument("--init", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--procs", type=int, default=4)
    p.add_argument("--threads", type=int, default=2)
    p.add_argument("--jax-init", action="store_true",
                   help="the port starts from the JAX package's initial weights")
    p.add_argument("--trace", action="store_true",
                   help="every step's losses (and the port's gradient norm) in the line")
    p.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args()

    if args.one is not None:
        if args.package == "torch":
            import torch

            torch.set_num_threads(args.threads)
        print(json.dumps(one(args.package, args.recipe, args.one, args)), flush=True)
        return 0

    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS=str(args.threads),
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    argv = [sys.executable, os.path.abspath(__file__), "--package", args.package, "--recipe",
            args.recipe, "--cycles", str(args.cycles), "--threads", str(args.threads)]
    for opt in ("init", "epochs"):
        if getattr(args, opt) is not None:
            argv += [f"--{opt}", str(getattr(args, opt))]
    if args.jax_init:
        argv.append("--jax-init")
    if args.trace:
        argv.append("--trace")
    rows, seeds = [], seed_list(args.seeds)
    for i in range(0, len(seeds), args.procs):
        procs = [subprocess.Popen([*argv, "--one", str(s)], stdout=subprocess.PIPE,
                                  stderr=subprocess.DEVNULL, text=True, env=env, cwd=ROOT,
                                  preexec_fn=pin(j, args.threads, args.procs))
                 for j, s in enumerate(seeds[i:i + args.procs])]
        for s, proc in zip(seeds[i:i + args.procs], procs):
            text = proc.communicate()[0]
            lines = [ln for ln in text.splitlines() if ln.startswith("{")]
            row = json.loads(lines[-1]) if lines else {
                "package": args.package, "recipe": args.recipe, "seed": s,
                "end": f"exit code {proc.returncode}"}
            cycles = re.findall(r"=== cycle (\d+)", text)
            row["last_cycle"] = int(cycles[-1]) if cycles else None
            rows.append(row)
            print(json.dumps(row), flush=True)
    bad = [r["seed"] for r in rows if r["end"] != "ok"]
    print(f"curve_seeds: {args.package}, {args.recipe}, cycles {args.cycles}: "
          f"{len(rows) - len(bad)} of {len(rows)} seeds trained through (non-finite: {bad})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
