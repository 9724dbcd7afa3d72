"""The CPU selection gate of tests/test_torch_selection_gate.py over several
seeds, in both packages and both precisions: how far bf16 scoring moves the
CALD selection in the JAX package itself, against its float32 re-roll
floor, and how far the port's bf16 lies from JAX's.

    python tests/gate_bf16_seeds.py [--seeds 0-7] [--pool 32] [--budget 8]
        [--norm frozen|group] [--procs 4] [--threads 2] [--unjitted]

Seed s is the gate fixture's recipe with s added: the tiny Faster R-CNN
(21 classes, 32 FPN channels, heads amplified) from the Flax init of
``tiny_models(seed=s)`` carried into the port by the weight bridge, a pool
of scenes at 96x128 from ``default_rng(5 + s)`` and the stage-2 labeled
histogram after them, the augmentation draws of batch i ``fold_in(key(7000
+ s), i)`` (injected into the port), the re-roll's ``fold_in(key, 9999)``
first; seed 0 is the test's fixture. Each package scores the pool in
float32 and in bf16 (JAX jitted, as its score function runs; with
``--unjitted`` also op by op under ``jax.disable_jit``, where every Flax op
rounds as the port's do) and selects the budget. Prints one JSON line a
seed: the selection Jaccards (JAX bf16 vs JAX f32, JAX's f32 and bf16
re-roll floors, port bf16 vs port f32, port bf16 vs JAX bf16, port f32 vs
JAX f32) and the mean |Δc| of each pair; then the means. Each seed runs in a
process of its own, ``--procs`` at a time. Not a test: it adds nothing to
the tier-1 run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (96, 128)
BATCH = 8
FPN = 32
KEY = 7000


def jaccard(a, b) -> float:
    a, b = set(np.asarray(a).tolist()), set(np.asarray(b).tolist())
    return len(a & b) / len(a | b)


def one(seed: int, pool: int, budget: int, norm: str, unjitted: bool) -> dict:
    import jax
    import jax.numpy as jnp

    from cald_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
    from cald_tpu.models.faster_rcnn import FasterRCNNConfig as JaxConfig
    from cald_tpu.strategies import cald as jcald
    from cald_tpu_torch.experiments import scoring_deviation as sd
    from cald_tpu_torch.models.faster_rcnn import FasterRCNN, FasterRCNNConfig
    from cald_tpu_torch.strategies import cald
    from tests.test_torch_cald import jax_draw
    from tests.torch_helpers import TINY, tiny_models

    jf32, variables, tf32 = tiny_models(seed=seed, norm=norm, num_classes=sd.NUM_CLASSES,
                                        fpn_channels=FPN)
    cfg = {**TINY, "num_classes": sd.NUM_CLASSES, "fpn_channels": FPN,
           "compute_dtype": "bfloat16"}
    jbf16 = JaxFasterRCNN(JaxConfig(norm=norm, **cfg))
    tbf16 = FasterRCNN(FasterRCNNConfig(norm=norm, **cfg))
    tbf16.load_state_dict(tf32.state_dict())
    tbf16.eval()
    rng = np.random.default_rng(5 + seed)
    images, valid_hw, *_ = sd.batch_scenes(rng, pool, HW)
    labeled_mean = sd.labeled_class_mean(rng, 100, HW)
    key = jax.random.key(KEY + seed)
    key_b = jax.random.fold_in(key, sd.ALT_KEY)

    def jax_scores(model, k):
        fn = jcald.make_cald_score_fn(model, jcald.CALDConfig(), sd.NUM_CLASSES)
        out = [fn(variables, jnp.asarray(images[i:i + BATCH]), jnp.asarray(valid_hw[i:i + BATCH]),
                  jax.random.fold_in(k, i)) for i in range(0, pool, BATCH)]
        return (np.concatenate([np.asarray(c, np.float64) for c, _ in out]),
                np.concatenate([np.asarray(r, np.float64) for _, r in out]))

    def port_scores(model):
        return sd.score_pool(model, images, valid_hw, rpn_pre=0, rpn_post=0, shrink=False,
                             score_batch=BATCH, key=KEY + seed,
                             draw_at=lambda i: jax_draw(jax.random.fold_in(key, i)))

    s = {"jax_f32": jax_scores(jf32, key), "jax_f32_b": jax_scores(jf32, key_b),
         "jax_bf16": jax_scores(jbf16, key), "jax_bf16_b": jax_scores(jbf16, key_b),
         "port_f32": port_scores(tf32), "port_bf16": port_scores(tbf16)}
    if unjitted:
        with jax.disable_jit():
            s["jax_bf16_op"] = jax_scores(jbf16, key)
    ccfg = cald.CALDConfig()
    sel = {k: (jcald.cald_select if k.startswith("jax") else cald.cald_select)(
        *v, labeled_mean, budget, ccfg) for k, v in s.items()}
    pairs = {"jax_bf16_vs_f32": ("jax_bf16", "jax_f32"),
             "floor_jax_f32": ("jax_f32_b", "jax_f32"),
             "floor_jax_bf16": ("jax_bf16_b", "jax_bf16"),
             "port_bf16_vs_f32": ("port_bf16", "port_f32"),
             "port_bf16_vs_jax_bf16": ("port_bf16", "jax_bf16"),
             "port_f32_vs_jax_f32": ("port_f32", "jax_f32")}
    if unjitted:
        pairs.update({"jax_bf16_op_vs_f32": ("jax_bf16_op", "jax_f32"),
                      "port_bf16_vs_jax_bf16_op": ("port_bf16", "jax_bf16_op"),
                      "jax_bf16_op_vs_jax_bf16": ("jax_bf16_op", "jax_bf16")})
    row = {"seed": seed, "norm": norm, "pool": pool, "budget": budget,
           "zero_score_frac": round(float(np.mean(s["jax_f32"][0] == 0)), 3)}
    for name, (a, b) in pairs.items():
        row[f"jaccard_{name}"] = round(jaccard(sel[a], sel[b]), 4)
        row[f"dc_{name}"] = round(float(np.abs(s[a][0] - s[b][0]).mean()), 5)
    return row


def seed_list(spec: str) -> list[int]:
    if "-" in spec:
        a, b = spec.split("-")
        return list(range(int(a), int(b) + 1))
    return [int(s) for s in spec.split(",")]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", default="0-7", help="a range a-b or a list a,b,c")
    p.add_argument("--pool", type=int, default=32)
    p.add_argument("--budget", type=int, default=8)
    p.add_argument("--norm", default="frozen", choices=["frozen", "group"])
    p.add_argument("--procs", type=int, default=4)
    p.add_argument("--threads", type=int, default=2)
    p.add_argument("--unjitted", action="store_true")
    p.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args()

    if args.one is not None:
        import torch

        torch.set_num_threads(args.threads)
        print(json.dumps(one(args.one, args.pool, args.budget, args.norm, args.unjitted)),
              flush=True)
        return 0

    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS=str(args.threads),
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    flags = ["--pool", str(args.pool), "--budget", str(args.budget), "--norm", args.norm,
             "--threads", str(args.threads)] + (["--unjitted"] if args.unjitted else [])
    rows, seeds = [], seed_list(args.seeds)
    for i in range(0, len(seeds), args.procs):
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *flags,
                                   "--one", str(s)], stdout=subprocess.PIPE,
                                  stderr=subprocess.DEVNULL, text=True, env=env, cwd=ROOT)
                 for s in seeds[i:i + args.procs]]
        for s, proc in zip(seeds[i:i + args.procs], procs):
            lines = [ln for ln in proc.communicate()[0].splitlines() if ln.startswith("{")]
            if not lines:
                print(json.dumps({"seed": s, "end": f"exit code {proc.returncode}"}), flush=True)
                continue
            rows.append(json.loads(lines[-1]))
            print(lines[-1], flush=True)
    if rows:
        keys = [k for k in rows[0] if k.startswith(("jaccard_", "dc_"))]
        print(json.dumps({"mean": {k: round(float(np.mean([r[k] for r in rows])), 4)
                                   for k in keys},
                          "jax_bf16_at_or_above_f32_floor": sum(
                              r["jaccard_jax_bf16_vs_f32"] >= r["jaccard_floor_jax_f32"]
                              for r in rows),
                          "port_bf16_at_or_above_f32_floor": sum(
                              r["jaccard_port_bf16_vs_f32"] >= r["jaccard_floor_jax_f32"]
                              for r in rows),
                          "seeds": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
