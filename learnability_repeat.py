"""Repeat a training run of ``chip_smoke.py`` on one GPU: phase 12(d), the
learnability run, or phase 17(a)'s training.

    python3 learnability_repeat.py [--runs N] [--plain] [--phase learnability|deviation]
        [--steps S] [--bank K] [--lr LR]

A learnability run trains the tiny group-norm detector of
tests/test_learnability.py (32 learnable 96x128 images, 30 epochs) through
``al_loop`` at the phase's lr (``chip_smoke.LEARN_LR`` unless ``--lr`` is
given) and holds it to the phase's AP50 limits. A
deviation run is ``experiments.scoring_deviation.train_model`` as phase
17(a) runs it (the group-norm R50-FPN in bf16, seed 0, B=4, lr 0.0025
after min(200, steps // 2) warmup steps), ``--steps`` steps on a bank of
``--bank`` scenes (phase 17(a)'s unless given), which stops on a
non-finite loss. ``--plain`` swaps the training
RoIAlign's kernels (K2 forward, K3 backward) for their plain PyTorch
versions on the same CUDA tensors, so that a divergence can be told from a
kernel fault. Prints one JSON line per run (how it ended, its per-class
AP50, the largest and the median gradient norm of its SGD steps) and a
summary; a run that ends on a non-finite value also gives its first SGD
step with a non-finite gradient norm and the norms of the steps before
it. Exits non-zero without CUDA. Runs differ from each other only
by the card's run-to-run arithmetic (atomics, cuDNN's algorithms).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("learnability_repeat: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from cald_tpu_torch.ops import roi_align as plain
    from cald_tpu_torch.ops import roi_align_cuda as rac

    p = argparse.ArgumentParser()
    p.add_argument("--runs", type=int, default=8)
    p.add_argument("--plain", action="store_true")
    p.add_argument("--phase", default="learnability", choices=["learnability", "deviation"])
    p.add_argument("--steps", type=int, default=None, help="deviation: training steps")
    p.add_argument("--bank", type=int, default=None, help="deviation: training scenes")
    p.add_argument("--lr", type=float, default=None, help="learnability: the lr")
    args = p.parse_args()

    # as chip_smoke.py runs its phases
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)
    kernels = {"roi_align": rac.roi_align_kernel,
               "roi_align_train_fwd": rac.roi_align_train_fwd_kernel,
               "roi_align_bwd": rac.roi_align_bwd_kernel,
               "roi_align_group_fwd": rac.roi_align_group_fwd_kernel}
    for k in kernels.values():
        k.load()
    if args.plain:
        # the plain versions in the kernels' place, counted as their launches
        # (the phase checks one K2 and one K3 a step)
        def swap(wrapper, fn):
            def call(self, *a, **kw):
                self.launches += 1
                return fn(*a, **kw)
            type(wrapper).__call__ = call

        swap(rac.roi_align_train_fwd_kernel,
             lambda feats, rois, valid, levels, **kw: plain.multi_scale_roi_align(
                 feats, rois, valid=valid, levels=levels, out_dtype=torch.float32, **kw))
        swap(rac.roi_align_bwd_kernel, plain.multi_scale_roi_align_backward)

    norms: list = []
    sgd_step = torch.optim.SGD.step

    def recording_step(self, *a, **kw):
        grads = [q.grad.float().norm() for g in self.param_groups for q in g["params"]
                 if q.grad is not None]
        if grads:
            norms.append(torch.stack(grads).norm().item())
        return sgd_step(self, *a, **kw)

    torch.optim.SGD.step = recording_step

    def deviation_run(work):
        from cald_tpu_torch.experiments import scoring_deviation as sd

        cut = cs.P17_DEVIATION
        _, losses = sd.train_model(sd.detector_config(device="cuda"), 0,
                                   args.steps or cut["steps"], bank_size=args.bank or cut["bank"])
        return {"loss_last": float(losses[-1])}

    def learnability_run(work):
        lr = cs.LEARN_LR if args.lr is None else args.lr
        return {"ap50": cs.learnability_phase(device, kernels, card, work, lr=lr)["ap50"]}

    run = deviation_run if args.phase == "deviation" else learnability_run
    ok = 0
    with tempfile.TemporaryDirectory() as work:
        for i in range(args.runs):
            norms.clear()
            t0 = time.perf_counter()
            try:
                out = {"end": "ok", **run(os.path.join(work, f"r{i}"))}
                ok += 1
            except (AssertionError, FloatingPointError) as e:
                out = {"end": f"{type(e).__name__}: {str(e)[:160]}"}
                bad = [j for j, n in enumerate(norms) if not np.isfinite(n)]
                if bad:
                    out["first_nonfinite_step"] = bad[0]
                    out["norms_before"] = [round(n, 3) for n in norms[max(0, bad[0] - 5):bad[0]]]
            finite = [n for n in norms if np.isfinite(n)]
            print(json.dumps({"run": i, **out, "steps": len(norms),
                              "grad_norm_max": max(finite, default=None),
                              "grad_norm_median": float(np.median(finite)) if finite else None,
                              "s": round(time.perf_counter() - t0, 2)}), flush=True)
    lr = cs.LEARN_LR if args.lr is None else args.lr
    what = f"learnability, lr {lr}" if args.phase == "learnability" else args.phase
    print(f"learnability_repeat: {what}: {ok} of {args.runs} runs passed "
          f"({'plain RoIAlign' if args.plain else 'K2/K3'}) on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
