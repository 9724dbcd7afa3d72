"""Repeat ``chip_smoke.py`` phase 12(d), the learnability run, on one GPU.

    python3 learnability_repeat.py [--runs N] [--plain]

Each run trains the tiny group-norm detector of tests/test_learnability.py
(32 learnable 96x128 images, 30 epochs, lr 0.005) through ``al_loop`` and
holds it to the phase's AP50 limits. ``--plain`` swaps the training
RoIAlign's kernels (K2 forward, K3 backward) for their plain PyTorch
versions on the same CUDA tensors, so that a divergence can be told from a
kernel fault. Prints one JSON line per run (how it ended, its per-class
AP50, the largest and the median gradient norm of its SGD steps) and a
summary; exits non-zero without CUDA. Runs differ from each other only
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
    args = p.parse_args()

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
    ok = 0
    with tempfile.TemporaryDirectory() as work:
        for i in range(args.runs):
            norms.clear()
            t0 = time.perf_counter()
            try:
                out = cs.learnability_phase(device, kernels, card, os.path.join(work, f"r{i}"))
                end, ap = "ok", out["ap50"]
                ok += 1
            except (AssertionError, FloatingPointError) as e:
                end, ap = f"{type(e).__name__}: {str(e)[:160]}", None
            print(json.dumps({"run": i, "end": end, "ap50": ap, "steps": len(norms),
                              "grad_norm_max": max(norms, default=None),
                              "grad_norm_median": float(np.median(norms)) if norms else None,
                              "s": round(time.perf_counter() - t0, 2)}), flush=True)
    print(f"learnability_repeat: {ok} of {args.runs} runs passed "
          f"({'plain RoIAlign' if args.plain else 'K2/K3'}) on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
