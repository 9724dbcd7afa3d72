"""Time the RoIAlign kernels of ``cald_tpu_torch/csrc/roi_align.cu`` against
another version of that source, in turns, on one GPU.

    python3 roi_kernel_turns.py --old OLD.cu [--out cald_tpu_torch/build/roi_kernel_turns.json]

``OLD.cu`` is a copy of an earlier ``roi_align.cu`` with the same C entry
points (for instance ``git show <commit>:cald_tpu_torch/csrc/roi_align.cu``).
Both are built with nvcc for sm_90a; fresh wrappers are pointed at each.
At ``chip_smoke.py``'s shapes, bf16 features, each pair is timed old, new,
new, old (CUDA events, mean of 20 launches after one warm-up):

  * K1 (inference forward) at phase 3's inputs (B=8, N=1000, C=256), and at
    B=32, the score call's batched detect of 4 augs of 8 images;
  * K2 (training forward) and K3 (training backward) at phase 6's inputs
    (B=4, 512 rois per image, a quarter of them jittered gt boxes);
  * K3 on uniform rois like phase 3's (B=4, 512 per image), to see how much
    of K3's time the training rois' overlap costs;
  * the new K1 and K3 on their scalar paths (an input one element off a
    16-byte boundary) beside their vector paths;
  * where the new K3's time goes: copies of its source edited to drop its
    reductions (the sums are still formed) or its loads of the output
    gradient, timed in turns with it at phase 6's inputs, beside the
    wrapper's zero-fill of the level gradients.

It also prints what ``nvcc -Xptxas -v`` reports for each version's K1, K2
and K3 (registers per thread, spills, shared memory), the blocks per SM
that follow from them and the launch configuration, and the reduction
instructions in the built code (``cuobjdump -sass``). Writes everything to
``--out`` as JSON. Exits non-zero without CUDA. JAX is not imported.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import chip_smoke as cs

NEW = Path(__file__).resolve().parent / "cald_tpu_torch" / "csrc" / "roi_align.cu"


def _misaligned(t):
    """A contiguous copy of ``t`` one element past a 16-byte boundary."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _launch_shape(name: str, c: int = 256):
    """(threads per block, dynamic shared bytes) of a kernel at S=7, sr=2:
    the new kernels (one warp per output row; 256 threads per roi) and the
    old ones (threads across C, a row's sample plan in shared memory)."""
    new = "roi_align_fwd_kernel" in name and re.search(r"Li[0-9]+ELi[0-9]+E", name)
    if "roi_align_bwd_kernel" in name and "ILi" in name:
        return 256, (8 * 28 + 8 * 28 + 7 * 28 + 2) * 4
    if new:
        return 32 * 7, 2 * 7 * 4 * 8
    return min(256, c), 2 * 14 * 4 * 8


def footprint(rois, valid, levels, shapes, out: int = 7, sr: int = 2) -> tuple[int, int]:
    """(valid rois, distinct tapped pixels summed over them): K3's
    reductions per channel slice, against 4 * (out * sr)^2 corner adds per
    valid roi for the scatter it replaced."""
    import torch

    from cald_tpu_torch.ops import roi_align as plain

    keep = valid.reshape(-1)
    r = rois.reshape(-1, 4)[keep].float()
    lv = levels.reshape(-1)[keep].long()
    pyr = plain._Pyramid(shapes, cs.SCALES, rois.device)
    scale = pyr.scales[lv]
    x1, y1 = r[:, 0] * scale, r[:, 1] * scale
    rw = (r[:, 2] * scale - x1).clamp_min(1.0)
    rh = (r[:, 3] * scale - y1).clamp_min(1.0)

    def distinct(start, extent, n):
        pix, wt = plain._pooled_taps(start, extent, n, out, sr, False)
        big = int(n.max()) + 1
        pix = torch.where(wt > 0, pix, torch.full_like(pix, big)).reshape(pix.shape[0], -1)
        occ = torch.zeros(pix.shape[0], big + 1, dtype=torch.bool, device=pix.device)
        occ.scatter_(1, pix, True)
        return occ[:, :big].sum(1)

    nu, nv = distinct(y1, rh, pyr.hs[lv]), distinct(x1, rw, pyr.ws[lv])
    return int(keep.sum()), int((nu * nv).sum())


def _blocks_per_sm(regs: int, threads: int, smem: int) -> int:
    """Resident blocks per SM of an H100 from registers, threads and shared
    memory (256-register allocation units per warp, 64 warps, 32 blocks,
    228 KB of shared memory with 1 KB reserved per block)."""
    warps = math.ceil(threads / 32)
    per_warp = math.ceil(max(regs, 1) * 32 / 256) * 256
    by_regs = (65536 // per_warp) // warps
    by_smem = (228 * 1024) // (smem + 1024)
    return min(32, 64 // warps, by_regs, by_smem)


def ptxas_report(source: Path) -> list[dict]:
    """Per kernel: registers, spill bytes, static shared memory from
    ``nvcc -Xptxas -v`` (sm_90a, -O3, as ``ops/cuda_build.py`` builds)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"
    res = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                          "-Xptxas", "-v", "-c", "-o", os.devnull, str(source)],
                         capture_output=True, text=True, check=True)
    rows, cur = [], None
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(s.group(1)) if s else 0
    # the kernels the main path runs: the forwards at sr = 2 (new) and the
    # backward
    keep = [r for r in rows if "registers" in r and (
        "roi_align_bwd_kernel" in r["kernel"]
        or ("roi_align_fwd_kernel" in r["kernel"] and not re.search(r"ELi[134]EE", r["kernel"])))]
    for r in keep:
        threads, smem = _launch_shape(r["kernel"])
        r["threads"], r["dynamic_smem"] = threads, smem
        r["blocks_per_sm"] = _blocks_per_sm(r["registers"], threads, smem + r["static_smem"])
    return keep


def sass_reductions(lib: Path) -> dict:
    """The reduction and atomic opcodes in a built library."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME, "bin", "cuobjdump") if CUDA_HOME else "cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    return dict(Counter(re.findall(r"\b((?:REDG?|ATOMG?)\.[A-Za-z0-9_.]+)", out)))


# edits of the new source for the K3 breakdown: (what is replaced, by what)
K3_CUTS = {
    "no reductions": ("add_vec<V>(col + (size_t)uniq[u] * w * c, acc);",
                      "if (acc[0] == 1234.5f) col[(size_t)uniq[u] * w * c] = acc[V - 1];"),
    "no loads": ("Vec<float, V>::unpack(Vec<float, V>::load(gx + (size_t)y * s * c), gv);",
                 "for (int e = 0; e < V; ++e) gv[e] = (float)(x + y + e);"),
}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="an earlier roi_align.cu")
    ap.add_argument("--out", default="cald_tpu_torch/build/roi_kernel_turns.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("roi_kernel_turns: CUDA is not available", file=sys.stderr)
        return 2
    from cald_tpu_torch.ops import roi_align as plain
    from cald_tpu_torch.ops.cuda_build import build_library
    from cald_tpu_torch.ops.roi_align_cuda import (
        RoIAlignBackward, RoIAlignKernel, RoIAlignTrainForward,
    )

    card = cs.card_line()
    print(card)
    old_src = Path(args.old).resolve()
    kern = {}
    for tag, src in (("old", old_src), ("new", NEW)):
        ks = (RoIAlignKernel(), RoIAlignTrainForward(), RoIAlignBackward())
        for k in ks:
            k.source = src
            k.load()
        kern[tag] = ks
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    for tag, src in (("old", old_src), ("new", NEW)):
        report[f"ptxas_{tag}"] = ptxas_report(src)
        report[f"sass_{tag}"] = sass_reductions(build_library(src))
        for r in report[f"ptxas_{tag}"]:
            print(f"ptxas {tag}: {r['kernel']}: {r['registers']} registers, spills "
                  f"{r.get('spill_stores', 0)}/{r.get('spill_loads', 0)} bytes, shared "
                  f"{r['static_smem']} static + {r['dynamic_smem']} dynamic bytes, "
                  f"{r['threads']} threads, {r['blocks_per_sm']} blocks per SM")
        print(f"sass {tag}: reductions {report[f'sass_{tag}']}")

    dev = torch.device("cuda", 0)
    timed = {}

    def turns(name, fns, reps=20):
        t = {k: [] for k in fns}
        order = list(fns)
        for k in [*order, *reversed(order)]:
            t[k].append(cs.cuda_ms(fns[k], reps))
        timed[name] = t
        print(f"{name} (CUDA events, mean of {reps}, in turns "
              f"{' '.join([*order, *reversed(order)])}): "
              + "; ".join(f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in t.items()) + f" on {card}")

    # K1 at phase 3's shapes
    feats, rois, valid = cs.roi_inputs(dev)
    fb = [f.bfloat16() for f in feats]
    del feats
    mis = [fb[0], _misaligned(fb[1]), *fb[2:]]
    k1 = {t: kern[t][0] for t in kern}
    diff = (k1["new"](fb, rois, valid, spatial_scales=cs.SCALES).float()
            - k1["old"](fb, rois, valid, spatial_scales=cs.SCALES).float()).abs().max().item()
    print(f"K1 new vs old, bf16: max abs difference {diff:.3e}")
    turns("K1 B=8 N=1000 C=256 bf16", {
        "old": lambda: k1["old"](fb, rois, valid, spatial_scales=cs.SCALES),
        "new": lambda: k1["new"](fb, rois, valid, spatial_scales=cs.SCALES)})
    turns("K1 new, vector and scalar path", {
        "vector": lambda: k1["new"](fb, rois, valid, spatial_scales=cs.SCALES),
        "scalar": lambda: k1["new"](mis, rois, valid, spatial_scales=cs.SCALES)})
    del fb, mis
    # K1 at the batched aug detect's shapes: 4 augs x 8 images
    feats, rois, valid = cs.roi_inputs(dev, b=4 * cs.BATCH)
    fb = [f.bfloat16() for f in feats]
    del feats
    turns("K1 B=32 N=1000 C=256 bf16", {
        t: (lambda t=t: k1[t](fb, rois, valid, spatial_scales=cs.SCALES)) for t in ("old", "new")})
    del fb

    # K2 and K3 at phase 6's shapes; K3 also on uniform rois
    mixes = {"train": cs.train_roi_inputs(dev),
             "uniform": cs.roi_inputs(dev, b=cs.TRAIN_BATCH, n=cs.TRAIN_SAMPLES)}
    for mix, (feats, rois, valid) in mixes.items():
        levels = plain.roi_levels(rois, cs.SCALES).contiguous()
        shapes = [f.shape for f in feats]
        cot = torch.randn((*rois.shape[:2], 7, 7, feats[0].shape[-1]), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(cs.SEED))
        cot_mis = _misaligned(cot)
        n_valid, n_pix = footprint(rois, valid, levels, shapes)
        report[f"footprint_{mix}"] = {"valid_rois": n_valid, "distinct_pixels": n_pix,
                                      "corner_adds": n_valid * 4 * 14 * 14}
        print(f"K3 {mix} rois: {n_valid} valid, {n_pix} distinct footprint pixels (one "
              f"reduction each per channel slice) against {n_valid * 4 * 14 * 14} corner adds")
        fb = [f.bfloat16() for f in feats]
        del feats
        k2 = {t: kern[t][1] for t in kern}
        k3 = {t: kern[t][2] for t in kern}
        if mix == "train":
            turns(f"K2 {mix} rois B=4 S=512 C=256 bf16", {
                t: (lambda t=t: k2[t](fb, rois, valid, levels, spatial_scales=cs.SCALES))
                for t in ("old", "new")})
        turns(f"K3 {mix} rois B=4 S=512 C=256", {
            t: (lambda t=t: k3[t](cot, rois, valid, levels, shapes, spatial_scales=cs.SCALES))
            for t in ("old", "new")})
        turns(f"K3 new {mix} rois, vector and scalar path", {
            "vector": lambda: k3["new"](cot, rois, valid, levels, shapes,
                                        spatial_scales=cs.SCALES),
            "scalar": lambda: k3["new"](cot_mis, rois, valid, levels, shapes,
                                        spatial_scales=cs.SCALES)})
        # the wrapper's zero-fill of the level gradients, inside every K3 time
        timed[f"K3 zero-fill {mix}"] = cs.cuda_ms(
            lambda: [torch.zeros(tuple(s), dtype=torch.float32, device=dev) for s in shapes], 20)
        print(f"K3 zero-fill of the level gradients ({mix}): "
              f"{timed[f'K3 zero-fill {mix}']:.4f} ms")
        del fb, cot, cot_mis

    # the K3 breakdown at phase 6's inputs
    feats, rois, valid = mixes["train"]
    levels = plain.roi_levels(rois, cs.SCALES).contiguous()
    shapes = [f.shape for f in feats]
    cot = torch.randn((*rois.shape[:2], 7, 7, feats[0].shape[-1]), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(cs.SEED))
    text = NEW.read_text()
    cut = {"new": kern["new"][2]}
    for name, (a, b) in K3_CUTS.items():
        if a not in text:
            raise SystemExit(f"roi_kernel_turns: the K3 source no longer has {a!r}")
        path = Path(args.out).parent / f"roi_align_{name.replace(' ', '_')}.cu"
        path.write_text(text.replace(a, b))
        cut[name] = RoIAlignBackward()
        cut[name].source = path
    turns("K3 breakdown, train rois", {
        k: (lambda k=k: cut[k](cot, rois, valid, levels, shapes, spatial_scales=cs.SCALES))
        for k in cut})
    report["times_ms"] = timed
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
