"""Time the fused-bottleneck kernels of ``cald_tpu_torch/csrc/bottleneck.cu``
(K5, one block per launch; K6, a stage's stride-1 suffix through its group
plan) against another version of that source, in turns, on one GPU.

    python3 bottleneck_turns.py --old OLD.cu [--sweep] [--out cald_tpu_torch/build/bottleneck_turns.json]

``OLD.cu`` is a copy of an earlier ``bottleneck.cu`` with the same C entry
points (for instance ``git show b5e9062:cald_tpu_torch/csrc/bottleneck.cu``),
run at the tile plan it shipped with (``OLD_PLAN``); the new source runs at
``ops/bottleneck.py``'s plan. At ``chip_smoke.py``'s phase-8 inputs (R50's
four stride-1 suffixes on the 640x1024 canvas, B=8, bf16, seeded folded
weights) it prints, per stage:

  * the new kernel's bf16 mean relative error against the f32 plain chain
    and its largest difference from the old kernel;
  * K5 (chained over the suffix) and K6, old, new, new, old (CUDA events,
    mean of 10 launches after one warm-up), on weights restaged once
    beforehand, and the restaging (``_kernel_weights``) apart;
  * the grid, shared memory and blocks per SM of each launch.

With ``--sweep`` it also times, per stage, the new K5 in turns with copies
of its source that skip the cp.async copies or the mma.sync products
(``BREAKDOWN``), and the new source and edited copies of it (``VARIANTS``: a
ring of 3 stages; k-slabs of 32; ring stages of 256 rows, which admit a
1 x 8 warp layout; warp tiles of 64 x 32) over every tile that fits, and K6
groups of 2 and 3 (mean of 5). It prints what ``nvcc -Xptxas -v`` reports
for each source's kernels (registers per thread, spills, static shared
memory) and writes everything to ``--out`` as JSON. Exits non-zero without
CUDA. JAX is not imported.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

import chip_smoke as cs
from roi_kernel_turns import _blocks_per_sm, ptxas_rows

NEW = Path(__file__).resolve().parent / "cald_tpu_torch" / "csrc" / "bottleneck.cu"
# the tile plan shipped with b5e9062's bottleneck.cu at R50's suffixes in bf16:
# K5's (th, tw) and K6's groups (g, th, tw)
OLD_PLAN = {"layer1": ((16, 16), [(2, 8, 16)]), "layer2": ((8, 16), [(1, 8, 16)] * 3),
            "layer3": ((8, 8), [(1, 8, 8)] * 5), "layer4": ((4, 8), [(1, 4, 8)] * 2)}
# edited copies of the new source for the sweep: (what is replaced, by what)
VARIANTS = {"stages3": [("kStages = 2;", "kStages = 3;")],
            "bk32": [("kBK = 64;", "kBK = 32;")],
            "ring256": [("kRingRows = 192;", "kRingRows = 256;")],
            "warp64x32": [("kMI = 2;", "kMI = 4;"), ("kRingRows = 192;", "kRingRows = 256;")]}
# copies of the new source with a part cut out, timed in turns with it at
# the plan's tiles to see where the time goes (their outputs are garbage)
BREAKDOWN = {"no copies": [('"cp.async.cg.shared.global [%0], [%1], 16, %2;\\n"', '""')],
             "no mma": [("for (int ni = 0; ni < kNI; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], "
                         "b[ni][1]);",
                         "for (int ni = 0; ni < kNI; ++ni) acc[mi][ni][0] += "
                         "__uint_as_float(a[mi][0] ^ b[ni][0] ^ b[ni][1]);")]}
THREADS = 256


def _old_smem(th: int, tw: int, g: int, c: int, p: int) -> int:
    """b5e9062's dynamic shared memory of one bf16 block (no ring)."""
    sec = lambda n: -(-n * 2 // 16) * 16
    inner = (th + 2 * g - 2) * (tw + 2 * g - 2)
    return ((sec(inner * (c + 8)) if g > 1 else 0) + sec((th + 2 * g) * (tw + 2 * g) * (p + 8))
            + sec(inner * (p + 8)))


def _ring_bytes(source_text: str) -> int:
    """The bf16 ring's bytes of a bottleneck.cu (kStages x kRingRows x (kBK + kPad))."""
    k = {n: int(v) for n, v in re.findall(r"constexpr int (k\w+) = (\d+);", source_text)}
    return k["kStages"] * k["kRingRows"] * (k["kBK"] + k["kPad"]) * 2


def _bf16_regs(rows: list[dict]) -> dict:
    """ptxas's row of the bf16, 16-byte-aligned instantiation."""
    return next(r for r in rows if "bottleneck_chain_kernel" in r["kernel"]
                and "nv_bfloat16" in r["kernel"] and "Lb1E" in r["kernel"])


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="an earlier bottleneck.cu")
    ap.add_argument("--sweep", action="store_true", help="also time tiles and source variants")
    ap.add_argument("--out", default="cald_tpu_torch/build/bottleneck_turns.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bottleneck_turns: CUDA is not available", file=sys.stderr)
        return 2
    from cald_tpu_torch.ops import bottleneck as plain
    from cald_tpu_torch.ops.bottleneck_cuda import (
        FusedBlockKernel, FusedStageKernel, _kernel_weights,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card)
    out_dir = Path(args.out).parent
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {"old": Path(args.old).resolve(), "new": NEW}
    if args.sweep:
        text = NEW.read_text()
        for name, edits in {**VARIANTS, **BREAKDOWN}.items():
            var = text
            for a, b in edits:
                if a not in var:
                    raise SystemExit(f"bottleneck_turns: the source no longer has {a!r}")
                var = var.replace(a, b)
            sources[name] = out_dir / f"bottleneck_{name.replace(' ', '_')}.cu"
            sources[name].write_text(var)
    kern = {}
    for tag, src in sources.items():
        kern[tag] = (FusedBlockKernel(), FusedStageKernel())
        for k in kern[tag]:
            k.source = src
    # one nvcc per source (and one for -Xptxas -v), started together
    with ThreadPoolExecutor(2 * len(sources)) as ex:
        built = [ex.submit(kern[t][0].load) for t in sources]
        ptx = {t: ex.submit(ptxas_rows, src) for t, src in sources.items()}
        for f in built:
            f.result()
        for k in (k for ks in kern.values() for k in ks):
            k.load()
        ptx = {t: f.result() for t, f in ptx.items()}
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "ptxas": ptx, "stages": {}}
    regs = {}
    for tag, rows in ptx.items():
        r = _bf16_regs(rows)
        regs[tag] = r
        print(f"ptxas {tag}: bf16 aligned kernel {r['registers']} registers, spills "
              f"{r.get('spill_stores', 0)}/{r.get('spill_loads', 0)} bytes, static shared "
              f"{r['static_smem']} bytes")

    texts = {t: src.read_text() for t, src in sources.items() if t != "old"}

    def occupancy(tag, th, tw, g, c, p):
        """(dynamic shared bytes, blocks per SM) of one launch of a source."""
        smem = _old_smem(th, tw, g, c, p)
        if tag != "old":
            smem = plain.smem_bytes(th, tw, g, c, p, 2) - plain.RING_BYTES + _ring_bytes(texts[tag])
        return smem, _blocks_per_sm(regs[tag]["registers"], THREADS, smem + regs[tag]["static_smem"])

    dev = torch.device("cuda", 0)
    for stage, h, w, c, p, n in cs.R50_SUFFIXES:
        rng = np.random.default_rng(cs.SEED + h)
        x = torch.from_numpy(np.abs(rng.normal(0, 1, (cs.BATCH, c, h, w))).astype(np.float32))
        x = x.to(dev).contiguous(memory_format=torch.channels_last)
        blocks = cs.folded_blocks(c, p, n, dev, cs.SEED + h)
        want = plain.fused_stage(x, blocks)
        xb = x.bfloat16()
        del x
        per_block = [_kernel_weights(xb, [b], "K5") for b in blocks]
        new_tile = plain.block_tile(h, w, c, p, 2)
        new_plan = plain.stage_plan(h, w, c, p, n, 2)
        old_tile, old_plan = OLD_PLAN[stage]
        groups = {}

        def k6_weights(plan):
            out, i = [], 0
            for g, _, _ in plan:
                if (g, i) not in groups:
                    groups[(g, i)] = _kernel_weights(xb, blocks[i: i + g], "K6")
                out.append(groups[(g, i)])
                i += g
            return out

        def k5(tag, tile):
            def run():
                y = xb
                for wts in per_block:
                    y = kern[tag][0].launch_staged(y, wts, *tile)
                return y
            return run

        def k6(tag, plan):
            wts = k6_weights(plan)

            def run():
                y = xb
                for (g, th, tw), wt in zip(plan, wts):
                    y = kern[tag][1].launch_staged(y, wt, th, tw, g)
                return y
            return run

        got = {"old5": k5("old", old_tile)(), "new5": k5("new", new_tile)(),
               "old6": k6("old", old_plan)(), "new6": k6("new", new_plan)()}
        torch.cuda.synchronize()
        scale = want.abs().mean().item()
        rel = {k: (v.float() - want).abs().mean().item() / scale for k, v in got.items()}
        diff = max((got["new5"].float() - got["old5"].float()).abs().max().item(),
                   (got["new6"].float() - got["old6"].float()).abs().max().item())
        del got
        grid = lambda tile: math.ceil(h / tile[-2]) * math.ceil(w / tile[-1]) * cs.BATCH
        row = {"H": h, "W": w, "C": c, "P": p, "blocks": n, "bf16_mean_rel": rel,
               "max_diff_new_old": diff, "old_tile": old_tile, "new_tile": new_tile,
               "old_plan": old_plan, "new_plan": new_plan,
               "occupancy": {"old K5": (grid(old_tile), *occupancy("old", *old_tile, 1, c, p)),
                             "new K5": (grid(new_tile), *occupancy("new", *new_tile, 1, c, p)),
                             "old K6": [(grid(t), *occupancy("old", t[1], t[2], t[0], c, p))
                                        for t in old_plan],
                             "new K6": [(grid(t), *occupancy("new", t[1], t[2], t[0], c, p))
                                        for t in new_plan]}}
        print(f"{stage} B={cs.BATCH} {h}x{w} C={c} P={p} blocks={n}: bf16 mean rel vs f32 plain "
              + ", ".join(f"{k} {v:.4f}" for k, v in rel.items())
              + f"; max |new - old| {diff:.3e}; (grid, shared bytes, blocks per SM) "
              + json.dumps(row["occupancy"]))
        if not max(rel.values()) < 0.03:
            raise AssertionError(f"bottleneck_turns: a kernel disagrees with the plain chain at {stage}")

        fns = {"K5 old": k5("old", old_tile), "K5 new": k5("new", new_tile),
               "K6 old": k6("old", old_plan), "K6 new": k6("new", new_plan)}
        times = {k: [] for k in fns}
        for pair in (("K5 old", "K5 new"), ("K6 old", "K6 new")):
            for k in (*pair, *reversed(pair)):
                times[k].append(cs.cuda_ms(fns[k], 10))
        restage = cs.cuda_ms(lambda: [_kernel_weights(xb, [b], "K5") for b in blocks], 10)
        row["ms"], row["restage_ms"] = times, restage
        print(f"{stage} in turns (CUDA events, mean of 10, old new new old): "
              + "; ".join(f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in times.items())
              + f"; restaging the {n} blocks' weights {restage:.4f} ms on {card}")

        if args.sweep:
            fns = {tag: k5(tag, new_tile) for tag in ("new", *BREAKDOWN)}
            parts = {k: [] for k in fns}
            for k in [*fns, *reversed(list(fns))]:
                parts[k].append(cs.cuda_ms(fns[k], 10))
            row["breakdown_ms"] = parts
            print(f"{stage} K5 breakdown at {new_tile} (in turns): " + "; ".join(
                f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in parts.items()))
            sweep = []
            for tag in ("new", *VARIANTS):
                for th in plain.TILE_SIDES:
                    for tw in plain.TILE_SIDES:
                        if th >= 2 * h or tw >= 2 * w or th * tw < 16:
                            continue
                        try:
                            ms = cs.cuda_ms(k5(tag, (th, tw)), 5)
                        except RuntimeError:          # the tile does not fit this source
                            continue
                        sweep.append({"source": tag, "kernel": "K5", "tile": (th, tw),
                                      "ms": ms, "grid": grid((th, tw)),
                                      "smem_blocks_per_sm": occupancy(tag, th, tw, 1, c, p)})
                for g in (2, 3):
                    if g > n:
                        continue
                    for th in plain.TILE_SIDES:
                        for tw in plain.TILE_SIDES:
                            if th >= 2 * h or tw >= 2 * w or th * tw < 16:
                                continue
                            plan = [(g, th, tw)] * (n // g) + [(1, *new_tile)] * (n % g)
                            try:
                                ms = cs.cuda_ms(k6(tag, plan), 5)
                            except RuntimeError:
                                continue
                            sweep.append({"source": tag, "kernel": "K6", "plan": plan, "ms": ms,
                                          "grid": grid((th, tw)),
                                          "smem_blocks_per_sm": occupancy(tag, th, tw, g, c, p)})
            sweep.sort(key=lambda r: r["ms"])
            row["sweep"] = sweep
            for r in sweep[:12]:
                print(f"{stage} sweep: {r['source']} {r['kernel']} "
                      f"{r.get('tile') or r.get('plan')} {r['ms']:.4f} ms, grid {r['grid']}, "
                      f"(shared bytes, blocks per SM) {r['smem_blocks_per_sm']}")
        report["stages"][stage] = row
        del xb, want, per_block, groups
        torch.cuda.empty_cache()

    tot = {k: [sum(r["ms"][k][i] for r in report["stages"].values()) for i in (0, 1)]
           for k in ("K5 old", "K5 new", "K6 old", "K6 new")}
    report["total_ms"] = tot
    print("total over R50's four suffixes, B=8: " + "; ".join(
        f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in tot.items()) + f" on {card}")
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
