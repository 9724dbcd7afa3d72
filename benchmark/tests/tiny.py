"""A cell at a size the CPU runs in seconds, for the harness's CPU tests:
the tiny ResNet detector (a configuration of another backbone keeps it, at
its own widths) on a pool of 32 small JPEGs, batches of 4. Imported once
``benchmark/`` is on ``sys.path``."""

import copy
import json
from pathlib import Path

from plainref.models.faster_rcnn import BACKBONES

BENCH = Path(__file__).resolve().parents[1]


def config(name: str = "faster_r50fpn_voc") -> dict:
    """The configuration ``name`` (``BENCHMARK.json``'s entry) at the tiny
    size."""
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"] if c["name"] == name)
    c = json.loads((BENCH.parent / entry["file"]).read_text())
    c["min_size"], c["max_size"] = 64, 128
    det = c["detector"]
    if det["backbone"] in BACKBONES:
        det["backbone"] = "tiny"
    if c["model"] == "faster":
        det.update(rpn_pre_nms_top_n_test=128, rpn_post_nms_top_n_test=64,
                   detections_per_img=16, representation_size=64)
    else:
        det.update(detections_per_img=16, topk_candidates=64,
                   anchor_sizes=[[16, 20]] * 5)
    return c


def traffic(name: str = "voc07_pool1024_staged") -> dict:
    with open(BENCH / "traffic" / f"{name}.json") as f:
        t = json.load(f)
    t = copy.deepcopy(t)
    t["sizes"] = [{"height": 48, "width": 64, "count": 24},
                  {"height": 64, "width": 48, "count": 8}]
    t.update(labeled_images=8, batch_size=4, workers=2, budget=4, traced_batches=6)
    return t
