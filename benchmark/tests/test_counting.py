"""The operation counts of ``harness/counting.py`` equal what
``torch.utils.flop_counter.FlopCounterMode`` counts on the plain reference
at a small canvas: a detect of each configuration of ``BENCHMARK.json``.
The configurations measured before backbones became files of their own keep
their seeded weights and their counts, pinned."""

import hashlib
import json
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness import weights  # noqa: E402
from harness.check_score import reference_model  # noqa: E402
from harness.counting import detect_flops  # noqa: E402
from plainref.models.layers import FrozenBatchNorm  # noqa: E402

H, W = 128, 192
# every configuration of the benchmark, by name: its file
CONFIGS = {c["name"]: c["file"]
           for c in json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]}
SEEDS = (3190000011, 2 ** 31 + 12345)
# the parent's readings: SHA-256 of ``seeded_weights``' state dict a seed;
# the calibrated norms' sum of |mean| and of var a seed (a forward pass on
# the CPU, whose last bits follow its kernels); ``detect_flops`` at two
# canvases
PINNED = {
    "faster_r50fpn_voc": {
        "sha256": ("15ff5f9965fd53f39fceb65d6e11475a6a132c6008d90912170414bfabba7790",
                   "e1c257dd8c671b91fbf87f7d43d3be2eae7e446015ac2c599a3a30d55775221d"),
        "calibrated": ((10635.0693359375, 16120.3046875), (10551.99609375, 16148.9482421875)),
        "flops": {(640, 1024): 273788108800, (832, 1344): 447374333440},
    },
    "retina_r50fpn_voc": {
        "sha256": ("24a3566a17dba8d8c29861acac3b2741b848f3c5daa2428683b16cba55135330",
                   "8c96beabad9c71de8e754e93f6ff6e94093a03952782f143ce23e23d15a745f8"),
        "calibrated": ((10635.0693359375, 16120.3046875), (10551.99609375, 16148.9482421875)),
        "flops": {(640, 1024): 270419169280, (832, 1344): 461504676864},
    },
}


def _config(name: str) -> dict:
    return json.loads((ROOT / CONFIGS[name]).read_text())


def _model(name: str):
    torch.manual_seed(0)
    model = reference_model(_config(name), "cpu")
    for p in model.parameters():
        torch.nn.init.normal_(p, 0.0, 0.01)
    return model


def digest(state_dict) -> str:
    h = hashlib.sha256()
    for k in sorted(state_dict):
        h.update(k.encode())
        h.update(state_dict[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_detect_flops(name):
    model = _model(name)
    images = torch.rand(1, H, W, 3) * 255
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model.detect(images, torch.tensor([[H, W]]))
    assert counter.get_total_flops() == detect_flops(model.cfg, H, W)


@pytest.mark.parametrize("name", sorted(PINNED))
def test_seeded_weights_and_counts_are_the_parents(name):
    config, pinned = _config(name), PINNED[name]
    for seed, sha, (mean_abs, var) in zip(SEEDS, pinned["sha256"], pinned["calibrated"]):
        ref = weights.seeded_weights(config, seed, torch.device("cpu"))
        assert digest(ref.state_dict()) == sha, seed
        g = torch.Generator().manual_seed(0)
        images = torch.rand(2, 128, 192, 3, generator=g) * 255
        weights.calibrate_norms_(ref, images, torch.tensor([[128, 192], [100, 150]]),
                                 config["weights"]["min_var_share"])
        norms = [m for m in ref.modules() if isinstance(m, FrozenBatchNorm)]
        assert float(sum(m.mean.abs().sum() for m in norms)) == pytest.approx(mean_abs, rel=1e-4)
        assert float(sum(m.var.sum() for m in norms)) == pytest.approx(var, rel=1e-4)
    cfg = reference_model(config, "cpu").cfg
    assert {hw: detect_flops(cfg, *hw) for hw in pinned["flops"]} == pinned["flops"]
