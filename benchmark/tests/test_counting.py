"""The operation counts of ``harness/counting.py`` equal what
``torch.utils.flop_counter.FlopCounterMode`` counts on the plain reference
at a small canvas: a detect of each configuration."""

import json
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness.check_score import reference_model  # noqa: E402
from harness.counting import detect_flops  # noqa: E402

H, W = 128, 192


def _model(name: str):
    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    torch.manual_seed(0)
    model = reference_model(config, "cpu")
    for p in model.parameters():
        torch.nn.init.normal_(p, 0.0, 0.01)
    return model


@pytest.mark.parametrize("name", ["faster_r50fpn_voc", "retina_r50fpn_voc"])
def test_detect_flops(name):
    model = _model(name)
    images = torch.rand(1, H, W, 3) * 255
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model.detect(images, torch.tensor([[H, W]]))
    assert counter.get_total_flops() == detect_flops(model.cfg, H, W)

