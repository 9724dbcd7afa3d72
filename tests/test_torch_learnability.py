"""End-to-end training signal of the port (port of
tests/test_learnability.py): the tiny detector with group norms, trained by
``cald_tpu_torch.cli.driver.al_loop``, must learn a trivially learnable
dataset (color-coded rectangles) to high per-class AP50. Same configuration
and thresholds as the JAX test; the class mean over all 20 VOC classes stays
low by design (absent classes count, voc_eval.py:258-266). Runs on the CPU
(``device="cpu"``); ``chip_smoke.py`` phase 12 runs the same configuration
on the card at lr 0.0025 (``chip_smoke.LEARN_LR``)."""

import numpy as np
import pytest

from cald_tpu_torch.cli.config import ALConfig
from cald_tpu_torch.cli.driver import al_loop
from cald_tpu_torch.data.synthetic import make_learnable_voc
from cald_tpu_torch.data.voc import get_voc2007


@pytest.mark.slow
def test_tiny_frcnn_learns_colored_boxes(tmp_path):
    root = make_learnable_voc(tmp_path, num_images=32, image_format="npy")
    ds = get_voc2007(root, "trainval")
    cfg = ALConfig(
        dataset="voc2007", data_path=root, model="faster", strategy="random",
        tiny=True, norm="group", cycles=1, epochs=30, batch_size=4,
        init_num=32, budget_num=1, score_batch_size=4, workers=4,
        min_size=96, max_size=128, max_boxes=8, print_freq=100000,
        lr=0.005, lr_steps=(20, 26), aspect_ratio_group_factor=0, device="cpu").resolve()
    hist = al_loop(cfg, datasets=(ds, ds))
    per_class = hist[0]["eval"]["per_class_ap50"]
    present = {k: v for k, v in per_class.items() if k in ("aeroplane", "bicycle", "bird")}
    assert len(present) == 3, per_class
    assert all(v > 0.7 for v in present.values()), present
    assert np.mean(list(present.values())) > 0.85, present
