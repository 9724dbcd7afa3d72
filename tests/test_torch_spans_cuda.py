"""The span recorder's device windows on the card, for one CALD score batch
of the seeded R50-FPN Faster R-CNN and RetinaNet on the 640x1024 canvas:
the ``score.*`` stages tile their ``score.batch``, the timing events add no
device operation to a traced window, and each ``detect.*`` stage's window
covers the kernels launched inside it.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with an H100 and ``nvcc`` run them with ``python -m pytest
tests/test_torch_spans_cuda.py``. This file imports neither JAX nor the JAX
package.
"""

import collections
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cald_tpu_torch.augment.suite import generator_draw
from cald_tpu_torch.strategies import cald
from cald_tpu_torch.utils import spans

pytestmark = pytest.mark.cuda

STAGES = ("score.base_detect", "score.reference", "score.augment", "score.aug_detect",
          "score.consistency")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a span's device window is a pair of CUDA events)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module", params=["faster", "retina"])
def scorer(card, request):
    """(score fn, images, valid_hw) of the seeded detector in bf16, warmed up."""
    import chip_smoke
    from cald_tpu_torch.models.init import random_init_
    from cald_tpu_torch.models.retinanet import RetinaNet, RetinaNetConfig

    batch = chip_smoke.make_pool(chip_smoke.BATCH)[0]
    images = torch.from_numpy(batch.images).to(card)
    valid_hw = torch.from_numpy(batch.valid_hw).to(card)
    if request.param == "faster":
        model = chip_smoke.build_model(card)
    else:
        model = RetinaNet(RetinaNetConfig(num_classes=chip_smoke.NUM_CLASSES,
                                          backbone="resnet50", compute_dtype="bfloat16")).eval()
        random_init_(model, chip_smoke.SEED)
        model.to(card)
        chip_smoke.calibrate_norms_(model, images[:2], valid_hw[:2])
    fn = cald.make_cald_score_fn(model, cald.CALDConfig(), chip_smoke.NUM_CLASSES)
    score = types.SimpleNamespace(
        run=lambda: fn(images, valid_hw,
                       generator_draw(torch.Generator(card).manual_seed(5))))
    score.run()
    torch.cuda.synchronize(card)
    yield score
    spans.clear()


def _traced(score, batches: int = 1):
    """Score ``batches`` batches under a device-only profiler capture, as the
    benchmark's traced window does; returns (profiler, host clock at the
    marker synchronise)."""
    spans.clear()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    t_mark = time.perf_counter_ns()
    torch.cuda.synchronize()
    for _ in range(batches):
        c, corr = score.run()
        c.cpu(), corr.cpu()
    torch.cuda.synchronize()
    prof.stop()
    return prof, t_mark


def test_the_stages_tile_the_score_batch(scorer):
    _traced(scorer, batches=3)
    recorded = spans.snapshot()["spans"]
    batches = [s for s in recorded if s["name"] == "score.batch"]
    assert len(batches) == 3
    for b in batches:
        stages = [s for s in recorded if s["parent"] == b["id"]]
        assert tuple(s["name"] for s in stages) == STAGES
        whole = spans.device_ms(b)
        parts = sum(spans.device_ms(s) for s in stages)
        assert whole > 0 and abs(parts - whole) <= 0.02 * whole, (parts, whole)


def _device_ops(prof) -> collections.Counter:
    from torch.autograd import DeviceType

    return collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                               if e.device_type() == DeviceType.CUDA)


def test_the_events_add_no_device_operation(scorer, monkeypatch):
    on = _device_ops(_traced(scorer)[0])
    assert spans.snapshot()["spans"]
    monkeypatch.setattr(spans, "_profiler", types.SimpleNamespace(_is_profiler_enabled=False))
    off = _device_ops(_traced(scorer)[0])
    assert not spans.snapshot()["spans"]
    assert sum(on.values()) > 100 and on == off


def test_each_detect_stage_covers_its_kernels(scorer):
    """Each kernel is given to the span open when it was launched, by the
    order of the runtime calls on the host (each span's two events are two
    ``cudaEventRecord`` calls), not by a clock; each ``detect.*`` stage's
    device window holds at least the kernels it launched, end to end."""
    from torch.autograd import DeviceType

    prof, _ = _traced(scorer)
    events = list(prof.profiler.kineto_results.events())
    runtime = sorted((e.start_ns(), e.name(), e.correlation_id()) for e in events
                     if e.device_type() != DeviceType.CUDA)
    kernel_ms = {e.correlation_id(): e.duration_ns() / 1e6 for e in events
                 if e.device_type() == DeviceType.CUDA}
    recorded = [s for s in spans.snapshot()["spans"] if s["events"] is not None]
    records = sorted([(s["start_ns"], 0, s) for s in recorded]
                     + [(s["end_ns"], 1, s) for s in recorded], key=lambda r: r[:2])
    assert sum(1 for r in runtime if r[1].startswith("cudaEventRecord")) == len(records)
    launched = collections.defaultdict(list)          # span id -> its kernels' ms
    stack, i = [], 0
    for _, name, corr in runtime:
        if name.startswith("cudaEventRecord"):
            _, closing, s = records[i]
            i += 1
            if closing:
                stack.remove(s)
            else:
                stack.append(s)
        elif "Launch" in name and stack and corr in kernel_ms:
            launched[stack[-1]["id"]].append(kernel_ms[corr])
    by_id = {s["id"]: s for s in recorded}
    stages = [s for s in recorded if s["name"].startswith("detect.")]
    assert {by_id[s["parent"]]["name"] for s in stages} == {"score.base_detect",
                                                            "score.aug_detect"}
    for s in stages:
        mine = launched[s["id"]] + [ms for c in recorded if c["parent"] == s["id"]
                                    for ms in launched[c["id"]]]
        window = spans.device_ms(s)
        assert mine and sum(mine) <= window * 1.001 + 0.005, (s["name"], sum(mine), window)
    # the base detect is the detector's alone: every kernel in one of its stages
    base = next(s for s in recorded if s["name"] == "score.base_detect")
    assert not launched[base["id"]]
