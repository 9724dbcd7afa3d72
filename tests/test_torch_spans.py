"""The port's span and counter recorder (``cald_tpu_torch.utils.spans``) on
the CPU: it records only inside a ``torch.profiler`` capture, keeps parent,
request and thread ids per thread, gives counts to the innermost open span,
allocates nothing while off; and the span tree of one CALD score batch of
the tiny Faster R-CNN and RetinaNet, whose answers it leaves bit for bit."""

import threading
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cald_tpu_torch.augment.suite import generator_draw
from cald_tpu_torch.strategies import cald
from cald_tpu_torch.utils import spans
from tests.torch_helpers import TINY, TINY_RETINA, retina_models, tiny_images, tiny_models


@pytest.fixture(autouse=True)
def empty_recorder():
    spans.clear()
    yield
    spans.clear()


def _capture():
    return profile(activities=[ProfilerActivity.CPU])


def _tree(recorded, parent=None):
    """(name, children) of the spans under ``parent``, in the order they opened."""
    return [(s["name"], _tree(recorded, s["id"])) for s in recorded if s["parent"] == parent]


def test_off_outside_a_profiler_on_inside():
    with spans.span("before"):
        spans.count("c")
    assert spans.span("a") is spans.span("b")            # the shared no-op
    assert spans.begin("before") is None
    with _capture():
        with spans.span("inside"):
            spans.count("c", 2)
    with spans.span("after"):
        pass
    snap = spans.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["inside"]
    s = snap["spans"][0]
    assert s["counts"] == {"c": 2} and snap["counts"] == {"c": 2}
    assert s["parent"] is None and s["end_ns"] >= s["start_ns"]
    assert s["events"] is None and spans.device_ms(s) is None      # no card here
    spans.clear()
    assert spans.snapshot() == {"spans": [], "counts": {}}


def test_parent_request_and_thread_ids_across_two_threads():
    both_open = threading.Barrier(2, timeout=30)
    threads = {}

    def work(tag):
        threads[tag] = threading.get_ident()
        with spans.span(f"{tag}.root"):
            with spans.span(f"{tag}.child"):
                both_open.wait()
                with spans.span(f"{tag}.grandchild"):
                    pass
            with spans.span(f"{tag}.second"):
                pass

    with _capture():
        workers = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=30)
        assert not any(w.is_alive() for w in workers)
        with spans.span("main"):
            pass
    recorded = spans.snapshot()["spans"]
    by_name = {s["name"]: s for s in recorded}
    assert len(by_name) == len(recorded) == 9
    assert len({s["id"] for s in recorded}) == 9
    for tag in "ab":
        root, child, grand, second = (by_name[f"{tag}.{n}"]
                                      for n in ("root", "child", "grandchild", "second"))
        assert root["parent"] is None
        assert child["parent"] == second["parent"] == root["id"]
        assert grand["parent"] == child["id"]
        assert {s["request"] for s in (root, child, grand, second)} == {root["request"]}
        assert {s["thread"] for s in (root, child, grand, second)} == {threads[tag]}
    requests = {by_name[n]["request"] for n in ("a.root", "b.root", "main")}
    assert len(requests) == 3
    assert by_name["main"]["thread"] == threading.get_ident()


def test_counts_go_to_the_innermost_open_span():
    with _capture():
        spans.count("n")                                    # in no span: the total only
        with spans.span("outer"):
            spans.count("n")
            with spans.span("inner"):
                spans.count("n", 3)
                spans.count("m")
            spans.count("n", 2)
        t0 = spans.begin("explicit", 10)
        spans.count("n", 5)
        spans.end(t0, 25)
    snap = spans.snapshot()
    counts = {s["name"]: s["counts"] for s in snap["spans"]}
    assert counts == {"outer": {"n": 3}, "inner": {"n": 3, "m": 1}, "explicit": {"n": 5}}
    assert snap["counts"] == {"n": 12, "m": 1}
    explicit = snap["spans"][-1]
    assert (explicit["start_ns"], explicit["end_ns"]) == (10, 25)


def test_off_allocates_nothing_per_call():
    def calls():
        for _ in range(5000):
            with spans.span("score.batch"):
                spans.count("nms.sweeps")
                spans.count("nms.sweeps", 2)
            spans.end(spans.begin("al.cycle"))

    calls()                                                 # warm any lazy state
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        calls()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, spans.__file__)]
    grown = after.filter_traces(only).compare_to(before.filter_traces(only), "lineno")
    assert sum(d.size_diff for d in grown) == 0 and sum(d.count_diff for d in grown) == 0
    assert spans.snapshot() == {"spans": [], "counts": {}}


DETECT = {"faster": ["detect.trunk", ("detect.rpn", ["nms"]), "detect.box_head",
                     ("detect.postprocess", ["nms"])],
          "retina": ["detect.trunk", "detect.head", ("detect.postprocess", ["nms"])]}


def _expected(kind):
    def node(x):
        return (x, []) if isinstance(x, str) else (x[0], [node(c) for c in x[1]])
    detect = [node(x) for x in DETECT[kind]]
    return [("score.batch", [("score.base_detect", detect), ("score.reference", []),
                             ("score.augment", []), ("score.aug_detect", detect),
                             ("score.consistency", [])])]


@pytest.fixture(scope="module")
def detectors():
    return {"faster": (tiny_models()[2], TINY["num_classes"]),
            "retina": (retina_models()[2], TINY_RETINA["num_classes"])}


@pytest.mark.parametrize("kind", ["faster", "retina"])
def test_score_batch_span_tree_sweeps_and_answers(kind, detectors, monkeypatch):
    model, num_classes = detectors[kind]
    fn = cald.make_cald_score_fn(model, cald.CALDConfig(k_ref=8), num_classes)
    images, valid_hw = (torch.from_numpy(a) for a in tiny_images())

    def score():
        return fn(images, valid_hw, generator_draw(torch.Generator().manual_seed(3)))

    off = score()
    equal, checks = torch.equal, [0]

    def counted(a, b):
        checks[0] += 1
        return equal(a, b)

    monkeypatch.setattr(torch, "equal", counted)
    with _capture():
        on = score()
    monkeypatch.setattr(torch, "equal", equal)
    snap = spans.snapshot()
    assert _tree(snap["spans"]) == _expected(kind)
    assert len({s["request"] for s in snap["spans"]}) == 1
    sweeps = sum(s["counts"].get("nms.sweeps", 0) for s in snap["spans"])
    assert checks[0] > 0 and sweeps == checks[0] == snap["counts"]["nms.sweeps"]
    assert all(set(s["counts"]) <= {"nms.sweeps"} for s in snap["spans"])
    assert all(not s["counts"] for s in snap["spans"] if s["name"] != "nms")
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert np.isfinite(on[0].numpy()).all()
