"""``harness/program_trace.py`` on a hand-made trace and span set: each
batch's program spans placed by its own ``score_fn`` span, each idle
stretch given to the innermost program span open at its midpoint, the
stages' device milliseconds summed, and ``None`` where the spans do not
match the window's batches."""

import sys
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness.program_trace import idle_by_span, program, stage_ms  # noqa: E402
from harness.trace import Trace  # noqa: E402

SCORING, LOADER = 7, 8


class _Event:
    def __init__(self, ms: float):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end: "_Event") -> float:
        return end.ms - self.ms


def _span(i, name, t0, t1, parent, request, thread=SCORING, counts=None, ms=None):
    """A recorder span, ``t0``/``t1`` in host seconds; ``ms`` the pair of
    event readings (stands in for the CUDA events)."""
    return {"name": name, "id": i, "parent": parent, "request": request, "thread": thread,
            "start_ns": round(t0 * 1e9), "end_ns": round(t1 * 1e9), "counts": counts or {},
            "events": None if ms is None else (_Event(ms[0]), _Event(ms[1]))}


def _device_ms(s):
    return None if s["events"] is None else s["events"][0].elapsed_time(s["events"][1])


def _window(host_offsets=(500.0, 500.25)):
    """Two batches. On the trace's clock: ``score_fn`` at [1.0, 2.0] and
    [3.0, 4.0]; the program's ``score.batch`` opens 1 us after it, on a host
    clock ``host_offsets[k]`` s ahead (a different one each batch, so only
    per-batch anchoring places both). Device operations leave idle
    stretches inside ``nms`` (1.40-1.50, 3.40-3.46), in ``detect.trunk``
    (1.10-1.12), in the batch outside its stages (1.90-1.96), and in the
    benchmark's ``select`` (2.1-2.3)."""
    ops = [(1.0, 1.10, "k"), (1.12, 1.40, "k"), (1.50, 1.90, "k"), (1.96, 2.1, "k"),
           (2.3, 3.40, "k"), (3.46, 4.0, "k")]
    bench = [(1.0, 2.0, "score_fn"), (2.05, 2.35, "select"), (3.0, 4.0, "score_fn")]
    recorded = []
    i = 0
    for k, (base, host) in enumerate(zip((1.0, 3.0), host_offsets)):
        def at(t, host=host):
            return t + host
        root = i + 1
        recorded.append(_span(root, "score.batch", at(base + 1e-6), at(base + 0.99), None,
                              k + 1, ms=(0.0, 990.0)))
        detect = root + 1
        recorded.append(_span(detect, "score.base_detect", at(base + 0.01), at(base + 0.8),
                              root, k + 1, ms=(10.0, 800.0)))
        recorded.append(_span(detect + 1, "detect.trunk", at(base + 0.02), at(base + 0.3),
                              detect, k + 1, ms=(20.0, 300.0 + k)))
        recorded.append(_span(detect + 2, "nms", at(base + 0.35), at(base + 0.6), detect,
                              k + 1, counts={"nms.sweeps": 3 + k}, ms=(350.0, 600.0)))
        # the loader's worker thread: its own request, never the scoring thread's
        recorded.append(_span(detect + 3, "loader.build", at(base + 0.3), at(base + 0.9),
                              None, 10 + k, thread=LOADER))
        i = detect + 3
    snap = {"spans": recorded, "counts": {"nms.sweeps": 7}}
    run = SimpleNamespace(trace=Trace(ops, bench, 0), batches=2)
    return run, snap


def _prog(run, snap):
    return program(run, snap, _device_ms)


def test_each_batch_is_placed_by_its_own_score_fn_span():
    run, snap = _window()
    prog = _prog(run, snap)
    batches = [s for s in prog.spans if s.name == "score.batch"]
    # each at its score_fn's start (the microsecond between the two is dropped)
    assert [s.t0 for s in batches] == [1.0, 3.0]
    trunks = [s for s in prog.spans if s.name == "detect.trunk"]
    assert [round(s.t0, 5) for s in trunks] == [1.02, 3.02]
    loader = [s for s in prog.spans if s.name == "loader.build"]
    assert [round(s.t0, 5) for s in loader] == [1.3, 3.3]      # the batch it overlaps
    assert prog.thread == SCORING and prog.batch_requests == {1, 2}
    assert prog.counts == {"nms.sweeps": 7}


def test_idle_goes_to_the_innermost_program_span():
    run, snap = _window()
    idle = idle_by_span(run, _prog(run, snap))
    got = {k: round(v, 9) for k, v in idle.items()}
    # 1.40-1.50 and 3.40-3.46 in nms; 1.10-1.12 in the trunk; 1.90-1.96 in the
    # batch; 2.1-2.3 in the benchmark's select, between the batches; the
    # loader's span, on another thread, takes nothing
    assert got == {"nms": 0.16, "detect.trunk": 0.02, "score.batch": 0.06, "select": 0.2}


def test_a_host_clock_that_moves_between_batches_places_the_same():
    # the same window with one host offset for both batches
    run, snap = _window(host_offsets=(500.0, 500.0))
    same = idle_by_span(run, _prog(run, snap))
    run, snap = _window()
    assert idle_by_span(run, _prog(run, snap)) == same


def test_stage_ms_sums_the_batches_spans():
    run, snap = _window()
    prog = _prog(run, snap)
    assert stage_ms(run, "detect.trunk", prog) == 280.0 + 281.0
    assert stage_ms(run, "nms", prog) == 500.0
    assert stage_ms(run, "score.batch", prog) == 1980.0
    assert stage_ms(run, "loader.build", prog) is None        # not a score batch's
    snap["spans"][2]["events"] = None
    assert stage_ms(run, "detect.trunk", _prog(run, snap)) is None


def test_none_where_the_spans_do_not_match_the_window():
    run, snap = _window()
    assert _prog(SimpleNamespace(trace=run.trace, batches=3), snap) is None
    fewer = {"spans": [s for s in snap["spans"] if s["request"] != 2], "counts": {}}
    assert _prog(run, fewer) is None
    no_calls = SimpleNamespace(trace=Trace(run.trace.device_ops, [], None), batches=2)
    assert _prog(no_calls, snap) is None
    assert _prog(run, {"spans": [], "counts": {}}) is None


def test_the_readers_give_nothing_without_a_recorded_window():
    import run as bench_run
    from cald_tpu_torch.utils import spans

    spans.clear()
    run, _ = _window()
    for name in ("trunk_ms.score", "nms_ms.score", "augment_ms.score",
                 "nms_sweeps_per_batch.score", "nms_idle_ms.score"):
        assert bench_run.load_reader(name)(run) is None, name
