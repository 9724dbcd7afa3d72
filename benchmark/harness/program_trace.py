"""The program's own spans and counters in a traced window, placed on the
trace's clock.

While the profiler traces the window, ``cald_tpu_torch.utils.spans`` keeps
the program's spans in memory: ``score.batch`` around each score call with
its stages inside, the detectors' stages, every ``nms`` with its counter
``nms.sweeps``, the loader's. The readers run after the window and read the
recorder's snapshot; the check runs only the plain reference, which records
nothing. A program without the recorder, or a window whose ``score.batch``
spans are not one a completed batch (on the CPU no profiler runs, so none
were recorded), gives ``None``.

Each batch's spans are placed on the trace's clock by the benchmark's own
``score_fn`` span of the same batch (already on that clock, ``trace.py``):
the two open microseconds apart around the same call.
"""

from __future__ import annotations

import bisect
import dataclasses

SCORE_FN = "score_fn"       # the benchmark's span around each score call
BATCH = "score.batch"       # the program's root span of a score call


@dataclasses.dataclass
class Placed:
    name: str
    t0: float               # seconds, the trace's clock
    t1: float
    request: int
    thread: int
    device_ms: float | None


@dataclasses.dataclass
class Program:
    spans: list             # Placed, every closed span of the window
    batch_requests: set     # the request ids of the score batches
    thread: int             # the scoring thread
    counts: dict            # every counter's total over the window


def _recorder_snapshot():
    try:
        from cald_tpu_torch.utils import spans
    except ImportError:     # a program without the recorder
        return None, None
    return spans.snapshot(), spans.device_ms


def program(run, snap: dict | None = None, device_ms=None) -> Program | None:
    """The window's program spans on the trace's clock, or None. ``snap``
    and ``device_ms`` stand in for the recorder's (tests)."""
    if snap is None:
        snap, device_ms = _recorder_snapshot()
        if snap is None:
            return None
    closed = [s for s in snap["spans"] if s["end_ns"] is not None]
    batches = sorted((s for s in closed if s["name"] == BATCH), key=lambda s: s["start_ns"])
    calls = sorted(s for s in run.trace.spans if s[2] == SCORE_FN)
    if not batches or len(batches) != run.batches or len(calls) != len(batches):
        return None
    offsets = [c[0] - b["start_ns"] / 1e9 for c, b in zip(calls, batches)]
    by_request = {b["request"]: o for b, o in zip(batches, offsets)}
    starts = [b["start_ns"] for b in batches]

    def offset(s):
        if s["request"] in by_request:
            return by_request[s["request"]]
        return offsets[max(0, bisect.bisect_right(starts, s["start_ns"]) - 1)]

    placed = []
    for s in closed:
        o = offset(s)
        placed.append(Placed(s["name"], s["start_ns"] / 1e9 + o, s["end_ns"] / 1e9 + o,
                             s["request"], s["thread"],
                             device_ms(s) if device_ms is not None else None))
    return Program(placed, set(by_request), batches[0]["thread"], dict(snap["counts"]))


def _gaps(trace):
    """The device's idle stretches (start, end) between the first and the
    last of the benchmark's spans, as ``trace.breakdown`` counts them."""
    spans = trace.spans
    if not spans:
        return
    end, horizon = spans[0][0], spans[-1][1]
    for a, b, _ in trace.device_ops + [(horizon, horizon, "")]:
        if a > end:
            yield end, a
        end = max(end, b)


def idle_by_span(run, prog: Program | None = None) -> dict | None:
    """Seconds of device idle by the innermost program span open on the
    scoring thread at each idle stretch's midpoint; a stretch in none goes
    to the benchmark's span there (``loader_wait``, ``score_fn``,
    ``select``), else to ``outside``."""
    prog = program(run) if prog is None else prog
    if prog is None:
        return None
    own = sorted((s for s in prog.spans if s.thread == prog.thread),
                 key=lambda s: (s.t0, -s.t1))
    bench = run.trace.spans
    bench_starts = [s[0] for s in bench]
    out: dict = {}
    stack: list = []
    i = 0
    for a, b in _gaps(run.trace):
        mid = (a + b) / 2
        while i < len(own) and own[i].t0 <= mid:
            while stack and stack[-1].t1 <= own[i].t0:
                stack.pop()
            stack.append(own[i])
            i += 1
        while stack and stack[-1].t1 <= mid:
            stack.pop()
        if stack:
            name = stack[-1].name
        else:
            j = bisect.bisect_right(bench_starts, mid) - 1
            name = bench[j][2] if j >= 0 and bench[j][1] >= mid else "outside"
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def stage_ms(run, name: str, prog: Program | None = None) -> float | None:
    """Device milliseconds between the CUDA events of every span ``name``
    of the score batches, summed; None where a span has no events."""
    prog = program(run) if prog is None else prog
    if prog is None:
        return None
    ms = [s.device_ms for s in prog.spans
          if s.name == name and s.request in prog.batch_requests]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms)
