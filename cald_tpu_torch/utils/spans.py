"""In-memory spans and counters of the program's layers, recorded only while
a ``torch.profiler`` capture runs.

``span(name)`` is a context manager around a stage; ``count(name, n)`` adds
to a counter of the innermost span open on the calling thread. Both check
the flag torch sets while a profiler capture runs
(``torch.autograd.profiler._is_profiler_enabled``) and do nothing else when
it is clear: ``span`` hands back one shared no-op object, ``count``
returns, and neither allocates, reads a clock or calls CUDA. So the
benchmark's traced window and ``--profile-dir`` record spans, and every
other run pays one flag check a call.

While recording, each span keeps its name, its id and its parent's (a
stack per thread), a request id (each root span opens a new one, so one
score batch's spans share it), its thread, its start and end on
``time.perf_counter_ns`` and the counts added while it was innermost. With
CUDA initialised it also records a pair of timing events from a pool on
the thread's current stream (not while that stream is being captured into a
CUDA graph), which cost no synchronise; ``device_ms`` reads the stream's
time between them once the capture is over. Nothing is written anywhere and
no NVTX range or profiler annotation is emitted: ``snapshot`` returns what
was recorded and ``clear`` drops it.
"""

from __future__ import annotations

import itertools
import json
import threading
import time

import torch
import torch.autograd.profiler as _profiler

_lock = threading.Lock()
_local = threading.local()
_records: list = []                 # every span opened while recording, in order
_totals: dict = {}                  # every count, inside a span or not
_ids = itertools.count(1)
_requests = itertools.count(1)
_free_events: list = []             # timing events to record again


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _event() -> torch.cuda.Event:
    try:
        return _free_events.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "id", "parent", "request", "thread", "start_ns", "end_ns",
                 "counts", "stream", "events")

    def __init__(self, name: str):
        self.name = name

    def open(self, t_ns: int | None = None) -> "_Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = None, next(_requests)
        self.thread = threading.get_ident()
        self.counts = {}
        self.end_ns = None
        self.stream = self.events = None
        if torch.cuda.is_initialized():
            stream = torch.cuda.current_stream()
            if not torch.cuda.is_current_stream_capturing():
                self.stream, self.events = stream, (_event(), _event())
                self.events[0].record(stream)
        stack.append(self)
        self.start_ns = time.perf_counter_ns() if t_ns is None else t_ns
        _records.append(self)
        return self

    def close(self, t_ns: int | None = None) -> None:
        self.end_ns = time.perf_counter_ns() if t_ns is None else t_ns
        if self.events is not None:
            self.events[1].record(self.stream)
        _local.stack.remove(self)

    def __enter__(self):
        return self.open()

    def __exit__(self, *exc):
        self.close()
        return False


def span(name: str):
    """A context manager that records the stage ``name`` while a profiler
    capture runs, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name)


def begin(name: str, t_ns: int | None = None) -> _Span | None:
    """Open the span ``name`` at ``t_ns`` (``time.perf_counter_ns``, now by
    default) while a profiler capture runs, else return None: ``span`` for
    a caller that keeps its own clock readings."""
    if not _profiler._is_profiler_enabled:
        return None
    return _Span(name).open(t_ns)


def end(s: _Span | None, t_ns: int | None = None) -> None:
    """Close a span ``begin`` opened, at ``t_ns`` (now by default)."""
    if s is not None:
        s.close(t_ns)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost span open on this
    thread (and to the total), while a profiler capture runs."""
    if not _profiler._is_profiler_enabled:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n
    with _lock:
        _totals[name] = _totals.get(name, 0) + n


def snapshot() -> dict:
    """``{"spans": [...], "counts": {name: total}}``: one dict a span
    (``name``, ``id``, ``parent``, ``request``, ``thread``, ``start_ns``,
    ``end_ns`` (None while open), ``counts``, ``events``: the pair of CUDA
    events or None), in the order they opened."""
    with _lock:
        records, totals = list(_records), dict(_totals)
    return {"spans": [{"name": r.name, "id": r.id, "parent": r.parent, "request": r.request,
                       "thread": r.thread, "start_ns": r.start_ns, "end_ns": r.end_ns,
                       "counts": dict(r.counts), "events": r.events} for r in records],
            "counts": totals}


def device_ms(s: dict) -> float | None:
    """The milliseconds the span's stream spent between its two events
    (waiting for the host included), or None for a span without events or
    still open. Waits for the end event; read it after the capture and
    before ``clear``."""
    if s["events"] is None or s["end_ns"] is None:
        return None
    e0, e1 = s["events"]
    e1.synchronize()
    return e0.elapsed_time(e1)


def clear() -> None:
    """Drop every recorded span and count; their events go back to the pool."""
    with _lock:
        for r in _records:
            if r.events is not None and r.end_ns is not None:
                _free_events.extend(r.events)
        _records.clear()
        _totals.clear()


def merge_into_chrome_trace(path: str, t_mark_ns: int, marker: str | None) -> None:
    """Add the recorded spans to the chrome trace at ``path`` as a process
    row of their own, each with its ids, counts and device milliseconds.
    The trace's clock is found from one event that happened at ``t_mark_ns``
    on the host clock: the first one named ``marker``, or with ``marker``
    None the trace's first event."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    timed = [e for e in events if e.get("ph") == "X" and "ts" in e
             and (marker is None or e.get("name") == marker)]
    recorded = [s for s in snapshot()["spans"] if s["end_ns"] is not None]
    if not timed or not recorded:
        return
    offset_us = min(float(e["ts"]) for e in timed) - t_mark_ns / 1e3
    pid = 1 + max((e["pid"] for e in events if isinstance(e.get("pid"), int)), default=0)
    events.append({"ph": "M", "name": "process_name", "pid": pid,
                   "args": {"name": "cald_tpu_torch spans"}})
    for s in recorded:
        args = {"id": s["id"], "parent": s["parent"], "request": s["request"], **s["counts"]}
        ms = device_ms(s)
        if ms is not None:
            args["device_ms"] = ms
        events.append({"ph": "X", "cat": "span", "name": s["name"], "pid": pid,
                       "tid": s["thread"], "ts": s["start_ns"] / 1e3 + offset_us,
                       "dur": (s["end_ns"] - s["start_ns"]) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(trace, f)
