"""Reading a ``torch.profiler`` trace of the traced part of a window.

The profiler records the device's activity only (``ProfilerActivity.CUDA``:
kernels, copies and the CUDA runtime calls), which keeps its cost on the
host small; recording every host-side operator as well slowed a score
batch about fourfold. The benchmark's own spans (``loader_wait``,
``score_fn``, ``select``, ``step``) are kept on the host clock and placed on
the trace's clock by one marker: the ``cudaDeviceSynchronize`` the harness
calls on its own thread as the traced window opens, which also names that
thread.
"""

from __future__ import annotations

import bisect
import dataclasses
import math

# runtime calls that block the host until the device has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpy2D")
MARKER = "cudaDeviceSynchronize"
NAME_CHARS = 160                        # of a kernel's name in the breakdown


@dataclasses.dataclass
class Trace:
    device_ops: list        # (start_s, end_s, name) of every device operation
    spans: list             # (start_s, end_s, name) of the benchmark's spans, trace clock
    syncs: int | None       # synchronising runtime calls on the harness's thread


def read(prof, spans, t_mark: float) -> Trace:
    """``spans`` (start, end, name) and ``t_mark`` on the host clock
    (``time.perf_counter``); ``t_mark`` is taken just before the marker
    synchronise."""
    from torch.autograd import DeviceType

    device_ops, runtime = [], []
    for e in prof.profiler.kineto_results.events():
        t0 = e.start_ns() / 1e9
        t1 = t0 + e.duration_ns() / 1e9
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            device_ops.append((t0, t1, name))
        elif name in SYNC_CALLS:
            runtime.append((t0, name, e.start_thread_id()))
    runtime.sort()
    marker = next((r for r in runtime if r[1] == MARKER), None)
    if marker is None:
        return Trace(sorted(device_ops), [], None)
    offset, main = marker[0] - t_mark, marker[2]
    syncs = sum(1 for t0, _, tid in runtime if tid == main and t0 > marker[0])
    return Trace(sorted(device_ops), sorted((a + offset, b + offset, n) for a, b, n in spans),
                 syncs)


def busy_s(device_ops) -> float:
    """The union of the device operations' intervals."""
    busy, end = 0.0, -math.inf
    for a, b, _ in device_ops:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    stretches by the benchmark span the host was in (``outside`` where in
    none), summed."""
    by_op: dict = {}
    for a, b, name in trace.device_ops:
        by_op[name[:NAME_CHARS]] = by_op.get(name[:NAME_CHARS], 0.0) + (b - a)
    gaps: dict = {}
    spans = trace.spans                 # one thread's spans: in order, not nested
    starts = [s[0] for s in spans]
    if spans:
        end = spans[0][0]
        horizon = spans[-1][1]
        for a, b, _ in trace.device_ops + [(horizon, horizon, "")]:
            if a > end:
                mid = (end + a) / 2
                i = bisect.bisect_right(starts, mid) - 1
                name = spans[i][2] if i >= 0 and spans[i][1] >= mid else "outside"
                gaps[name] = gaps.get(name, 0.0) + (a - end)
            end = max(end, b)

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(by_op), "idle_gaps": ranked(gaps)}
