"""Milliseconds a score batch that the device idled while the scoring
thread was inside an ``nms`` span: each idle stretch of the trace goes to
the innermost program span open at its midpoint, on the trace's clock
(``harness/program_trace.py``)."""


def read(run):
    from harness.program_trace import idle_by_span

    idle = idle_by_span(run)
    return 1e3 * idle.get("nms", 0.0) / run.batches if idle is not None else None
