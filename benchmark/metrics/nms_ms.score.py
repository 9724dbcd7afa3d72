"""Device milliseconds a score batch between the CUDA events of every
``nms`` span (the RPN's and the box head's, or RetinaNet's), the stream's
wait while the host runs each sweep's check included
(``harness/program_trace.py``)."""


def read(run):
    from harness.program_trace import stage_ms

    ms = stage_ms(run, "nms")
    return ms / run.batches if ms is not None else None
