"""NMS fixpoint sweeps a score batch: the program's counter ``nms.sweeps``
(one a sweep that reaches its device-to-host check) over the traced window,
over the window's batches (``harness/program_trace.py``)."""


def read(run):
    from harness.program_trace import program

    prog = program(run)
    if prog is None:
        return None
    return prog.counts.get("nms.sweeps", 0) / run.batches
