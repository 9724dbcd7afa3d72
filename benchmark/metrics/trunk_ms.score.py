"""Device milliseconds a score batch between the CUDA events of every
``detect.trunk`` span (the ResNet-50 + FPN of the base and the augmented
detects), from the program's spans (``harness/program_trace.py``)."""


def read(run):
    from harness.program_trace import stage_ms

    ms = stage_ms(run, "detect.trunk")
    return ms / run.batches if ms is not None else None
