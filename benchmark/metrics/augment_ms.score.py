"""Device milliseconds a score batch of ``score.augment`` (the augmented
batch built on the card, ``build_aug_batch``), between its CUDA events
(``harness/program_trace.py``)."""


def read(run):
    from harness.program_trace import stage_ms

    ms = stage_ms(run, "score.augment")
    return ms / run.batches if ms is not None else None
