"""Synchronising CUDA runtime calls (stream, device and event synchronises,
blocking copies) on the scoring thread a score batch, from the trace."""


def read(run):
    if run.trace.syncs is None or not run.batches:
        return None
    return run.trace.syncs / run.batches
