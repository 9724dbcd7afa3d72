"""Mean milliseconds the score loop waited on the scoring loader for a batch
(the benchmark's ``loader_wait`` span around the loader's next batch)."""


def read(run):
    waits = run.loader_wait_s
    return 1e3 * sum(waits) / len(waits) if waits else None
