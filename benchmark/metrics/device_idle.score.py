"""The share of the traced score window in which no operation ran on the
device: 1 - the union of the device operations' intervals over the
window's length."""


def read(run):
    if not run.trace.device_ops or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
