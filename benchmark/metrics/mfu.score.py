"""The whole score step's share of the card's dense bf16 peak: the
convolutions and matrix products of every detect of the traced window's
completed batches (``harness.counting.detect_flops``) over the window's
length."""


def read(run):
    from harness.counting import BF16_OPS_S

    if not run.flops or run.window_s <= 0:
        return None
    return 100.0 * run.flops / run.window_s / BF16_OPS_S
