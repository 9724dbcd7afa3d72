"""K1's share of its roofline: the least time of the traced window's K1
calls (bytes of the level pixels their taps read once, the output written
once, the rois, flags and levels; or their operations at the card's
float32 peak, whichever is larger) over K1's device time in the trace."""

KERNEL = "roi_align_fwd_kernel"


def read(run):
    from harness.counting import F32_OPS_S, bound_s, roi_work
    from plainref.ops.roi_align import roi_levels

    k1_s = sum(b - a for a, b, name in run.trace.device_ops if KERNEL in name)
    if not run.k1_calls or k1_s <= 0:
        return None
    least = sum(bound_s(*roi_work(shapes, size, rois, valid, roi_levels(rois, scales), scales),
                        F32_OPS_S)
                for shapes, size, rois, valid, scales in run.k1_calls)
    return 100.0 * least / k1_s
