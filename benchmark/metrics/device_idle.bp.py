"""device_idle.bp: the share of the traced window in which no kernel, copy
or set ran on the device (the union of the profiler's device intervals of
each card, averaged over the cell's cards)."""

UNIT = "%"


def read(run):
    t = run.trace
    if t is None or t.span_s <= 0.0 or t.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.span_s)
