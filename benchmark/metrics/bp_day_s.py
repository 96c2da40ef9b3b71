"""bp_day_s: seconds per BP campaign day, the window's wall time over the
whole days `scan_days` completed in it (features, backprojection and
detection inside)."""

UNIT = "s/day"


def read(run):
    return run.window_s / run.n_days if run.n_days else None
