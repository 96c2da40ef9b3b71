"""bp_weights_s: seconds a window day in `bp_weights` (`backproject_day`:
the phase weights and the closest-station source weights)."""

from benchmark.spans import stage_per_day

UNIT = "s/day"


def read(run):
    return stage_per_day(run, "bp_weights")
