"""bp_threshold_s: seconds a window day in `bp_threshold` (the max beam's
detection threshold on the card and its copy back, inside `bp_detect`)."""

from benchmark.spans import stage_per_day

UNIT = "s/day"


def read(run):
    return stage_per_day(run, "bp_threshold")
