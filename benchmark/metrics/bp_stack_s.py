"""bp_stack_s: seconds a window day in `bp_stack` (`backproject_day`: the
day's traces stacked into the host array, inside `bp_features`)."""

from benchmark.spans import stage_per_day

UNIT = "s/day"


def read(run):
    return stage_per_day(run, "bp_stack")
