"""bp_peaks_s: seconds a window day in `bp_peaks` (the host's peaks of
the max beam and their grouping, inside `bp_detect`)."""

from benchmark.spans import stage_per_day

UNIT = "s/day"


def read(run):
    return stage_per_day(run, "bp_peaks")
