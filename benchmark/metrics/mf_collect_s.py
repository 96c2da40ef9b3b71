"""mf_collect_s: seconds a window day in `mf_collect` (each chunk's wait
for the card and the copy of its candidates to the host)."""

from benchmark.spans import stage_per_day

UNIT = "s/day"


def read(run):
    return stage_per_day(run, "mf_collect")
