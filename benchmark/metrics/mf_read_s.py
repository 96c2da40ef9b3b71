"""mf_read_s: seconds a window day in the caller's `make_data` on the
prefetch thread (`day_read` in `workflow.scan_days`), filed under the day
it reads."""

from benchmark.spans import stage_per_day

UNIT = "s/day"


def read(run):
    return stage_per_day(run, "day_read")
