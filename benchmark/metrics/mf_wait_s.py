"""mf_wait_s: seconds a window day that the campaign's main thread waits
for the prefetched day (`scan_wait` in `workflow.scan_days`): the part of
the day's read and upload that the day before did not hide."""

from benchmark.spans import stage_per_day

UNIT = "s/day"


def read(run):
    return stage_per_day(run, "scan_wait")
