"""mf_select_s: the self seconds a window day of `mf_detect`, less its
collects, rescans, refine and Events: the per-template selection of the
candidates (dedup, search window, edges)."""

from benchmark.spans import SELF_SECONDS, stage_per_day

UNIT = "s/day"


def read(run):
    return stage_per_day(run, "mf_detect", SELF_SECONDS)
