"""mf_dispatch_s: seconds a window day in `mf_dispatch`
(`run_matched_filter_search`'s loop that queues every chunk's scan and
batched extraction on the card)."""

from benchmark.spans import stage_per_day

UNIT = "s/day"


def read(run):
    return stage_per_day(run, "mf_dispatch")
