"""mf_scan_s: seconds a window day in the `mf_scan` stage of
`utils.observe.GLOBAL_TIMER` (`matched_filter_day`: the scan, the
extraction, the refine and the Events)."""

UNIT = "s/day"
STAGES = ("mf_scan",)


def read(run):
    if not run.n_days:
        return None
    return sum(run.stage(s)[0] for s in STAGES) / run.n_days
