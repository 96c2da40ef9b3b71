"""mf_host_loop_s: seconds a window day in the per-template host loop of
`MatchedFilter`: the stages `mf_refine` (the float64 host CC of each
candidate, `screen` only) and `mf_events` (the Events)."""

UNIT = "s/day"
STAGES = ("mf_refine", "mf_events")


def read(run):
    if not run.n_days:
        return None
    return sum(run.stage(s)[0] for s in STAGES) / run.n_days
