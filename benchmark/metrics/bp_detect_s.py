"""bp_detect_s: seconds a window day in the `bp_detect` stage (the
threshold, the peaks, the Events)."""

UNIT = "s/day"
STAGES = ("bp_detect",)


def read(run):
    if not run.n_days:
        return None
    return sum(run.stage(s)[0] for s in STAGES) / run.n_days
