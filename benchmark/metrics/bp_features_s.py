"""bp_features_s: seconds a window day in the `bp_features` stage
(the host stack, the upload, the envelopes)."""

UNIT = "s/day"
STAGES = ("bp_features",)


def read(run):
    if not run.n_days:
        return None
    return sum(run.stage(s)[0] for s in STAGES) / run.n_days
