"""bp_backproject_s: seconds a window day in the `bp_backproject`
stage (`Beamformer.backproject`: the fold, the beam, the fetch)."""

UNIT = "s/day"
STAGES = ("bp_backproject",)


def read(run):
    if not run.n_days:
        return None
    return sum(run.stage(s)[0] for s in STAGES) / run.n_days
