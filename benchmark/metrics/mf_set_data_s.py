"""mf_set_data_s: seconds of one `mf_set_data` stage in the window (the
prefetch thread's normalization and upload of a day, one a day), its
total over its calls."""

UNIT = "s/day"


def read(run):
    sec, calls = run.stage("mf_set_data")
    return sec / calls if calls else None
