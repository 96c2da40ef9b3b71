"""mf_upload_s: seconds a window day in `mf_upload` (`MatchedFilter`: the
day padded, rounded to bf16 for `screen`, and copied to the card; on the
prefetch thread inside `mf_set_data`)."""

from benchmark.spans import stage_per_day

UNIT = "s/day"


def read(run):
    return stage_per_day(run, "mf_upload")
