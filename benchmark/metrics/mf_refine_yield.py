"""mf_refine_yield: the Events kept over the candidates handed to the
`screen` refine in the window's days (meters `mf_detections` and
`mf_candidates`), in percent."""

from benchmark.spans import meter_total

UNIT = "%"


def read(run):
    kept = meter_total(run, "mf_detections")
    tried = meter_total(run, "mf_candidates")
    if kept is None or not tried:
        return None
    return 100.0 * kept / tried
