"""mf_gather_gib: GiB a window day of CC rows copied from another card
into the mesh's first card (the program's day meter `mf_gather_bytes`;
rows a shard computed on the first card itself count 0)."""

from benchmark.spans import meter_total

UNIT = "GiB/day"


def read(run):
    total = meter_total(run, "mf_gather_bytes")
    return None if total is None else total / 2.0 ** 30 / run.n_days
