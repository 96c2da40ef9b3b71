"""mf_peer_copy_s: device seconds a window day of the copies from one card
to another (the profiler's `Memcpy PtoP` rows, summed over the cards):
the CC rows gathered into the mesh's first card and the day's time shards
sent to the others."""

UNIT = "s/day"
ROWS = r"^Memcpy PtoP"


def read(run):
    if run.trace is None or not run.n_days:
        return None
    n, seconds = run.trace.rows(ROWS)
    return seconds / run.n_days if n else None
