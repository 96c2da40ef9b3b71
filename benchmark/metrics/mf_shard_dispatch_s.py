"""mf_shard_dispatch_s: seconds a window day in `mf_shard_scan`
(`parallel.sharded.ShardedMatchedFilterPlan.__call__`, under
`mf_dispatch`: the host queueing every template shard's kernel launch on
its card and the copies of the shards' CC rows into the mesh's first
card)."""

from benchmark.spans import stage_per_day

UNIT = "s/day"


def read(run):
    return stage_per_day(run, "mf_shard_scan")
