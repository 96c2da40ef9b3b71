"""peak_device_gib: `torch.cuda.max_memory_allocated` over the window,
after `reset_peak_memory_stats` at its start, in GiB."""

UNIT = "GiB"


def read(run):
    return run.peak_bytes / 2.0 ** 30 if run.peak_bytes else None
