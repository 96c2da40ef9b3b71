"""Observability: structured stage timing, counters and profiler traces.

Counterpart of `seismic_bpmf_tpu.utils.observe`: the workflow records
its stages (`mf_scan`, `bp_features`, ...) and meters (`cc_samples`,
`beam_points`) in `GLOBAL_TIMER`; `profile_trace` captures a
`torch.profiler` trace around a pipeline section.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Optional

logger = logging.getLogger("seismic_bpmf_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    )
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


class StageTimer:
    """Accumulates wall time + counters per named pipeline stage."""

    def __init__(self):
        self.times: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.meters: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dt = time.perf_counter() - t0
            self.times[name] += dt
            self.counts[name] += 1

    def add(self, meter: str, value: float):
        """Accumulate a throughput meter (e.g. samples scanned, detections)."""
        self.meters[meter] += value

    def report(self) -> Dict:
        out = {
            "stages": {
                k: {"seconds": round(v, 4), "calls": self.counts[k]}
                for k, v in self.times.items()
            },
            "meters": dict(self.meters),
        }
        for k, v in self.meters.items():
            # derive rates when a same-named stage exists
            if k in self.times and self.times[k] > 0:
                out["meters"][f"{k}_per_sec"] = v / self.times[k]
        return out

    def log_report(self):
        logger.info("stage report: %s", json.dumps(self.report()))


GLOBAL_TIMER = StageTimer()


@contextlib.contextmanager
def profile_trace(logdir: Optional[str] = None):
    """Capture a `torch.profiler` trace around a pipeline section: the CPU
    ops and, where CUDA is available, the card's kernels and copies.  On
    exit the trace is written under `logdir` as a Chrome trace
    (``trace_<pid>_<n>.json``, viewable in Perfetto or chrome://tracing).
    Yields the profiler (its `key_averages()` hold the same rows); a no-op
    yielding None when logdir is None.

    A process that has kept the card busy for minutes loses device rows
    from its traces (torch 2.11 on an H100: 5-27 of a section's 54 kernel
    and copy rows after 2-7 minutes, not in every trace); trace a fresh
    process where every device row counts."""
    if logdir is None:
        yield None
        return
    import glob

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    n = len(glob.glob(os.path.join(logdir, f"trace_{os.getpid()}_*.json")))
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))
