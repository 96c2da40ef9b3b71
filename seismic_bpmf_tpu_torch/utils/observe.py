"""Observability: structured stage timing, counters and profiler traces.

Counterpart of `seismic_bpmf_tpu.utils.observe`: the workflow records
its stages (`mf_scan`, `bp_features`, ...) and meters (`cc_samples`,
`beam_points`) in `GLOBAL_TIMER`; `profile_trace` captures a
`torch.profiler` trace around a pipeline section.  `mf_bound_ms` and
`bp_bound_ms` give the least time the card could take for a kernel's
work (the roofline bound `chip_smoke.py` and `bench_torch.py` print
beside each kernel's time).
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


# NVIDIA's H100 SXM data sheet, dense rates at the 700 W power limit
F32_PEAK_FLOPS = 67e12       # f32 outside the tensor cores
TF32_PEAK_FLOPS = 495e12     # TF32 on the tensor cores
BF16_PEAK_FLOPS = 989e12     # bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12


def _bound(t_ops: float, t_bytes: float) -> tuple:
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def mf_bound_ms(plan, data_pad) -> tuple:
    """Least time for one call of an `ops.mf.MatchedFilterPlan` on padded
    day `data_pad`: the multiply-adds of the (template, channel) pairs
    that add something, as three products of split operands each at the
    tensor cores' dense rate (bf16 for a 'high' plan, TF32 for
    'highest'/'default'), against each input read and the output written
    once (the rows' hi and lo parts, L taps each).  Returns (ms, 'operations'
    or 'bytes', the multiply-adds, their ms at the f32 FMA rate)."""
    pairs = int((plan.mv_table[:, : plan.n_tp] >= 0).sum())
    flops = 2.0 * pairs * plan.L * plan.n_corr_unit
    high = plan.precision_name == "high"
    t_ops = 3.0 * flops / (BF16_PEAK_FLOPS if high else TF32_PEAK_FLOPS)
    filt_bytes = (2.0 if high else 4.0) * 2 * plan.n_ch * plan.n_tp * plan.L
    nbytes = filt_bytes + 4.0 * (data_pad.numel() + plan.mv_table.numel()
                                 + plan.tile_lo.numel()
                                 + plan.n_tp * plan.n_corr_unit)
    return (*_bound(t_ops, nbytes / HBM_BYTES_PER_S), flops / 2.0,
            1e3 * flops / F32_PEAK_FLOPS)


def bp_bound_ms(tab, g_pad, samples: Optional[int] = None) -> tuple:
    """Least time for `samples` samples (the day by default) of an
    `ops.bp.BPTables` plan on padded folded features `g_pad`: f32
    multiply-adds of the used (source, station-phase) pairs, against the
    features, the tables and the (max, argmax) output each moved once.
    Returns (ms, 'operations' or 'bytes')."""
    samples = tab.n_samp if samples is None else int(samples)
    flops = 2.0 * tab.n_pairs * samples
    nbytes = (4.0 * g_pad.numel()
              + 4.0 * (tab.prog.numel() + tab.tile_stage.numel()
                       + tab.stage_prog.numel() + tab.stage_row.numel()
                       + tab.lo.numel() + tab.hi.numel()
                       + 3 * tab.ent_sp.numel())
              + 8.0 * samples)
    return _bound(flops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)
