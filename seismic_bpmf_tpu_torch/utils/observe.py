"""Observability: structured stage timing, counters and profiler traces.

Counterpart of `seismic_bpmf_tpu.utils.observe`: the workflow records
its stages (`mf_scan`, `bp_features`, ...) and meters (`cc_samples`,
`beam_points`) in `GLOBAL_TIMER`, each campaign day's share apart
(`StageTimer.day`); `profile_trace` captures a `torch.profiler` trace
around a pipeline section, on which every stage is a `stage:<name>`
range.  `mf_bound_ms` and `bp_bound_ms` give the least time the card
could take for a kernel's work (the roofline bound `chip_smoke.py` and
`bench_torch.py` print beside each kernel's time).
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

logger = logging.getLogger("seismic_bpmf_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    )
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)

_recording = torch.autograd._profiler_enabled
_clock = time.perf_counter


class _ThreadState(threading.local):
    """A thread's open stages (innermost last) and its day."""

    def __init__(self):
        self.stack = []
        self.day = None


class Span:
    """One stage of a `StageTimer`, the value of `with timer.stage(name) as
    span`; after the block `seconds` is its duration and `self_seconds`
    that less its children's (the stages opened inside it on its thread).
    """

    __slots__ = ("timer", "name", "parent", "child_s", "seconds",
                 "self_seconds", "_t0", "_range", "_local")

    def __init__(self, timer: "StageTimer", name: str):
        self.timer = timer
        self.name = name

    def __enter__(self):
        self._local = local = self.timer._local
        stack = local.stack
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.child_s = 0.0
        self._range = None
        if _recording():
            self._range = torch.profiler.record_function(f"stage:{self.name}")
            self._range.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        dt = _clock() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        local = self._local
        local.stack.pop()
        self.seconds = dt
        self.self_seconds = own = dt - self.child_s
        parent = self.parent
        if parent is not None:
            parent.child_s += dt
        timer, name, day = self.timer, self.name, local.day
        lock = timer._lock
        lock.acquire()   # `with lock` takes twice as long on the hot path
        try:
            timer.times[name] += dt
            timer.counts[name] += 1
            timer.parents[name].add(parent and parent.name)
            if day is not None:
                rec = (timer.day_spans.get(day)
                       or timer._day_of(timer.day_spans, day))
                row = rec.get(name)
                if row is None:
                    rec[name] = [dt, own, 1]
                else:
                    row[0] += dt
                    row[1] += own
                    row[2] += 1
        finally:
            lock.release()
        return False


class StageTimer:
    """Wall time and calls of named pipeline stages, and meters.

    `times` and `counts` hold each stage's inclusive seconds and calls over
    the process.  Inside `day(key)` every stage and meter of the calling
    thread is also filed under `key`: `day_spans[key][name]` = [seconds,
    self_seconds, calls], self seconds being those less the stages opened
    inside it on the same thread, and `day_meters[key][meter]` = value,
    for the last `MAX_DAYS` keys; `parents[name]` is the set of stages it
    has run inside (None at the top), whatever the path and the order.
    While a torch profiler records on the thread, each stage is also a
    `stage:<name>` range of its trace."""

    MAX_DAYS = 10_000

    def __init__(self):
        self.times: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.parents: Dict[str, set] = defaultdict(set)
        self.meters: Dict[str, float] = defaultdict(float)
        self.day_spans: Dict[str, Dict[str, list]] = {}
        self.day_meters: Dict[str, Dict[str, float]] = {}
        self._lock = threading.Lock()
        self._local = _ThreadState()

    def stage(self, name: str) -> Span:
        return Span(self, name)

    @contextlib.contextmanager
    def day(self, key, fresh: bool = False):
        """File the calling thread's stages and meters under day `key`;
        `fresh` first drops what was filed under it before."""
        local = self._local
        if fresh:
            with self._lock:
                self.day_spans.pop(str(key), None)
                self.day_meters.pop(str(key), None)
        outer, local.day = local.day, str(key)
        try:
            yield
        finally:
            local.day = outer

    def add(self, meter: str, value: float):
        """Accumulate a throughput meter (e.g. samples scanned, detections)."""
        day = self._local.day
        with self._lock:
            self.meters[meter] += value
            if day is not None:
                rec = self._day_of(self.day_meters, day)
                rec[meter] = rec.get(meter, 0.0) + value

    def _day_of(self, book: dict, day: str) -> dict:
        rec = book.get(day)
        if rec is None:
            rec = book[day] = {}
            if len(book) > self.MAX_DAYS:
                del book[next(iter(book))]
        return rec

    def report(self) -> Dict:
        return {
            "stages": {
                k: {"seconds": round(v, 4), "calls": self.counts[k],
                    "parents": sorted(self.parents.get(k, ()),
                                      key=lambda p: p or "")}
                for k, v in self.times.items()
            },
            "meters": dict(self.meters),
        }


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
    that add something, as the three products of split operands that the
    function needs (fh*dh + fh*dl + fl*dh), each at the tensor cores' dense
    rate (bf16 for a 'high' plan, TF32 for 'highest'/'default'), against
    each input read and the output written once (the rows' hi and lo
    parts, L taps each).  csrc/mf.cu's fourth product, fl*dl, is the
    kernel's own extra work and is not counted.  Returns (ms, 'operations'
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
