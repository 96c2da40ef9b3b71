"""The measured window: one `workflow.scan_days` campaign over the day
pool, its first `warm_days` days set-up and the rest the window.

`scan_days` is called once with a long list of dates, so one campaign
engine (and for MF its prefetch thread) serves the warm days and every
day of the window.  `make_data`, which `scan_days` calls on its prefetch
thread when the day before the requested one starts, raises `WindowClosed`
once the window has run `seconds`; `scan_days` then ends after the day in
progress, and the window closes there.  The window's days are the whole
days completed after the last warm day; its length runs from the end of
the last warm day to the end of the last day.

What the days produced is read where `scan_days` gets it, by wrappers
that the run puts in place and takes away after it: `workflow.
matched_filter_day` (the day's detections, and the time the day ends),
`workflow.backproject_day` (the same, and the day's max beam, argmax,
peaks and their sources, which the returned `Beamformer` holds as host
arrays), and `MatchedFilter._scan` (the network CC of each run of
templates, of which the windows that `reference.mf.sample_plan` names are
copied on the device: one stack a run, a few hundred kB a day).  The stages
of `utils.observe.GLOBAL_TIMER` are read before and after the window; in a
traced run each stage also opens a profiler range, `stage:<name>`, so that
the trace says what the host was doing.

The check of an MF cell rests on one product of the program that is not
part of its public return: `MatchedFilter._scan(run, templates, moveouts,
weights)` returning the network CC of the run's templates at every lag,
(templates of the run, lags), as the scan computed it before the
detections were drawn from it.  A change that no longer makes that tensor
has to keep a way to read these windows; where the tap reads nothing, the
check's `cc_gap` reads inf and the run is not correct.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np


MAX_DAYS = 100_000   # dates handed to `scan_days`; the window ends first


class WindowClosed(Exception):
    """Raised by the pool's reader once the window has run its time."""


@dataclass
class Record:
    seed: int
    days: list = field(default_factory=list)   # window days, in order
    t_done: dict = field(default_factory=dict)
    detections: dict = field(default_factory=dict)
    cc: dict = field(default_factory=dict)      # day -> [(t, lag, values)]
    beams: dict = field(default_factory=dict)   # day -> (maxbeam, argmax)
    peaks: dict = field(default_factory=dict)   # day -> (peaks, sources)
    t_start: float = None
    t_end: float = None
    t_first_read: float = None                  # the first day's read
    host_before: tuple = None                   # `harness.host_sample`
    host_after: tuple = None
    stages_before: dict = None
    stages_after: dict = None
    counters_before: dict = None
    counters_after: dict = None
    peak_bytes: int = 0
    prof: object = None

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    def day_seconds(self) -> list:
        """Each window day's wall time, from the end of the day before."""
        t = [self.t_start] + [self.t_done[i] for i in self.days]
        return list(np.diff(t))


def read_counter(path: str) -> int:
    """'module:attr.attr' -> the counter's value."""
    import importlib

    mod, attrs = path.split(":")
    obj = importlib.import_module(mod)
    for a in attrs.split("."):
        obj = getattr(obj, a)
    return int(obj)


def _stage_snapshot(timer) -> dict:
    return {k: (float(timer.times[k]), int(timer.counts[k]))
            for k in list(timer.times)}


@contextlib.contextmanager
def _patched(obj, name, value):
    """`obj.name` is `value` inside the block, as it was after it."""
    had = name in vars(obj)
    old = vars(obj).get(name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        if had:
            setattr(obj, name, old)
        else:
            delattr(obj, name)


def run(world, args: dict, traffic: dict, check: dict, seed: int,
        seconds: float, trace: bool, devices: list, counters=(),
        sample_plan=None) -> Record:
    """Drive the campaign, `scan_days(dates, make_data, **args)` on the
    cell's `devices`, and return what the window measured and produced.
    `counters` are read at the window's ends; `sample_plan(day)` gives the
    MF CC windows copied on `day`."""
    import torch

    from seismic_bpmf_tpu_torch import workflow
    from seismic_bpmf_tpu_torch.detection import MatchedFilter
    from seismic_bpmf_tpu_torch.utils.observe import GLOBAL_TIMER

    from .harness import host_sample

    rec = Record(seed=seed)
    n_warm = int(traffic["warm_days"])
    cards = [d for d in devices if torch.device(d).type == "cuda"]
    width = int(check.get("cc_window_lags", 0))
    plans: dict = {}

    def make_data(date):
        i = int(str(date)[1:])
        if rec.t_first_read is None:
            rec.t_first_read = time.perf_counter()
        if (rec.t_start is not None
                and time.perf_counter() - rec.t_start >= seconds):
            raise WindowClosed(date)
        data = world.pool.make_data(i)
        data.bench_day = i
        return data

    def start_window():
        for d in cards:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        rec.host_before = host_sample()
        rec.counters_before = {c: read_counter(c) for c in counters}
        rec.stages_before = _stage_snapshot(GLOBAL_TIMER)
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cards:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            rec.prof = torch.profiler.profile(activities=acts)
            rec.prof.start()
        rec.t_start = time.perf_counter()

    def day_done(data):
        i = getattr(data, "bench_day", None)
        if i is None:
            return None
        if i == n_warm - 1:
            start_window()
        elif i >= n_warm:
            rec.t_done[i] = time.perf_counter()
            rec.days.append(i)
        return i

    orig_mf_day = workflow.matched_filter_day
    orig_bp_day = workflow.backproject_day
    orig_scan = MatchedFilter._scan
    orig_stage = GLOBAL_TIMER.stage

    def mf_day_tap(template_group, data, *args, **kwargs):
        dets = orig_mf_day(template_group, data, *args, **kwargs)
        i = day_done(data)
        if i is not None and i >= n_warm:
            rec.detections[i] = dets
        return dets

    def bp_day_tap(data, *args, **kwargs):
        bf, dets = orig_bp_day(data, *args, **kwargs)
        i = day_done(data)
        if i is not None and i >= n_warm:
            rec.detections[i] = dets
            rec.beams[i] = (bf.maxbeam, bf.maxbeam_sources)
            rec.peaks[i] = (np.asarray(bf.peak_indexes),
                            np.asarray(bf.source_indexes))
        return bf, dets

    def scan_tap(self, run_, templates, moveouts, weights):
        out = orig_scan(self, run_, templates, moveouts, weights)
        i = getattr(self.data, "bench_day", None)
        if i is None or i < n_warm or sample_plan is None:
            return out
        if i not in plans:
            plans[i] = sample_plan(i)
        pos = {int(t): r for r, t in enumerate(run_)}
        picks = [(t, s) for t, s in plans[i] if t in pos]
        if picks:
            stack = torch.stack([out[pos[t], s:s + width] for t, s in picks])
            rec.cc.setdefault(i, []).append((picks, stack))
        return out

    @contextlib.contextmanager
    def stage_tap(name):
        if rec.prof is None:
            with orig_stage(name) as t:
                yield t
            return
        with torch.profiler.record_function(f"stage:{name}"):
            with orig_stage(name) as t:
                yield t

    dates = [f"d{i:06d}" for i in range(n_warm + MAX_DAYS)]
    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(workflow, "matched_filter_day",
                                     mf_day_tap))
        stack.enter_context(_patched(workflow, "backproject_day", bp_day_tap))
        stack.enter_context(_patched(MatchedFilter, "_scan", scan_tap))
        stack.enter_context(_patched(GLOBAL_TIMER, "stage", stage_tap))
        try:
            workflow.scan_days(dates, make_data, **args)
        except WindowClosed:
            pass
        rec.t_end = time.perf_counter()
        rec.host_after = host_sample()
        for d in cards:
            torch.cuda.synchronize(d)
        if rec.prof is not None:
            rec.prof.stop()
    if rec.t_start is None:
        raise RuntimeError("the campaign ended before its warm days did")
    if cards:
        rec.peak_bytes = max(int(torch.cuda.max_memory_allocated(d))
                             for d in cards)
    rec.stages_after = _stage_snapshot(GLOBAL_TIMER)
    rec.counters_after = {c: read_counter(c) for c in counters}
    # the CC windows to the host, by (template, first lag)
    done = set(rec.days)
    rec.cc = {i: [(t, s, v) for picks, st in runs
                  for (t, s), v in zip(picks, st.double().cpu().numpy())]
              for i, runs in rec.cc.items() if i in done}
    return rec
