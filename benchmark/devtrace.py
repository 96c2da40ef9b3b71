"""What the profiler's trace of the window says: the device's busy time
(the union of each card's kernel, copy and set intervals, averaged over
the cell's cards), each kernel's rows, the
device operations that took most time, and the longest gaps in which the
device was idle, each named by the program's stages (`stage:<name>`
ranges) that the host was in at its middle."""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    busy_s: float
    span_s: float
    names: dict = field(default_factory=dict)   # name -> [count, seconds]
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def rows(self, pattern: str) -> tuple:
        """(count, seconds) of the device rows whose name matches."""
        rx = re.compile(pattern)
        n = s = 0
        for name, (c, sec) in self.names.items():
            if rx.search(name):
                n += c
                s += sec
        return n, s


def short(name: str) -> str:
    """A kernel's name without its argument list."""
    return name.split("(", 1)[0].strip() or name


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _label(t: float, ranges: dict, main_tid) -> str:
    """The innermost stage of each thread at time `t`, the main thread's
    first."""
    parts = []
    for tid, rs in sorted(ranges.items(), key=lambda kv: kv[0] != main_tid):
        inside = [r for r in rs if r[0] <= t <= r[1]]
        if inside:
            name = max(inside, key=lambda r: r[0])[2]
            parts.append(name if tid == main_tid else f"{name} (thread)")
    return " | ".join(parts) or "outside stages"


def summarize(events: list, main_tid=None, top: int = 10,
              n_devices: int = 1) -> Trace:
    """`events`: a Chrome trace's `traceEvents` (times in us) of a run on
    `n_devices` cards."""
    dev, ranges, lo, hi = [], {}, None, None
    per_card: dict = {}
    names: dict = {}
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        lo = ts if lo is None else min(lo, ts)
        hi = ts + dur if hi is None else max(hi, ts + dur)
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            card = (e.get("args") or {}).get("device", 0)
            per_card.setdefault(card, []).append((ts, ts + dur))
            row = names.setdefault(e["name"], [0, 0.0])
            row[0] += 1
            row[1] += dur * 1e-6
        elif cat == "user_annotation" and e["name"].startswith("stage:"):
            ranges.setdefault(e.get("tid"), []).append(
                (ts, ts + dur, e["name"][len("stage:"):]))
    merged = _union(dev)
    busy = sum(b - a for iv in per_card.values()
               for a, b in _union(iv)) * 1e-6 / max(1, n_devices)
    gaps = []
    if lo is not None:
        edges = [lo] + [x for ab in merged for x in ab] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((b - a, a))
    gaps.sort(reverse=True)
    by_op: dict = {}
    for name, (_, sec) in names.items():
        by_op[short(name)] = by_op.get(short(name), 0.0) + sec
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = [[_label(a + g / 2, ranges, main_tid), g * 1e-6]
            for g, a in gaps[:top]]
    span = (hi - lo) * 1e-6 if lo is not None else 0.0
    return Trace(busy_s=busy, span_s=span, names=names,
                 device_ops=[[k, v] for k, v in ops], idle_gaps=idle)


def from_profiler(prof, n_devices: int = 1) -> Trace:
    """Export the profiler's trace of a run on `n_devices` cards under the
    temporary directory, read it and delete it."""
    fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return summarize(events, main_tid=threading.main_thread().native_id,
                     n_devices=n_devices)
