"""The benchmark's harness: finds a cell's parts by name and runs it.

`BENCHMARK.json` names each cell's configuration, traffic mix and metrics;
everything else is found by those names:

  configs/<config>.json    the configuration's sizes, its `generator` and
                           `reference` and what its check samples
  generators/<name>.py     `build(sizes, traffic, seed, device)` -> world
  reference/<name>.py      the plain reference: `compare`, `control`,
                           `sample_plan`, `NAMES`
  traffic/<traffic>.json   the mix: `stage`, `engine` (keywords of
                           `workflow.scan_days` for that stage, such as
                           `precision` or a `mesh` of axis sizes over the
                           cell's cards), the day pool, the warm days
  limits/<cell>.json       the limit of each number `compare` gives
  metrics/<metric>.py      `UNIT` and `read(run)`, None where it finds
                           nothing to read; `KERNELS` {trace row pattern:
                           launch counter} where it reads device rows

A later configuration, mix or metric is a new file and a new entry.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "seismic_bpmf_tpu")


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, moved: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in moved if "moves" in metric else True


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def resolve(root: str, name: str) -> Cell:
    """The cell `name` of `root`'s BENCHMARK.json with its parts read."""
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _json(os.path.join(root, conf["file"]))
    traffic = _json(os.path.join(HERE, "traffic", f"{entry['traffic']}.json"))
    limits = _json(os.path.join(HERE, "limits", f"{name}.json"))
    e2e = [m["name"] for m in bench["end_to_end"] if _applies(m, name, set())]
    per_layer = [m["name"] for m in bench["per_layer"]
                 if _applies(m, name, set(e2e))]
    return Cell(name, entry, config, traffic, limits, e2e, per_layer)


def load_metric(name: str):
    """The metric's reader, metrics/<name>.py, as a module."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is one the run may not
    load, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


# the keywords of `scan_days` that the world sets, whatever the mix says
WORLD_KEYS = ("template_group", "cfg", "stage", "network", "travel_times")


def engine_keywords(stage: str) -> set:
    """The keywords that `workflow.scan_days(stage=stage)` takes: its own
    and those it hands on to the stage's engine and day."""
    import inspect

    from seismic_bpmf_tpu_torch import workflow
    from seismic_bpmf_tpu_torch.detection import MatchedFilter

    def named(fn, *skip):
        return {p.name for p in inspect.signature(fn).parameters.values()
                if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
                and p.name not in skip}

    keys = named(workflow.scan_days, "dates", "make_data")
    if stage == "mf":
        keys |= named(MatchedFilter.__init__, "self")
        keys |= named(workflow.matched_filter_day, "data", "mf")
    else:
        keys |= named(workflow.backproject_day, "data", "output_file", "bf")
    return keys


def scan_args(world, traffic: dict, devices: list) -> dict:
    """The keywords of the cell's `scan_days` call: the world's, with the
    mix's `engine` keywords over them.  A `mesh` given as axis sizes
    ({"tp": 4}) becomes `parallel.make_mesh` over the cell's devices.
    A keyword that `scan_days` does not take for the stage, or one that
    the world sets, raises."""
    engine = dict(traffic.get("engine", {}))
    stage = traffic["stage"]
    clash = sorted(set(engine) & set(WORLD_KEYS))
    if clash:
        raise ValueError(f"the mix may not set {clash}: the world does")
    args = dict(world.scan_args, **engine)
    unknown = sorted(set(args) - engine_keywords(stage))
    if unknown:
        raise ValueError(f"scan_days(stage={stage!r}) takes no {unknown}")
    if isinstance(args.get("mesh"), dict):
        from seismic_bpmf_tpu_torch.parallel.mesh import make_mesh

        args["mesh"] = make_mesh(args["mesh"], devices)
        args.pop("device", None)
    return args


class RunView:
    """What a metric reads: the window's record, the trace, the problem."""

    def __init__(self, rec, problem: dict, trace, setup_s: float):
        self.record = rec
        self.problem = problem
        self.trace = trace
        self.setup_s = setup_s
        self.n_days = len(rec.days)
        self.window_s = rec.window_s
        self.peak_bytes = rec.peak_bytes

    def stage(self, name: str) -> tuple:
        """(seconds, calls) of stage `name` over the window."""
        t1, c1 = self.record.stages_after.get(name, (0.0, 0))
        t0, c0 = self.record.stages_before.get(name, (0.0, 0))
        return t1 - t0, c1 - c0


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "power limit not read"
    return out[0] if out else "power limit not read"


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def coverage(trace, metrics: dict, rec) -> list:
    """The kernels whose trace rows differ in number from their launch
    counters' increase over the window: [(pattern, rows, launches)]."""
    bad = []
    for mod in metrics.values():
        for pat, counter in getattr(mod, "KERNELS", {}).items():
            rows = trace.rows(pat)[0]
            launches = (rec.counters_after[counter]
                        - rec.counters_before[counter])
            if rows != launches:
                bad.append((pat, rows, launches))
    return bad


def judge(per_day: dict, limits: dict) -> tuple:
    """(checks {name: {value, limit}}, failed days, correct) of the
    per-day numbers: a number's value is its widest over the days, and
    the run is correct where some day was judged, no day failed and every
    value is finite and within its limit."""
    checks, failed = {}, 0
    for name, limit in limits.items():
        vals = [d[name] for d in per_day.values()]
        checks[name] = {"value": max(vals) if vals else float("inf"),
                        "limit": limit}
    for d in per_day.values():
        if any(not d[n] <= limits[n] for n in limits):
            failed += 1
    correct = bool(per_day and failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    return checks, failed, correct


def devices_of(device) -> list:
    """A device or a list of them -> a list of `torch.device`."""
    import torch

    if isinstance(device, (list, tuple)):
        return [torch.device(d) for d in device]
    return [torch.device(device)]


def host_sample() -> tuple:
    """(process CPU seconds, the host's stolen seconds, 1-minute load):
    what says whether the host, not the program, set a run's pace."""
    t = os.times()
    steal = float("nan")
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        steal = int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return t.user + t.system, steal, os.getloadavg()[0]


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             device, t0: float, overrides: dict = None) -> dict:
    """Run cell `name` on `device` (one, or a list: the cell's cards) and
    return its result line as a dict.  `t0` is the process's start on
    `time.perf_counter`; `overrides` replaces sizes of the configuration
    (the CPU tests' small worlds)."""
    import numpy as np
    import torch

    from . import devtrace, window

    cell = resolve(root, name)
    sizes = dict(cell.config["sizes"], **(overrides or {}))
    check = dict(cell.config.get("check", {}))
    gen = importlib.import_module(
        f"benchmark.generators.{cell.config['generator']}")
    ref = importlib.import_module(
        f"benchmark.reference.{cell.config['reference']}")
    devs = devices_of(device)
    dev = devs[0]
    t_imports = time.perf_counter()
    world = gen.build(sizes, cell.traffic, seed, dev)
    if world.problem["kind"] != cell.traffic["stage"]:
        raise ValueError(f"traffic {cell.entry['traffic']!r} drives stage "
                         f"{cell.traffic['stage']!r}, the world "
                         f"{world.problem['kind']!r}")
    args = scan_args(world, cell.traffic, devs)
    t_world = time.perf_counter()
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {m: load_metric(m) for m in names}
    counters = sorted({c for mod in metrics.values()
                       for c in getattr(mod, "KERNELS", {}).values()})
    plan = None
    if world.problem["kind"] == "mf":
        def plan(day):
            return ref.sample_plan(world, seed, day, check["cc_templates"],
                                   check["cc_window_lags"])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec = window.run(world, args, cell.traffic, check, seed, seconds, trace, devs,
                     counters=counters, sample_plan=plan)
    del args
    _log(f"# set-up {rec.t_start - t0:.3f} s: imports {t_imports - t0:.3f}, "
         f"world {t_world - t_imports:.3f}, engine "
         f"{rec.t_first_read - t_world:.3f}, warm days "
         f"{rec.t_start - rec.t_first_read:.3f}")
    (c0, s0, l0), (c1, s1, l1) = rec.host_before, rec.host_after
    _log(f"# window host: process CPU {c1 - c0:.3f} s over "
         f"{rec.window_s:.3f} s, host stolen {s1 - s0:.3f} s, load "
         f"{l0:.2f} -> {l1:.2f}, {os.cpu_count()} cores, "
         f"{torch.get_num_threads()} torch threads")
    tr = (devtrace.from_profiler(rec.prof, len(devs))
          if rec.prof is not None else None)
    rec.prof = None
    view = RunView(rec, world.problem, tr, rec.t_start - t0)
    if tr is not None and dev.type == "cuda":
        bad = coverage(tr, metrics, rec)
        if bad:
            raise RuntimeError(
                "the trace lost device rows (pattern, rows, launches): "
                f"{bad}; no share is read from a partial trace")
    values = {}
    for m, mod in metrics.items():
        v = mod.read(view)
        if v is not None:
            values[m] = {"value": float(v), "unit": mod.UNIT}
    days = np.asarray(rec.day_seconds())
    if len(days):
        _log(f"# {len(days)} window days in {rec.window_s:.4f} s; per day "
             f"median {np.median(days):.4f} s, p90 "
             f"{np.quantile(days, 0.9):.4f} s, max {days.max():.4f} s: "
             + " ".join(f"{d:.3f}" for d in days))
    for m in rec.stages_after:
        s, c = view.stage(m)
        if c:
            _log(f"# stage {m}: {s:.4f} s in {c} calls")
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": len(devs), "memory_peak_bytes": int(rec.peak_bytes)}
    out = {"correct": False, "attempted": len(rec.days), "failed": 0,
           "metrics": values, "device": dev_info}
    if tr is not None:
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.span_s
        out["breakdown"] = {"device_ops": tr.device_ops,
                            "idle_gaps": tr.idle_gaps}
        shares = {k: v["value"] for k, v in values.items()
                  if k.startswith("roofline.")}
        if shares:
            _log(f"# rooflines {shares} on {card_line()}")
    # the program's state goes before the reference runs on the device
    del view
    world.scan_args.clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    per_day = ref.compare(world, cell.traffic, rec, dev, check)
    _log(f"# the reference judged {len(per_day)} days in "
         f"{time.perf_counter() - t_ref:.1f} s")
    checks, out["failed"], out["correct"] = judge(per_day, cell.limits)
    out["checks"] = checks
    return out


def check_lines(result: dict) -> list:
    return [f"check {k}: {v['value']!r} limit {v['limit']!r}"
            for k, v in result.get("checks", {}).items()]
