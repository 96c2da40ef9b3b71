"""The 1024-template year campaign (BASELINE config 4) through the port:
the JAX package's `scripts/year_scan.py` (`main`, :142) on
`tools/year_world.py`'s world.

Every campaign day scans the same synthetic day (10 stations x 3
components x 2,160,000 samples at 25 Hz, two injected events) with the
whole bank through `workflow.scan_days` at `--precision` (default
`screen`), with the script's arguments: minimum inter-event time 5 s,
threshold window 1,800 s, at least 3 channels on 2 stations, kurtosis up to
1e6.  The day is normalized and uploaded on the prefetch thread; the
state file (`--state`, by default in `--workdir`) lets an interrupted run
resume at the first unfinished day.  No `db_path` (its HDF5 files need
h5py).  `--churn N` drops 1-2 stations and rolls the rest each day (N
patterns) with closest-8-station weights, so each new pattern builds and
uploads the bank's plans again.  The threshold's zero-fill is drawn from
an explicit generator (`MF_SEED`).

It prints s/day, detections/day, CC GSamples/s (templates x channels x
lags a second of a day's wall), the prefetch thread's `set_data` seconds,
the refine and Event seconds, `mf_scan` s/day and the peak device memory,
each beside the card's name and power limit.

    python -m seismic_bpmf_tpu_torch.tools.year_scan --days 30
    python -m seismic_bpmf_tpu_torch.tools.year_scan --days 10 --churn 10
"""

from __future__ import annotations

import argparse
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from .. import workflow
from .._device import resolve_device
from ..utils.observe import GLOBAL_TIMER
from .year_world import YearWorld, build_bank, build_world, churn_wrapper

# the script's stage arguments
MF_KW = dict(minimum_interevent_time=5.0, threshold_window_dur=1800.0,
             min_channels=3, min_stations=2, max_kurto=1e6)
CHURN_KW = dict(weights_method="closest_stations",
                weights_kwargs={"num_closest_stations": 8})
MF_SEED = 0
STAGES = ("mf_set_data", "mf_scan", "mf_refine", "mf_events")


def dates_of(n_days: int) -> list:
    return [f"day{d:03d}" for d in range(n_days)]


def campaign(world: YearWorld, bank, dates, state_file=None,
             precision: str = "screen", churn: int = 0, device=None,
             **kwargs) -> dict:
    """{date: {tid: [Events]}} of the days the state file does not hold
    yet; `kwargs` go to `scan_days` (`white_noise`, `max_memory_gb`,
    `template_chunk`, ...)."""
    day_fn, extra = world.make_data, {}
    if churn > 0:
        day_fn = churn_wrapper(world.make_data, world.network, churn)
        extra = CHURN_KW
    kwargs.setdefault("rng", np.random.default_rng(MF_SEED))
    return workflow.scan_days(
        dates, day_fn, bank, cfg=world.cfg, state_file=state_file,
        precision=precision, device=device, **MF_KW, **extra, **kwargs)


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them (the
    CPU's name off the card)."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(device)
    return out[device.index or 0] if out else torch.cuda.get_device_name(
        device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--days", type=int, default=365)
    ap.add_argument("--templates", type=int, default=1024)
    ap.add_argument("--state", default=None,
                    help="state file (default: <workdir>/year_state.json)")
    ap.add_argument("--precision", default="screen")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--day-sec", type=float, default=86400.0,
                    help="shorten for smoke tests")
    ap.add_argument("--churn", type=int, default=0, metavar="N",
                    help="station-availability churn with N patterns and "
                         "closest-station weights")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else None)
    card = card_line(device)
    workdir = args.workdir or tempfile.mkdtemp(prefix="year_scan_")
    os.makedirs(workdir, exist_ok=True)
    state = args.state or os.path.join(workdir, "year_state.json")
    print(f"# workdir {workdir}", flush=True)
    t0 = time.perf_counter()
    world = build_world(day_sec=args.day_sec)
    world_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bank = build_bank(world, args.templates)
    _ = bank.waveforms_arr, bank.moveouts_arr
    bank_s = time.perf_counter() - t0
    print(f"# world {world_s:.1f} s, {bank.n_templates}-template bank "
          f"{bank_s:.1f} s", flush=True)
    if args.churn > 0:
        print(f"# churn: {args.churn} availability patterns, closest-8 "
              f"station weights", flush=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = {k: GLOBAL_TIMER.times[k] for k in STAGES}
    t0 = time.perf_counter()
    results = campaign(world, bank, dates_of(args.days), state_file=state,
                       precision=args.precision, churn=args.churn,
                       device=device)
    wall = time.perf_counter() - t0
    n_days = len(results)
    per_day = wall / max(n_days, 1)
    n_det = sum(sum(len(v) for v in day.values())
                for day in results.values())
    n_ch = bank.waveforms_arr.shape[1] * bank.waveforms_arr.shape[2]
    L = bank.waveforms_arr.shape[-1]
    n_corr = world.n_samples - L + 1
    gsamples = bank.n_templates * n_ch * n_corr / per_day / 1e9
    st = {k: (GLOBAL_TIMER.times[k] - before[k]) / max(n_days, 1)
          for k in STAGES}
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else float("nan"))
    print(f"YEAR SCAN: {n_days} days in {wall:.1f} s ({per_day:.3f} s/day), "
          f"{n_det} detections ({n_det / max(n_days, 1):.0f}/day) "
          f"[{card}]", flush=True)
    print(f"CC {gsamples:.2f} GSamples/s ({gsamples * L:.0f} GMAC/s) of "
          f"{bank.n_templates} templates x {n_ch} channels x {n_corr:,} lags "
          f"a day [{card}]", flush=True)
    print("stages s/day: " + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
          + f" (mf_set_data on the prefetch thread); peak device memory "
          f"{peak:.2f} GiB [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
