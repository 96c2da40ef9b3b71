"""The month-long two-step workflow (BASELINE config 3) through the port:
the JAX package's `scripts/month_workflow.py` (`main`, :155) on
`tools/month_world.py`'s world.

  1. train the synthetic PhaseNet picker on the card (`train_phasenet`,
     256 windows, 6 epochs, batches of 32, lr 1e-3, sigma 10);
  2. BP campaign: `scan_days(stage="bp")` over the days with the trained
     picker's P/S probabilities as features (the whole day on the card),
     at `high` (or at `--precision` unless that is `screen`);
  3. the template bank from day 0's detections (`build_templates`, dedup
     at CC 0.9, the windows read from memory);
  4. MF campaign: `scan_days(stage="mf")` over the same days at
     `--precision` (default `screen`);
  5. `assemble_catalog` over every day's detections.

Both campaigns keep their state files in `--workdir` and resume from
them; the world's days are drawn there once, as `.npy` files, and
loaded after (the script's HDF5 days), so the MF campaign pays a load.  No `db_path` (its HDF5 files need h5py, which the port's main
path does without): a resumed BP campaign does not return the days it
skips, so when day 0 was done by an earlier run its detections are made
again with `backproject_day` (the script reads them back from its HDF5
files).  The MF threshold's
zero-fill is drawn from an explicit generator (`MF_SEED`).

    python -m seismic_bpmf_tpu_torch.tools.month_workflow --days 30
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from .. import workflow
from ..models import train_phasenet
from ..utils.observe import GLOBAL_TIMER
from .month_world import MonthWorld, build_world, training_windows

# the script's stage arguments
BP_KW = dict(minimum_interevent_time=20.0, threshold_window_sec=3600.0)
MF_KW = dict(minimum_interevent_time=5.0, threshold_window_dur=1800.0,
             min_channels=3, min_stations=2, max_kurto=1e6)
TRAIN_KW = dict(n_epochs=6, batch_size=32, learning_rate=1e-3, sigma=10.0)
MF_SEED = 0


def dates_of(n_days: int) -> list:
    return [f"day{d:02d}" for d in range(n_days)]


def bp_precision(precision: str) -> str:
    """'screen' is an MF rung (bf16 scan + exact refine): BP scans at
    'high' then, as the script does."""
    return "high" if precision == "screen" else precision


def train_picker(world: MonthWorld, device=None, n_train: int = 256):
    """The script's picker: `PhaseNet` from the seed-0 init trained on
    `training_windows` -> (model on `device` in eval mode, losses)."""
    x, picks = training_windows(world.wavelet, n_train)
    model, _, losses = train_phasenet(x, picks, seed=0, verbose=False,
                                      device=device, **TRAIN_KW)
    return model, losses


def bp_campaign(world: MonthWorld, dates, feature_fn, state_file=None,
                precision: str = "screen", device=None) -> dict:
    """{date: [Events]} of the days the state file does not hold yet."""
    return workflow.scan_days(
        dates, world.make_data, cfg=world.cfg, stage="bp",
        network=world.network, travel_times=world.travel_times,
        state_file=state_file, feature_fn=feature_fn,
        num_closest_stations=len(world.network.stations),
        precision=bp_precision(precision), device=device, **BP_KW)


def bp_day(world: MonthWorld, date, feature_fn, precision: str = "screen",
           device=None) -> list:
    """One BP day outside the campaign (day 0 of a resumed run)."""
    _, dets = workflow.backproject_day(
        world.make_data(date), world.network, world.travel_times,
        cfg=world.cfg, feature_fn=feature_fn,
        num_closest_stations=len(world.network.stations),
        precision=bp_precision(precision), device=device, **BP_KW)
    return dets


def template_bank(world: MonthWorld, detections, device=None):
    return workflow.build_templates(
        detections, world.network, cfg=world.cfg, data_reader=world.reader,
        dedup_similarity=0.9, device=device)


def mf_campaign(world: MonthWorld, dates, bank, state_file=None,
                precision: str = "screen", device=None) -> dict:
    """{date: {tid: [Events]}} of the days the state file does not hold."""
    return workflow.scan_days(
        dates, world.make_data, bank, cfg=world.cfg, state_file=state_file,
        precision=precision, device=device,
        rng=np.random.default_rng(MF_SEED), **MF_KW)


def catalog_of(mf_results: dict, bank, device=None):
    """(catalog, events, unique events) over every day's detections."""
    all_dets: dict = {}
    for day in mf_results.values():
        for tid, evs in day.items():
            all_dets.setdefault(tid, []).extend(evs)
    cat = workflow.assemble_catalog(all_dets, bank, device=device)
    n_uniq = int(np.sum(cat["unique_event"])) if cat.n_events else 0
    return cat, cat.n_events, n_uniq


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--days", type=int, default=30)
    ap.add_argument("--n-src", type=int, default=10_000)
    ap.add_argument("--day-sec", type=float, default=86400.0)
    ap.add_argument("--precision", default="screen")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    tmp = args.workdir or tempfile.mkdtemp(prefix="month_wf_")
    os.makedirs(tmp, exist_ok=True)
    print(f"# workdir {tmp}", flush=True)
    t_all = time.perf_counter()
    world = build_world(tmp, n_src=args.n_src, day_sec=args.day_sec)
    print(f"# world built in {time.perf_counter() - t_all:.1f} s",
          flush=True)

    t0 = time.perf_counter()
    model, losses = train_picker(world, device=device)
    feature_fn = workflow.phasenet_feature_fn(model)
    print(f"# picker trained in {time.perf_counter() - t0:.1f} s, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)

    def timers():
        return {k: GLOBAL_TIMER.times[k]
                for k in ("month_draw", "month_load", "mf_scan")}

    def world_s(before):
        now = timers()
        return (f"the world's days drawn and written "
                f"{now['month_draw'] - before['month_draw']:.1f} s, loaded "
                f"{now['month_load'] - before['month_load']:.1f} s")

    dates = dates_of(args.days)
    before = timers()
    t0 = time.perf_counter()
    bp_results = bp_campaign(world, dates, feature_fn,
                             os.path.join(tmp, "bp_state.json"),
                             args.precision, device)
    t_bp = time.perf_counter() - t0
    n_bp = sum(len(v) for v in bp_results.values())
    print(f"BP CAMPAIGN: {len(bp_results)} days in {t_bp:.1f} s "
          f"({t_bp / max(len(bp_results), 1):.2f} s/day), {n_bp} "
          f"detections; {world_s(before)} (on the prefetch thread)",
          flush=True)

    t0 = time.perf_counter()
    day0 = bp_results.get(dates[0])
    if day0 is None:
        print(f"# {dates[0]} was done by an earlier run and no HDF5 file "
              "keeps its detections: backproject_day runs it again",
              flush=True)
        day0 = bp_day(world, dates[0], feature_fn, args.precision, device)
    bank = template_bank(world, day0, device)
    print(f"# template bank: {bank.n_templates} templates from "
          f"{len(day0)} day-0 detections ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    before = timers()
    t0 = time.perf_counter()
    mf_results = mf_campaign(world, dates, bank,
                             os.path.join(tmp, "mf_state.json"),
                             args.precision, device)
    t_mf = time.perf_counter() - t0
    n_mf = sum(sum(len(v) for v in day.values())
               for day in mf_results.values())
    n_days = max(len(mf_results), 1)
    print(f"MF CAMPAIGN: {len(mf_results)} days in {t_mf:.1f} s "
          f"({t_mf / n_days:.2f} s/day, mf_scan "
          f"{(timers()['mf_scan'] - before['mf_scan']) / n_days:.3f} "
          f"s/day), {n_mf} detections; {world_s(before)} (on the prefetch "
          "thread)", flush=True)

    t0 = time.perf_counter()
    _, n_events, n_uniq = catalog_of(mf_results, bank, device)
    print(f"CATALOG: {n_events} events, {n_uniq} unique "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"MONTH WORKFLOW TOTAL: {time.perf_counter() - t_all:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
