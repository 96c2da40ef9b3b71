"""Command-line interface.

Counterpart of `seismic_bpmf_tpu.cli`: the `workflow` functions as
``python -m seismic_bpmf_tpu_torch [--device DEV] <command>``, with the
JAX package's subcommands, flags and defaults, so a campaign runs
headless on a CUDA card:

  info            device/backend/library report
  backproject     one-day beamforming scan (native HDF5 continuous data)
  matched-filter  one-day template-matching scan
  scan            multi-day matched-filter campaign with JSON checkpoint/resume
  catalog         merge per-template detection files into a deduped catalog
  bench           run the port's benchmark (bench_torch.py) with its flags

Every command runs on the card unless ``--device cpu`` is given; without
a card it exits non-zero and never falls back to the CPU.

Each data subcommand is a loader and a runner.  The loaders (`_load_cfg`,
`_load_network`, `_make_data`, `_load_travel_times`, `_load_templates`,
`_load_detections`, `_load_picker`) turn files into objects; the runners
(`run_<command>(args, <objects>)`) make the workflow call and write the
output files; `cmd_<command>` is the loader, then the runner.  A caller
holding its data in memory drives the runners directly.

The file formats are the JAX package's (native HDF5 continuous data,
the reference TSV network, the reference/pykonal travel-time HDF5, the
reference Event schema), so artifacts move between both packages.  The
HDF5 readers import h5py inside; the catalog CSV is written without
pandas (`Catalog.write`).
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import sys
from typing import List, Optional

# the --engine values that run the port's one beamformer, kernel #3
# (`csrc/bp.cu`); 'onehot' and 'gather' name XLA formulations it lacks
PORTED_ENGINES = ("auto", "pallas")


def _load_cfg(path: Optional[str]):
    from .config import Config, DEFAULT_CONFIG

    return Config.from_file(path) if path else DEFAULT_CONFIG


def _load_network(path: str):
    from .data import Network

    return Network(os.path.basename(path),
                   network_path=os.path.dirname(path)).read()


def _make_data(path: str, cfg):
    """Build a Data window spanning the whole native-HDF5 file."""
    import h5py
    import numpy as np

    from .data import Data
    from .data.readers import data_reader_hdf5

    with h5py.File(path, "r") as f:
        start = str(f.attrs["starttime"])
        sr = float(f.attrs["sampling_rate"])
        n = max(
            f["waveforms"][sta][cha].shape[0]
            for sta in f["waveforms"]
            for cha in f["waveforms"][sta]
        )
    data = Data(
        date=np.datetime64(start),
        where=path,
        data_reader=data_reader_hdf5,
        duration=n / sr,
        sampling_rate=sr,
    )
    data.read_waveforms()
    return data


def _load_travel_times(path: str, phases, network, cfg):
    from .data import TravelTimes

    tts = TravelTimes(os.path.basename(path),
                      tt_folder_path=os.path.dirname(path))
    tts.read(list(phases), read_coords=True, stations=list(network.stations))
    tts.convert_to_samples(cfg.sampling_rate_hz)
    return tts


def _expand(paths: List[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        hits = sorted(glob.glob(p))
        out.extend(hits if hits else [p])
    return out


def _load_templates(paths: List[str], network):
    from .data import TemplateGroup

    tg = TemplateGroup.read_from_files(_expand(paths), network)
    tg.read_waveforms()
    tg.normalize()
    return tg


def _load_detections(db: str, tg) -> dict:
    """{tid: [Events]} from the per-template detection files under `db`."""
    from .data import Catalog

    detections = {}
    for tp in tg.templates:
        fn = f"detections_tp{tp.tid}.h5"
        if not os.path.isfile(os.path.join(db, fn)):
            continue
        _, events = Catalog.read_from_detection_file(
            fn, db_path=db, return_events=True,
            extra_attributes=("cc", "n_dev", "tid"),
        )
        detections[tp.tid] = events
    return detections


def _load_picker(path: Optional[str], device):
    """The BP feature function of a PhaseNet checkpoint written by
    `models.save_variables` (None: the default envelopes)."""
    if not path:
        return None
    from .models import PhaseNet, load_variables
    from .workflow import phasenet_feature_fn

    model = PhaseNet().to(device)
    load_variables(path, target=model)
    return phasenet_feature_fn(model.eval())


def _device(args):
    from ._device import resolve_device

    return resolve_device(args.device)


# ---------------------------------------------------------------------------
# runners: objects -> the workflow call -> the output files
# ---------------------------------------------------------------------------

def run_backproject(args, cfg, network, data, travel_times,
                    feature_fn=None) -> int:
    """`backproject_day` on the objects, its events to `args.output`;
    2, with a message, for an engine the port does not have."""
    from .workflow import backproject_day

    if args.engine not in PORTED_ENGINES:
        print(f"--engine {args.engine}: the JAX package's XLA formulation "
              f"is not in this package, whose beamformer has one engine, "
              f"the CUDA kernel (--engine auto or pallas)", file=sys.stderr)
        return 2
    _, detections = backproject_day(
        data, network, travel_times, cfg=cfg, feature_fn=feature_fn,
        phases=list(args.phases), precision=args.precision,
        minimum_interevent_time=args.min_interevent_time,
        threshold_window_sec=args.threshold_window,
        output_file=args.output, device=_device(args),
    )
    print(f"{len(detections)} detections"
          + (f" -> {args.output}" if args.output else ""))
    return 0


def run_matched_filter(args, cfg, data, tg) -> int:
    from .workflow import matched_filter_day

    detections = matched_filter_day(
        tg, data, cfg=cfg,
        minimum_interevent_time=args.min_interevent_time,
        threshold_window_dur=args.threshold_window,
        min_channels=args.min_channels, min_stations=args.min_stations,
        max_kurto=args.max_kurto, precision=args.precision,
        db_path=args.db, device=_device(args),
    )
    n = sum(len(v) for v in detections.values())
    print(f"{n} detections across {tg.n_templates} templates"
          + (f" -> {args.db}" if args.db else ""))
    return 0


def run_scan(args, cfg, tg, days, make_data) -> int:
    """`days` are the campaign's keys (the state file's), `make_data(day)`
    gives each day's `Data`."""
    from .workflow import scan_days

    results = scan_days(
        days, make_data, tg, cfg=cfg,
        state_file=args.state, db_path=args.db,
        minimum_interevent_time=args.min_interevent_time,
        threshold_window_dur=args.threshold_window,
        min_channels=args.min_channels, min_stations=args.min_stations,
        max_kurto=args.max_kurto, device=_device(args),
    )
    n = sum(len(v) for day in results.values() for v in day.values())
    print(f"{n} new detections over {len(results)} days"
          + (f" -> {args.db}" if args.db else ""))
    return 0


def run_catalog(args, tg, detections) -> int:
    from .data import Catalog
    from .workflow import assemble_catalog

    catalog = assemble_catalog(
        detections, tg,
        dt_criterion=args.dt_criterion,
        distance_criterion=args.distance_criterion,
        similarity_criterion=args.similarity_criterion,
        device=_device(args),
    )
    if args.unique_only and "unique_event" in catalog.catalog:
        keep = catalog["unique_event"].astype(bool)
        catalog = Catalog.from_columns(
            {k: v[keep] for k, v in catalog.catalog.items()})
    catalog.write(args.output)
    print(f"{catalog.n_events} events -> {args.output}")
    return 0


# ---------------------------------------------------------------------------
# subcommands: the loaders, then the runners
# ---------------------------------------------------------------------------

def cmd_info(args) -> int:
    import torch

    import seismic_bpmf_tpu_torch as pkg
    from .ops import host_ops

    dev = _device(args)
    report = {
        "version": getattr(pkg, "__version__", "dev"),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": dev.type,
        "devices": ([torch.cuda.get_device_name(i)
                     for i in range(torch.cuda.device_count())]
                    if dev.type == "cuda" else [str(dev)]),
        "host_ops_native": host_ops.available(),
    }
    print(json.dumps(report, indent=2))
    return 0


def cmd_backproject(args) -> int:
    cfg = _load_cfg(args.config)
    network = _load_network(args.network)
    data = _make_data(args.data, cfg)
    tts = _load_travel_times(args.travel_times, args.phases, network, cfg)
    feature_fn = _load_picker(args.picker_checkpoint, _device(args))
    return run_backproject(args, cfg, network, data, tts, feature_fn)


def cmd_matched_filter(args) -> int:
    cfg = _load_cfg(args.config)
    network = _load_network(args.network)
    data = _make_data(args.data, cfg)
    tg = _load_templates(args.templates, network)
    return run_matched_filter(args, cfg, data, tg)


def cmd_scan(args) -> int:
    cfg = _load_cfg(args.config)
    network = _load_network(args.network)
    tg = _load_templates(args.templates, network)
    return run_scan(args, cfg, tg, _expand(args.data),
                    lambda day_path: _make_data(day_path, cfg))


def cmd_catalog(args) -> int:
    network = _load_network(args.network)
    tg = _load_templates(args.templates, network)
    return run_catalog(args, tg, _load_detections(args.db, tg))


def load_bench(path: str):
    """The benchmark program at `path` (bench_torch.py) as a module."""
    spec = importlib.util.spec_from_file_location("bench_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cmd_bench(args) -> int:
    """bench_torch.py's `main` with the flags after ``bench``; the
    top-level ``--device`` goes first, so a ``--device`` after ``bench``
    wins.  The bench resolves the device itself: without a card it prints
    its JSON line with value 0.0 and returns 1."""
    bench = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench_torch.py")
    if not os.path.isfile(bench):
        print("bench_torch.py not found next to the package",
              file=sys.stderr)
        return 1
    device = [] if args.device is None else ["--device", args.device]
    return load_bench(bench).main([*device, *args.bench_args])


# ---------------------------------------------------------------------------

MF_PRECISION_HELP = (
    "'highest' = f32 products (three TF32 parts, f32 accumulation), CC "
    "within 1e-6 of the float64 oracle; 'high' = bf16-split operands on "
    "the tensor cores, within 5e-6; 'default' = the f32 kernel's default "
    "build (chained accumulation, within 1e-4 relative of its plain "
    "version)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="seismic_bpmf_tpu_torch",
        description="Backprojection & matched-filtering on a CUDA card "
                    "(the PyTorch port).",
    )
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' asks for the CPU)")
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("info", help="device/backend/library report")

    bp = sub.add_parser("backproject", help="one-day beamforming scan")
    bp.add_argument("--config", help="reference-style key=value parameter file")
    bp.add_argument("--data", required=True, help="native HDF5 continuous data")
    bp.add_argument("--network", required=True, help="reference TSV network file")
    bp.add_argument("--travel-times", required=True, help="travel-time HDF5")
    bp.add_argument("--phases", nargs="+", default=["P", "S"])
    bp.add_argument("--engine", default="auto",
                    choices=["auto", "pallas", "onehot", "gather"],
                    help="'auto' and 'pallas' run the CUDA beam kernel; "
                         "'onehot' and 'gather' (XLA formulations of the "
                         "JAX package) exit with code 2")
    bp.add_argument("--precision", default="high",
                    choices=["highest", "high", "default"],
                    help="the JAX package's rung names; every rung runs the "
                         "f32 beam kernel (within 1e-4 relative of its "
                         "plain version)")
    bp.add_argument("--picker-checkpoint",
                    help="PhaseNet checkpoint dir (models.save_variables); "
                         "default: envelopes")
    bp.add_argument("--min-interevent-time", type=float, default=10.0)
    bp.add_argument("--threshold-window", type=float, default=3600.0,
                    help="detection-threshold window (s); clamped to the day")
    bp.add_argument("--output", help="HDF5 file for detected events")

    mf = sub.add_parser("matched-filter", help="one-day template scan")
    mf.add_argument("--config")
    mf.add_argument("--data", required=True)
    mf.add_argument("--network", required=True)
    mf.add_argument("--templates", nargs="+", required=True,
                    help="template HDF5 files (globs ok)")
    mf.add_argument("--min-interevent-time", type=float, default=5.0)
    mf.add_argument("--threshold-window", type=float, default=1800.0,
                    help="CC-threshold window (s); clamped to the day")
    mf.add_argument("--min-channels", type=int, default=6)
    mf.add_argument("--min-stations", type=int, default=3)
    mf.add_argument("--max-kurto", type=float, default=100.0,
                    help="CC-kurtosis sanity threshold (reference default)")
    mf.add_argument("--precision", default="high",
                    choices=["highest", "high", "default"],
                    help=MF_PRECISION_HELP)
    mf.add_argument("--db", help="output directory for per-template detections")

    sc = sub.add_parser("scan", help="multi-day campaign (checkpoint/resume)")
    sc.add_argument("--config")
    sc.add_argument("--data", nargs="+", required=True,
                    help="one native HDF5 file per day (globs ok)")
    sc.add_argument("--network", required=True)
    sc.add_argument("--templates", nargs="+", required=True)
    sc.add_argument("--state", help="JSON state file for resume")
    sc.add_argument("--min-interevent-time", type=float, default=5.0)
    sc.add_argument("--threshold-window", type=float, default=1800.0)
    sc.add_argument("--min-channels", type=int, default=6)
    sc.add_argument("--min-stations", type=int, default=3)
    sc.add_argument("--max-kurto", type=float, default=100.0)
    sc.add_argument("--db", help="output directory for per-template detections")

    ct = sub.add_parser("catalog", help="merge detection DBs into a catalog CSV")
    ct.add_argument("--network", required=True)
    ct.add_argument("--templates", nargs="+", required=True)
    ct.add_argument("--db", required=True, help="detections directory")
    ct.add_argument("--output", default="catalog.csv")
    ct.add_argument("--dt-criterion", type=float, default=3.0)
    ct.add_argument("--distance-criterion", type=float, default=5.0)
    ct.add_argument("--similarity-criterion", type=float, default=0.33)
    ct.add_argument("--unique-only", action="store_true")

    # bench_torch.py parses its own flags (--check, --bp, --phasenet, ...;
    # `main` hands it whatever follows "bench"), -h included
    sub.add_parser("bench", add_help=False,
                   help="run the port's benchmark (bench_torch.py) with "
                        "its flags")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args, rest = parser.parse_known_args(argv)
    args.bench_args = rest
    if args.command != "bench":
        if rest:
            parser.error(f"unrecognized arguments: {' '.join(rest)}")
        try:
            _device(args)
        except RuntimeError as e:
            print(f"seismic_bpmf_tpu_torch: {e}", file=sys.stderr)
            return 1
    return {
        "info": cmd_info,
        "backproject": cmd_backproject,
        "matched-filter": cmd_matched_filter,
        "scan": cmd_scan,
        "catalog": cmd_catalog,
        "bench": cmd_bench,
    }[args.command](args)


if __name__ == "__main__":
    raise SystemExit(main())
