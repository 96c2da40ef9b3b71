"""End-to-end synthetic example of the PyTorch port, on the CUDA card.

The twin of examples/synthetic_day.py for `seismic_bpmf_tpu_torch`: the
same synthetic "day" (seed 42; 20 stations at 25 Hz, 4 hours, 64 grid
sources, four repeating earthquakes from source 20 at 600, 3000, 7200 and
11000 s), then the same five steps:

  backprojection detection (the CUDA beam kernel)
  -> template database
  -> matched-filter densification (the CUDA matched-filter kernels)
  -> catalog assembly with multiples dedup
  -> moment magnitudes

The JAX example writes its day and travel-time table to HDF5; this one
builds them in memory (`data.grid_travel_times`, an in-memory reader) and
writes no database (`db_path=None`), so it runs where h5py is absent.

Run: python examples/synthetic_day_torch.py [--cpu]

--cpu asks for the CPU (the kernels' plain PyTorch versions run there).
"""

import os
import sys

# allow running from a repo checkout without installing the package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import numpy as np

from seismic_bpmf_tpu_torch import workflow
from seismic_bpmf_tpu_torch.config import Config
from seismic_bpmf_tpu_torch.data import (
    Data, Network, Stream, Trace, TravelTimes, grid_travel_times,
)
from seismic_bpmf_tpu_torch.utils.observe import GLOBAL_TIMER

SR = 25.0
DAY = 4.0 * 3600.0  # 4 "hours"
N_STA = 20
N_SRC = 64
EVENT_TIMES = [600.0, 3000.0, 7200.0, 11000.0]
EVENT_SRC = 20
T0_EPOCH = 1343260800.0  # 2012-07-26T00:00:00


def build_world():
    """(cfg, network, Data of the day, travel times in samples, reader):
    the JAX example's world, drawn from the same generator in the same
    order, in memory."""
    rng = np.random.default_rng(42)
    cfg = Config(data_buffer_sec=0.0, sampling_rate_hz=SR,
                 template_len_sec=8.0, n_dev_bp_threshold=12.0,
                 n_dev_mf_threshold=8.0)
    stations = [f"S{i:02d}" for i in range(N_STA)]
    latitude = 40.0 + 0.3 * rng.random(N_STA)
    longitude = 30.0 + 0.3 * rng.random(N_STA)
    net = Network.from_arrays(stations, networks=["XX"] * N_STA,
                              latitude=latitude, longitude=longitude,
                              elevation_m=np.zeros(N_STA))

    # homogeneous-velocity travel times on a small grid
    lon = np.linspace(30.0, 30.3, 8)
    lat = np.linspace(40.0, 40.3, 8)
    lon_g, lat_g = np.meshgrid(lon, lat, indexing="ij")
    src_lon, src_lat = lon_g.reshape(-1), lat_g.reshape(-1)
    src_dep = np.full(src_lon.size, 8.0)
    tt_p, tt_s = grid_travel_times(
        src_lon, src_lat, src_dep,
        net.longitude, net.latitude, net.depth,
    )
    tts = TravelTimes.from_arrays(
        {"P": {s: tt_p[:, i] for i, s in enumerate(net.stations)},
         "S": {s: tt_s[:, i] for i, s in enumerate(net.stations)}},
        {"longitude": src_lon, "latitude": src_lat, "depth": src_dep},
    )
    tts.convert_to_samples(SR)

    # synthetic waveforms with injected events
    n = int(DAY * SR)
    n_w = int(2.0 * SR)
    wavelet = (np.sin(2 * np.pi * 4.0 * np.arange(n_w) / SR)
               * np.hanning(n_w))
    day = np.empty((N_STA, 3, n), np.float32)
    for i in range(N_STA):
        for c, comp in enumerate("NEZ"):
            x = 0.05 * rng.normal(size=n).astype(np.float32)
            for ev_t in EVENT_TIMES:
                tt = (tt_p if comp == "Z" else tt_s)[EVENT_SRC, i]
                k = int((ev_t + tt) * SR)
                x[k : k + n_w] += (2.0 + rng.random()) * wavelet
            day[i, c] = x

    def reader(where, network=None, stations=None, channels=None,
               location=None, starttime=None, endtime=None, **kwargs):
        """In-memory reader of the day: honours the station list, the
        channel pattern and the window."""
        out = Stream()
        for i, name in enumerate(net.stations):
            if stations is not None and name not in stations:
                continue
            for c, comp in enumerate("NEZ"):
                if channels is None or channels.endswith(comp):
                    out += Trace(day[i, c], station=name, network="XX",
                                 channel=f"HH{comp}", sampling_rate=SR,
                                 starttime=T0_EPOCH)
        if starttime is not None or endtime is not None:
            out = out.slice(starttime, endtime)
        return out

    data = Data("2012-07-26", "memory/day", reader, duration=DAY,
                sampling_rate=SR).read_waveforms()
    return cfg, net, data, tts, reader


def main(device=None):
    cfg, net, data, tts, reader = build_world()

    t0 = time.time()
    bf, detections = workflow.backproject_day(
        data, net, tts, cfg=cfg, minimum_interevent_time=20.0,
        threshold_window_sec=1200.0, num_closest_stations=N_STA,
        device=device,
    )
    print(f"[1] backprojection: {len(detections)} detections "
          f"({time.time()-t0:.1f}s)")

    t0 = time.time()
    tg = workflow.build_templates(
        detections, net, cfg=cfg, data_reader=reader,
        dedup_similarity=0.9, db_path=None, device=device,
    )
    print(f"[2] template db: {tg.n_templates} templates "
          f"({time.time()-t0:.1f}s)")

    t0 = time.time()
    dets = workflow.matched_filter_day(
        tg, data, cfg=cfg, minimum_interevent_time=10.0,
        threshold_window_dur=1200.0, min_channels=6, min_stations=3,
        max_kurto=1e6, db_path=None, device=device,
    )
    n_total = sum(len(v) for v in dets.values())
    print(f"[3] matched filter: {n_total} detections ({time.time()-t0:.1f}s)")

    cat = workflow.assemble_catalog(dets, tg, device=device)
    n_unique = int(np.sum(cat["unique_event"])) if cat.n_events else 0
    print(f"[4] catalog: {cat.n_events} rows, {n_unique} unique events")

    events = [ev for evs in dets.values() for ev in evs][:3]
    for ev in events:
        ev.read_waveforms(cfg.template_len_sec, data_reader=reader)
    mws = workflow.compute_magnitudes(events, net, device=device)
    print(f"[5] magnitudes on {len(events)} events: {mws}")

    print("stage report:", GLOBAL_TIMER.report())
    assert n_unique >= len(EVENT_TIMES), "missed injected events!"
    print("OK: all injected events recovered")


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv else None)
