"""The world of the JAX package's `scripts/year_scan.py` (`build_world`,
:31-74, `build_bank`, :77-107, and `churn_wrapper`, :110-139) without
HDF5: BASELINE config 4, the 1024-template bank scanned over a year.

10 stations x 3 components at 25 Hz, one day of 86,400 s (2,160,000
samples) stamped 2012-07-26, `Config(template_len_sec=8,
n_dev_mf_threshold=8)`; the noise (0.05) from one `default_rng(seed)`,
station by station, N, E, Z, and two 4 Hz Hann wavelets (amplitude 4) at
0.16 and 0.6 of the day, P on Z at `mv_p = 1.0 + 0.35 i` s and S on N and
E at 1.7 x that.  The same draws of the same generator as the script.

The script writes the day to an HDF5 file that every campaign day reads
again; here the day lives in memory and `reader` (the package's reader
protocol) serves it, so `make_data(date)` returns a `Data` of it for any
date (each read trims a copy of the day, as a file read makes one).
`build_bank` makes the script's bank: one time-shifted template per
event, then tid-distinct deep copies up to `n_tp`.  `churn_wrapper` is the
script's availability churn: per date a pattern, 1-2 stations zeroed, the
rest rolled, the availability set.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..config import Config
from ..data import Data, Network, Stream, Template, TemplateGroup, Trace
from ..data.events import Event

T0_EPOCH = 1343260800.0   # 2012-07-26T00:00:00, the day's stamp
DATE = "2012-07-26"


@dataclass
class YearWorld:
    cfg: Config
    network: Network
    event_times: list           # the injected events' origins, s into the day
    mv_p: dict                  # station -> P moveout (s); S is 1.7 x
    n_samples: int              # samples a day
    day: np.ndarray             # (n_sta, 3, n) float32, N, E, Z
    make_data: Callable         # date -> Data (waveforms read)
    reader: Callable            # the reader protocol over `day`


def build_world(n_sta: int = 10, sr: float = 25.0, day_sec: float = 86400.0,
                seed: int = 0) -> YearWorld:
    """The script's world at its defaults (its `--day-sec` cuts the day)."""
    rng = np.random.default_rng(seed)
    cfg = Config(data_buffer_sec=0.0, sampling_rate_hz=sr,
                 template_len_sec=8.0, n_dev_mf_threshold=8.0)
    names = [f"S{i}" for i in range(n_sta)]
    net = Network.from_arrays(names, networks=["XX"] * n_sta,
                              latitude=40.0 + 0.05 * np.arange(n_sta),
                              longitude=30.0 + 0.05 * np.arange(n_sta),
                              elevation_m=np.zeros(n_sta))
    n = int(day_sec * sr)
    n_w = int(1.5 * sr)
    wavelet = (np.sin(2 * np.pi * 4.0 * np.arange(n_w) / sr)
               * np.hanning(n_w))
    event_times = [0.16 * day_sec, 0.6 * day_sec]
    mv_p = {f"S{i}": 1.0 + 0.35 * i for i in range(n_sta)}
    day = np.empty((n_sta, 3, n), np.float32)
    for i, sta in enumerate(names):
        for c, comp in enumerate("NEZ"):
            x = 0.05 * rng.normal(size=n).astype(np.float32)
            for ev_t in event_times:
                tt = mv_p[sta] * (1.0 if comp == "Z" else 1.7)
                k = int((ev_t + tt) * sr)
                x[k:k + n_w] += 4.0 * wavelet
            day[i, c] = x

    def reader(where, network=None, stations=None, channels=None,
               location=None, starttime=None, endtime=None, **kwargs):
        """In-memory reader of the day: honours the station list, the
        channel pattern and the window."""
        out = Stream()
        for i, name in enumerate(names):
            if stations is not None and name not in stations:
                continue
            for c, comp in enumerate("NEZ"):
                if channels is None or channels.endswith(comp):
                    out += Trace(day[i, c], station=name, network="XX",
                                 channel=f"HH{comp}", sampling_rate=sr,
                                 starttime=T0_EPOCH)
        if starttime is not None or endtime is not None:
            out = out.slice(starttime, endtime)
        return out

    def make_data(date) -> Data:
        return Data(DATE, "memory/day", reader, duration=day_sec,
                    sampling_rate=sr).read_waveforms()

    return YearWorld(cfg=cfg, network=net, event_times=event_times,
                     mv_p=mv_p, n_samples=n, day=day, make_data=make_data,
                     reader=reader)


def build_bank(world: YearWorld, n_tp: int = 1024) -> TemplateGroup:
    """The script's bank: one template per injected event, read
    time-shifted (P 1 s, S 2 s before the arrival), then tid-distinct deep
    copies up to `n_tp` (tid i copies event i % 2's template)."""
    sr = world.cfg.sampling_rate_hz
    stations = list(world.network.stations)
    base = []
    for ev_t in world.event_times:
        mv = np.array([[world.mv_p[s], world.mv_p[s] * 1.7]
                       for s in stations], np.float32)
        ev = Event(np.datetime64(int((T0_EPOCH + ev_t) * 1e9), "ns"), mv,
                   stations, ["P", "S"], data_filename="day",
                   data_path="memory", sampling_rate=sr,
                   data_reader=world.reader)
        ev.read_waveforms(world.cfg.template_len_sec,
                          offset_phase={"P": 1.0, "S": 2.0},
                          time_shifted=True)
        base.append(Template.init_from_event(ev))
    templates = []
    for tid in range(n_tp):
        tp = copy.deepcopy(base[tid % len(base)])
        tp.set_aux_data({"tid": tid})
        tp.id = str(tid)
        templates.append(tp)
    return TemplateGroup(templates, world.network)


def churn_pattern(date, n_stations: int, n_patterns: int):
    """(dropped station indexes, roll shift) of the script's churn for
    `date`: the pattern is the date's digits modulo `n_patterns`, drawn
    from `default_rng(10_000 + pattern)`."""
    d = int("".join(ch for ch in str(date) if ch.isdigit()) or 0)
    pat = d % max(n_patterns, 1)
    rng = np.random.default_rng(10_000 + pat)
    drop = rng.choice(n_stations, size=1 + pat % 2, replace=False)
    shift = int(rng.integers(0, 20_000))
    return drop, shift


def churn_wrapper(make_data: Callable, network: Network,
                  n_patterns: int) -> Callable:
    """The script's availability churn around `make_data`: each date drops
    1-2 stations (zeroed) and rolls the others' waveforms by the pattern's
    shift, then sets the day's availability.  With closest-station weights
    every new pattern changes the channel weights, so the plans are built
    and uploaded again."""
    stations = list(network.stations)

    def make(date) -> Data:
        drop, shift = churn_pattern(date, len(stations), n_patterns)
        data = make_data(date)
        dropped = {stations[i] for i in drop}
        for tr in data.traces:
            if tr.stats.station in dropped:
                tr.data = np.zeros_like(tr.data)
            elif shift:
                tr.data = np.roll(tr.data, shift)
        data.set_availability(stations)
        return data

    return make
