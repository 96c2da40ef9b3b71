"""The world of the JAX package's `scripts/month_workflow.py` (`build_world`,
:30-122, and `train_picker`'s windows, :125-152) without HDF5: BASELINE
config 3, the month-long two-step workflow.

10 stations x 3 components at 25 Hz, days of 86,400 s (2,160,000 samples),
10,000 straight-ray sources in a 50 km box (10 depths from 2 to 20 km) at
6.0/3.4 km/s, `Config(template_len_sec=8, n_dev_bp_threshold=10,
n_dev_mf_threshold=8)`; each date's noise (0.05) from
`default_rng(zlib.crc32(date))`, and two 4 Hz Hann wavelets (amplitude 3)
a day, at 0.2 and 0.65 of the day, from source `n_src // 3` (P on Z, S on
N and E).  Every day is stamped 2012-07-26, as the script stamps it.

The same draws of the same generators as the script, without pandas or
HDF5.  Each date is drawn once, on first use, into `<workdir>/<date>.npy`
and loaded from there after, as the script writes each day to an HDF5
file on first use and reads it back: a campaign over days drawn earlier
pays a load, not the draw.  The timer stages
`month_draw` (draw and write) and `month_load` keep both apart from the
system's own stages.  `make_data(date)` returns a `Data` of that day,
and `reader`
(the package's reader protocol, the date taken from the `Data`'s
`where`, "memory/<date>") serves `build_templates` the detections'
windows.  `training_windows` draws the picker's 256 training windows
(`default_rng(5)`).
"""

from __future__ import annotations

import functools
import os
import zlib
from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..config import Config
from ..data import Data, Network, Stream, Trace, TravelTimes
from ..utils.observe import GLOBAL_TIMER

T0_EPOCH = 1343260800.0   # 2012-07-26T00:00:00, every day's stamp
DATE = "2012-07-26"
WINDOW = 3001             # the picker's training window
VP_KM_S, VS_KM_S = 6.0, 3.4
KM_PER_DEG = 111.0


@dataclass
class MonthWorld:
    cfg: Config
    network: Network
    travel_times: TravelTimes   # in samples (convert_to_samples done)
    wavelet: np.ndarray         # (n_w,) float64, the injected wavelet
    event_src: int              # the injected events' source
    event_times: list           # their origin times, s into each day
    n_samples: int              # samples a day
    day: Callable               # date -> (n_sta, 3, n) f32, N, E, Z
    make_data: Callable         # date -> Data (waveforms read)
    reader: Callable            # the reader protocol over `day`


def build_world(workdir: str, n_sta: int = 10, n_src: int = 10_000,
                sr: float = 25.0, day_sec: float = 86400.0,
                seed: int = 0) -> MonthWorld:
    """The script's world at its defaults (its `--n-src` and `--day-sec`),
    each day drawn into `<workdir>/<date>.npy` once and loaded after.  The
    last two days used stay in memory (a campaign's current day and the
    one its prefetch thread makes)."""
    rng = np.random.default_rng(seed)
    cfg = Config(data_buffer_sec=0.0, sampling_rate_hz=sr,
                 template_len_sec=8.0, n_dev_bp_threshold=10.0,
                 n_dev_mf_threshold=8.0)
    names = [f"S{i}" for i in range(n_sta)]
    latitude = 40.0 + 0.05 * rng.random(n_sta)
    longitude = 30.0 + 0.05 * rng.random(n_sta)
    net = Network.from_arrays(names, networks=["XX"] * n_sta,
                              latitude=latitude, longitude=longitude,
                              elevation_m=np.zeros(n_sta))

    # ~n_src straight-ray travel-time lattice in a 50 km box
    nxy = int(np.ceil(np.sqrt(n_src / 10)))
    xs, ys = np.meshgrid(np.linspace(0, 50, nxy),
                         np.linspace(0, 50, nxy), indexing="ij")
    zs = np.linspace(2, 20, 10)
    src = np.stack([
        np.repeat(xs.ravel(), len(zs))[:n_src],
        np.repeat(ys.ravel(), len(zs))[:n_src],
        np.tile(zs, xs.size)[:n_src],
    ], axis=1)
    sta_xy = np.column_stack([
        rng.uniform(0, 50, n_sta), rng.uniform(0, 50, n_sta),
        np.zeros(n_sta),
    ])
    d = np.linalg.norm(src[:, None] - sta_xy[None], axis=2)
    tt_p = {names[i]: (d[:, i] / VP_KM_S).astype(np.float32)
            for i in range(n_sta)}
    tt_s = {names[i]: (d[:, i] / VS_KM_S).astype(np.float32)
            for i in range(n_sta)}
    tts = TravelTimes.from_arrays(
        {"P": tt_p, "S": tt_s},
        {"longitude": 30.0 + src[:, 0] / KM_PER_DEG,
         "latitude": 40.0 + src[:, 1] / KM_PER_DEG,
         "depth": src[:, 2]},
    ).convert_to_samples(sr)

    event_src = n_src // 3
    n = int(day_sec * sr)
    n_w = int(1.5 * sr)
    wavelet = (np.sin(2 * np.pi * 4.0 * np.arange(n_w) / sr)
               * np.hanning(n_w))
    event_times = [0.2 * day_sec, 0.65 * day_sec]

    def draw(date: str) -> np.ndarray:
        # the script's stable per-date seed and its draw order: station
        # by station, N, E, Z
        drng = np.random.default_rng(zlib.crc32(date.encode()))
        out = np.empty((n_sta, 3, n), np.float32)
        for i, sta in enumerate(names):
            for c, comp in enumerate("NEZ"):
                x = 0.05 * drng.normal(size=n).astype(np.float32)
                for ev_t in event_times:
                    tt = (tt_p if comp == "Z" else tt_s)[sta][event_src]
                    k = int((ev_t + tt) * sr)
                    x[k:k + n_w] += 3.0 * wavelet
                out[i, c] = x
        return out

    @functools.lru_cache(maxsize=2)
    def day(date: str) -> np.ndarray:
        path = os.path.join(workdir, f"{date}.npy")
        if os.path.exists(path):
            with GLOBAL_TIMER.stage("month_load"):
                return np.load(path)
        with GLOBAL_TIMER.stage("month_draw"):
            out = draw(date)
            # whole or not at all: a resume never loads a cut file
            with open(path + ".part", "wb") as f:
                np.save(f, out)
            os.replace(path + ".part", path)
        return out

    def reader(where, network=None, stations=None, channels=None,
               location=None, starttime=None, endtime=None, **kwargs):
        """In-memory reader of the day named by `where`: honours the
        station list, the channel pattern and the window."""
        arr = day(os.path.basename(str(where)))
        out = Stream()
        for i, name in enumerate(names):
            if stations is not None and name not in stations:
                continue
            for c, comp in enumerate("NEZ"):
                if channels is None or channels.endswith(comp):
                    out += Trace(arr[i, c], station=name, network="XX",
                                 channel=f"HH{comp}", sampling_rate=sr,
                                 starttime=T0_EPOCH)
        if starttime is not None or endtime is not None:
            out = out.slice(starttime, endtime)
        return out

    def make_data(date: str) -> Data:
        return Data(DATE, f"memory/{date}", reader, duration=day_sec,
                    sampling_rate=sr).read_waveforms()

    return MonthWorld(cfg=cfg, network=net, travel_times=tts,
                      wavelet=wavelet, event_src=event_src,
                      event_times=event_times, n_samples=n, day=day,
                      make_data=make_data, reader=reader)


def training_windows(wavelet: np.ndarray, n_train: int = 256):
    """The script's picker training set (`train_picker`): (x (n, 3,
    WINDOW) float32 in torch's layout, picks (n, 2) float32), noise 0.05,
    the wavelet (x3) at P on Z and at S on N and E, each window
    normalized per component; the same draws of `default_rng(5)`."""
    rng = np.random.default_rng(5)
    window = WINDOW
    n_w = len(wavelet)
    xs, picks = [], []
    for _ in range(n_train):
        x = 0.05 * rng.normal(size=(window, 3)).astype(np.float32)
        p_at = int(rng.integers(200, window // 2))
        s_at = p_at + int(rng.integers(100, 900))
        x[p_at:p_at + n_w, 2] += 3.0 * wavelet
        x[s_at:s_at + n_w, :2] += 3.0 * wavelet[:, None]
        std = x.std(axis=0, keepdims=True)
        x = (x - x.mean(axis=0, keepdims=True)) / np.where(
            std > 0, std, 1.0
        )
        xs.append(x.T)
        picks.append([p_at, s_at])
    return (np.ascontiguousarray(np.stack(xs)),
            np.asarray(picks, np.float32))
