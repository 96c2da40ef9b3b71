"""The dense-array configuration of the JAX package's
`scripts/dense_array.py` (`build_world`, :38-118): 128 surface stations x 3
components at 25 Hz over a 1M-node lattice (200 x 200 x 25 nodes over
100 x 100 x 28 km, `tools/lattice.py`), straight-ray P/S at 6.0/3.4 km/s,
Gaussian noise and two Hann-windowed 4 Hz wavelets from the node nearest
(52, 48, 10) km, at 0.25 and 0.7 of the scan.

The same draws of the same generator as the script: the lattice's two
station draws, then the noise, station by station, N, E, Z.  No pandas and
no HDF5 file: the scan is held in memory and read through
`memory_reader`.  `chip_smoke.py` drives the port's dense path on it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import Config
from ..data import Data, Network, Stream, Trace, TravelTimes
from .lattice import VP_KM_S, VS_KM_S, lattice

T0_EPOCH = 1343260800.0   # 2012-07-26T00:00:00, the script's day
DATE = "2012-07-26"
KM_PER_DEG = 111.0        # the script's map: 30 E, 40 N + km / 111


@dataclass
class DenseWorld:
    cfg: Config
    network: Network
    travel_times: TravelTimes   # in samples (convert_to_samples done)
    data: Data
    event_src: int              # the injected events' lattice node
    event_times: list           # their origin times, s after T0_EPOCH
    src_km: np.ndarray          # (n_src, 3) x, y, depth
    spacing_km: np.ndarray      # the lattice's (x, y, z) spacings
    day: np.ndarray             # (n_sta, 3, n) f32, components N, E, Z


def _distances(src: np.ndarray, sta: np.ndarray,
               chunk: int = 65536) -> np.ndarray:
    """(n_src, n_sta) f32 km: `norm(src[:, None] - sta[None], axis=2)`
    by chunks of sources (the same values, a fraction of the memory)."""
    d = np.empty((len(src), len(sta)), np.float32)
    for a in range(0, len(src), chunk):
        d[a: a + chunk] = np.linalg.norm(
            src[a: a + chunk, None] - sta[None], axis=2)
    return d


def build_world(n_sta: int = 128, n_src: int = 1_000_000,
                scan_sec: float = 21_600.0, sr: float = 25.0,
                seed: int = 3) -> DenseWorld:
    """The script's world at its defaults (its `--n-sta`, `--n-src`,
    `--scan-sec`, `--sr`)."""
    rng = np.random.default_rng(seed)
    cfg = Config(data_buffer_sec=0.0, sampling_rate_hz=sr,
                 template_len_sec=8.0, n_dev_bp_threshold=12.0)
    src, sta_xy, spacing = lattice(n_src, n_sta, rng=rng)
    names = [f"S{i:03d}" for i in range(n_sta)]
    net = Network.from_arrays(
        names, networks=["XX"] * n_sta,
        latitude=40.0 + sta_xy[:, 1] / KM_PER_DEG,
        longitude=30.0 + sta_xy[:, 0] / KM_PER_DEG,
        elevation_m=np.zeros(n_sta))

    d = _distances(src, sta_xy)
    tts = TravelTimes.from_arrays(
        {"P": {names[i]: d[:, i] / VP_KM_S for i in range(n_sta)},
         "S": {names[i]: d[:, i] / VS_KM_S for i in range(n_sta)}},
        {"longitude": 30.0 + src[:, 0] / KM_PER_DEG,
         "latitude": 40.0 + src[:, 1] / KM_PER_DEG,
         "depth": src[:, 2]},
    ).convert_to_samples(sr)

    # noise and two events from a known interior node
    event_src = int(np.argmin(
        np.linalg.norm(src - np.array([52.0, 48.0, 10.0]), axis=1)
    ))
    n = int(scan_sec * sr)
    n_w = int(1.5 * sr)
    wavelet = (np.sin(2 * np.pi * 4.0 * np.arange(n_w) / sr)
               * np.hanning(n_w)).astype(np.float32)
    event_times = [0.25 * scan_sec, 0.7 * scan_sec]
    day = np.empty((n_sta, 3, n), np.float32)
    for i in range(n_sta):
        for c, comp in enumerate("NEZ"):
            x = day[i, c]
            x[:] = rng.normal(size=n).astype(np.float32)
            x *= 0.05
            v = VP_KM_S if comp == "Z" else VS_KM_S
            tt = d[event_src, i] / v
            for ev_t in event_times:
                k = int((ev_t + tt) * sr)
                if k + n_w <= n:
                    x[k:k + n_w] += 2.0 * wavelet

    def memory_reader(where, network=None, stations=None, channels=None,
                      location=None, starttime=None, endtime=None,
                      **kwargs):
        """In-memory reader of the scan (the package's reader protocol):
        honours the station list, the channel pattern and the window."""
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

    data = Data(DATE, "memory/dense", memory_reader, duration=scan_sec,
                sampling_rate=sr).read_waveforms()
    return DenseWorld(cfg=cfg, network=net, travel_times=tts, data=data,
                      event_src=event_src, event_times=event_times,
                      src_km=src, spacing_km=spacing, day=day)
