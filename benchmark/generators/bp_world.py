"""The BP lattice's world: the JAX package's `bench.py` BP configuration
(`bench.py:378-430`) through `seismic_bpmf_tpu_torch/tools/bp_world.py`
and `tools/lattice.py` (frozen here from commit 8978ca3).

Kept from the tool: `n_sources` lattice sources x `n_stations` stations
(`lattice.lattice`, its seed 1: the grid and the network are the
configuration's, not the run's), straight-ray P and S travel times, 25 Hz
days of `day_sec` s of N(0, 1) noise on N, E, Z, and a Hann burst of peak
10 over 13 samples at each station's P (Z) and S (N, E) arrival of each
event, its travel time in samples as `TravelTimes.convert_to_samples`
rounds it.

Changed: the tool fixes three sources and origins for each of two days;
here a pool of `pool_days` days is drawn, each with `events_per_day`
events at sources and origins drawn from the seed (one in each equal part
of the day).  Large arrays are drawn on `device` by a `torch.Generator`
seeded with the run's seed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from seismic_bpmf_tpu_torch.config import Config
from seismic_bpmf_tpu_torch.data import Network, TravelTimes

from .lattice import KM_PER_DEG, lattice, travel_times
from .pool import DayPool, device_normal, to_host

T0_EPOCH = 1343260800.0   # 2012-07-26T00:00:00
DATE = "2012-07-26"
BURST = (10.0 * np.hanning(13)).astype(np.float32)   # centred on arrival


@dataclass
class BPWorld:
    sizes: dict
    cfg: Config
    network: Network
    travel: TravelTimes
    src_km: np.ndarray        # (n_src, 3) x, y, depth
    spacing: np.ndarray       # the lattice's spacings, km
    tt: np.ndarray            # (n_src, n_sta, 2) float32 seconds, P and S
    events: list              # per pool day, [(origin sample, source)]
    pool: DayPool
    scan_args: dict = field(default_factory=dict)
    problem: dict = field(default_factory=dict)


def build(sizes: dict, traffic: dict, seed: int, device) -> BPWorld:
    """The world of `sizes` and `traffic` (`pool_days`, `events_per_day`),
    drawn from `seed`."""
    import torch

    from ..reference.bp import (closest_station_weights, moveouts_of,
                                tt_to_samples)

    n_src, n_sta = sizes["n_sources"], sizes["n_stations"]
    sr = float(sizes["sampling_rate_hz"])
    day_sec = float(sizes["day_sec"])
    n = int(round(day_sec * sr))
    src_km, sta_km, spacing = lattice(n_src, n_sta)
    tt = travel_times(src_km, sta_km).astype(np.float32)
    names = [f"B{s:02d}" for s in range(n_sta)]
    travel = TravelTimes.from_arrays(
        {ph: {name: tt[:, s, p] for s, name in enumerate(names)}
         for p, ph in enumerate(("P", "S"))},
        {"longitude": src_km[:, 0] / KM_PER_DEG,
         "latitude": src_km[:, 1] / KM_PER_DEG,
         "depth": src_km[:, 2]})
    travel.convert_to_samples(sr)
    network = Network.from_arrays(names, longitude=sta_km[:, 0] / KM_PER_DEG,
                                  latitude=sta_km[:, 1] / KM_PER_DEG)

    rng = np.random.default_rng([seed, 22])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    samp = tt_to_samples(tt, sr)                    # (n_src, n_sta, 2)
    k = int(traffic["events_per_day"])
    lo = int(sizes["edge_sec"] * sr)
    seg = (n - int(samp.max()) - 2 * lo) // k
    half = len(BURST) // 2
    burst = torch.from_numpy(BURST).to(device)
    days, events = [], []
    for _ in range(int(traffic["pool_days"])):
        srcs = rng.integers(0, n_src, size=k)
        origins = lo + seg * np.arange(k) + rng.integers(0, seg // 2, size=k)
        events.append(list(zip(origins.tolist(), srcs.tolist())))
        day = device_normal(gen, (n_sta * 3, n), device)
        for o, src in zip(origins, srcs):
            for c, p in ((2, 0), (0, 1), (1, 1)):
                a = o + samp[src, :, p]                # (n_sta,)
                rows = np.arange(n_sta) * 3 + c
                idx = torch.from_numpy(
                    (rows * n + a - half)[:, None]
                    + np.arange(len(BURST))[None, :]).to(device)
                day.view(-1).index_add_(0, idx.reshape(-1),
                                        burst.repeat(n_sta))
        days.append(to_host(day).reshape(n_sta, 3, n))
        del day

    pool = DayPool(days, names, sr, DATE, T0_EPOCH, day_sec)
    cfg = Config(sampling_rate_hz=sr)
    scan_args = dict(cfg=cfg, stage="bp", network=network,
                     travel_times=travel, device=device,
                     **sizes["scan_kwargs"])
    mv = moveouts_of(tt, sr)
    kw = dict(sizes["scan_kwargs"], **traffic.get("engine", {}))
    w_src = closest_station_weights(mv, kw["num_closest_stations"])
    problem = dict(kind="bp", n_sources=n_src, n_stations=n_sta,
                   n_components=3, n_phases=2, n_samples=n,
                   n_pairs=int((w_src != 0).sum()) * 2)
    return BPWorld(sizes=sizes, cfg=cfg, network=network, travel=travel,
                   src_km=src_km, spacing=spacing, tt=tt, events=events,
                   pool=pool, scan_args=scan_args, problem=problem)
