"""The backprojection world of `chip_smoke.py` (its phases 7-8), shared
with `tools/mesh_days.py`: the JAX package's `bench.py` BP configuration
(`tools/lattice.py`: 100,000 lattice sources x 32 stations x P and S,
closest-10 source weights) at 25 Hz, and days of 32 stations x 3
components of Gaussian noise (drawn in memory from a seed) with a Hann
burst at each station's P (Z) and S (N, E) arrival of the sources that
`BP_EVENTS` names.
"""

from __future__ import annotations

import numpy as np

from .. import workflow
from ..data import Data, Network, Stream, Trace, TravelTimes
from .lattice import (KM_PER_DEG, closest_weights, lattice,
                      smooth_grid_moveouts, travel_times)
from .mf_world import DATES, SR, day_start

# (origin sample, lattice source) of the injected events of each day
BP_EVENTS = {"d1": [(400_000, 12_345), (1_100_003, 55_555),
                    (1_800_007, 87_001)],
             "d2": [(300_011, 33_333), (1_500_000, 70_707),
                    (2_050_001, 5_000)]}
BURST = (10.0 * np.hanning(13)).astype(np.float32)   # centred on arrival


class BPWorld:
    """`n_src` lattice sources x `n_sta` stations (`src_km`, `sta_km`,
    `spacing`; travel times `tt` in s; moveouts `mv` in samples, source
    weights `w_src`, phase weights `w_ph`), its `travel` table and
    `network`, and days of `day_sec` s drawn from default_rng(seed + 20 +
    k), cached in `days`."""

    def __init__(self, seed: int, n_src: int = 100_000, n_sta: int = 32,
                 day_sec: float = 86400.0, events=BP_EVENTS):
        self.src_km, self.sta_km, self.spacing = lattice(n_src, n_sta)
        self.tt = travel_times(self.src_km, self.sta_km)        # seconds
        self.mv = smooth_grid_moveouts(n_src, n_sta, SR)
        self.w_src = closest_weights(self.mv)
        self.w_ph = workflow.default_weights_phases(n_sta)
        self.stations = [f"B{s:02d}" for s in range(n_sta)]
        self.travel = TravelTimes.from_arrays(
            {ph: {name: self.tt[:, s, p]
                  for s, name in enumerate(self.stations)}
             for p, ph in enumerate(("P", "S"))},
            {"longitude": self.src_km[:, 0] / KM_PER_DEG,
             "latitude": self.src_km[:, 1] / KM_PER_DEG,
             "depth": self.src_km[:, 2]})
        self.travel.convert_to_samples(SR)
        self.network = Network.from_arrays(
            self.stations, longitude=self.sta_km[:, 0] / KM_PER_DEG,
            latitude=self.sta_km[:, 1] / KM_PER_DEG)
        self.seed, self.day_sec = seed, day_sec
        self.n_samp = int(day_sec * SR)
        self.events = events
        self.days: dict = {}

    def make_day(self, key: str) -> np.ndarray:
        """(n_sta, 3, n_samp) float32 day `key`, drawn anew."""
        g = np.random.default_rng(self.seed + 20 + int(key[1:]))
        x = g.standard_normal((len(self.stations), 3, self.n_samp),
                              dtype=np.float32)
        samp = self.travel.travel_times_samp
        for o, src in self.events[key]:
            for s, name in enumerate(self.stations):
                for c, ph in ((2, "P"), (0, "S"), (1, "S")):
                    a = o + int(samp[ph][name][src])
                    x[s, c, a - 6 : a + 7] += BURST
        return x

    def day(self, key: str) -> np.ndarray:
        if key not in self.days:
            self.days[key] = self.make_day(key)
        return self.days[key]

    def reader(self, where, network=None, stations=None, channels=None,
               location=None, starttime=None, endtime=None, **kwargs):
        """In-memory data reader of the BP days."""
        key = where.split("/")[-1]
        x = self.day(key)
        out = Stream()
        for s, name in enumerate(self.stations):
            for c, comp in enumerate("NEZ"):
                out += Trace(x[s, c], station=name, network="XX",
                             channel=f"HH{comp}", sampling_rate=SR,
                             starttime=day_start(key))
        return out

    def make_data(self, key: str) -> Data:
        return Data(DATES[key], f"bp/{key}", self.reader,
                    duration=self.day_sec, sampling_rate=SR).read_waveforms()
