"""The matched-filter world of `chip_smoke.py` (its phase 4), shared with
`tools/mesh_days.py`: the tutorial shape of the JAX package's `bench.py`,
10 stations x 3 components at 25 Hz, a bank of templates of L = 200
samples with moveouts in [-50, 400), two days of Gaussian noise (drawn in
memory from a seed) into which every template's event is injected on day
1 and the repeats of `REPEATS` on the days they name.  A template is cut
from day 1 at its own event.
"""

from __future__ import annotations

import numpy as np

from ..data import Data, Stream, TemplateGroup, Trace

SR = 25.0
N_STA, N_COMP, L = 10, 3, 200
T0_EPOCH = 1343260800.0             # 2012-07-26T00:00:00
DATES = {"d1": "2012-07-26", "d2": "2012-07-27"}
# (day, template, origin sample) of each repeat, away from every other event
REPEATS = [("d1", 3, 15000 + 16000 * 3 + 8000),
           ("d1", 77, 15000 + 16000 * 77 + 8000),
           ("d2", 3, 600000), ("d2", 50, 1200003), ("d2", 127, 2000011)]


def burst(rng, n):
    """A Hann-windowed random burst: the waveform of one event."""
    return (rng.normal(size=n) * np.hanning(n)).astype(np.float32)


def day_start(key: str) -> float:
    """Epoch seconds of day `key` ('d1', 'd2'): the dates are a day apart
    whatever the length of a (cut) day."""
    return T0_EPOCH + 86400.0 * (int(key[1:]) - 1)


class MFWorld:
    """The world of `n_tp` templates over days of `day_sec` s, drawn from
    `seed` (the bank from default_rng(seed + 1), day k's noise from
    default_rng(seed + 10 + k)).  `days` caches each day drawn;
    `reader` serves them in the package's reader protocol."""

    def __init__(self, seed: int, n_tp: int = 128, day_sec: float = 86400.0,
                 repeats=REPEATS):
        world = np.random.default_rng(seed + 1)
        mv = np.empty((n_tp, N_STA, N_COMP), np.int64)
        mv[:, :, 2] = world.integers(-50, 300, size=(n_tp, N_STA))     # Z
        mv[:, :, :2] = mv[:, :, 2:] + world.integers(0, 100,
                                                     size=(n_tp, N_STA, 2))
        self.mv = mv
        self.wave = np.stack([[[30.0 * burst(world, L)
                                for _ in range(N_COMP)]
                               for _ in range(N_STA)] for _ in range(n_tp)])
        # template i's event: day 1, origin sample 15000 + 16000 * i
        self.origins = 15000 + 16000 * np.arange(n_tp)
        self.seed, self.n_tp, self.day_sec = seed, n_tp, day_sec
        self.n_samp = int(day_sec * SR)
        self.repeats = list(repeats)
        self.stations = [f"ST{s:02d}" for s in range(N_STA)]
        self.days: dict = {}

    def make_day(self, key: str) -> np.ndarray:
        """(N_STA, N_COMP, n_samp) float32 day `key`, drawn anew."""
        g = np.random.default_rng(self.seed + 10 + int(key[1:]))
        x = g.standard_normal((N_STA, N_COMP, self.n_samp), dtype=np.float32)
        events = ([(i, int(o)) for i, o in enumerate(self.origins)]
                  if key == "d1" else [])
        events += [(i, o) for d, i, o in self.repeats if d == key]
        for i, o in events:
            for s in range(N_STA):
                for c in range(N_COMP):
                    st = o + self.mv[i, s, c]
                    x[s, c, st : st + L] += self.wave[i, s, c]
        return x

    def day(self, key: str) -> np.ndarray:
        if key not in self.days:
            self.days[key] = self.make_day(key)
        return self.days[key]

    def reader(self, where, network=None, stations=None, channels=None,
               location=None, starttime=None, endtime=None, **kwargs):
        """In-memory data reader (the package's reader protocol)."""
        key = where.split("/")[-1]
        x = self.day(key)
        out = Stream()
        for s, name in enumerate(self.stations):
            for c, comp in enumerate("NEZ"):
                out += Trace(x[s, c], station=name, network="XX",
                             channel=f"HH{comp}", sampling_rate=SR,
                             starttime=day_start(key))
        if starttime is not None or endtime is not None:
            out = out.slice(starttime, endtime)
        return out

    def make_data(self, key: str) -> Data:
        return Data(DATES[key], f"memory/{key}", self.reader,
                    duration=self.day_sec, sampling_rate=SR).read_waveforms()

    def bank(self) -> tuple:
        """(templates (n_tp, N_STA, N_COMP, L) cut from day 1 at each
        template's event, their `TemplateGroup`)."""
        d1 = self.day("d1")
        o, mv = self.origins, self.mv
        templates = np.stack([
            np.stack([np.stack([d1[s, c, o[i] + mv[i, s, c]:
                                   o[i] + mv[i, s, c] + L]
                                for c in range(N_COMP)])
                      for s in range(N_STA)])
            for i in range(self.n_tp)])
        tg = TemplateGroup.from_arrays(
            templates, mv, [str(i) for i in range(self.n_tp)],
            self.stations, components=("N", "E", "Z"), sampling_rate=SR,
            phases=("P", "S"),
            moveouts_sec=np.stack([mv[:, :, 2], mv[:, :, 0]], -1) / SR,
            locations=np.tile([30.0, 40.0, 8.0], (self.n_tp, 1)),
            origin_times=T0_EPOCH + o / SR,
        )
        return templates, tg
