"""A pool of days drawn in set-up and served through the port's reader
protocol, as `tools/year_world.py` and `tools/bp_world.py` serve theirs
(commit 8978ca3).

Campaign day `i` reads pool day `i % len(pool)`.  `Data.read_waveforms`
trims every trace it reads, which copies it, as a read from a file makes a
copy; drawing the noise is set-up and is not timed as the system's work.
"""

from __future__ import annotations

import numpy as np

from seismic_bpmf_tpu_torch.data import Data, Stream, Trace


class DayPool:
    """`days`: (n_sta, 3, n_samp) float32 host arrays, N, E, Z, of the
    stations `stations`, all stamped `date` (epoch seconds `t0_epoch`)."""

    def __init__(self, days, stations, sr: float, date: str,
                 t0_epoch: float, duration: float):
        self.days = list(days)
        self.stations = list(stations)
        self.sr = float(sr)
        self.date = date
        self.t0_epoch = float(t0_epoch)
        self.duration = float(duration)

    def __len__(self) -> int:
        return len(self.days)

    def reader(self, where, network=None, stations=None, channels=None,
               location=None, starttime=None, endtime=None, **kwargs):
        """The traces of pool day `where` ('pool/<k>'): honours the
        station list and the channel pattern; `Data` trims them."""
        x = self.days[int(str(where).rsplit("/", 1)[-1])]
        out = Stream()
        for i, name in enumerate(self.stations):
            if stations is not None and name not in stations:
                continue
            for c, comp in enumerate("NEZ"):
                if channels is None or str(channels).endswith(comp):
                    out += Trace(x[i, c], station=name, network="XX",
                                 channel=f"HH{comp}", sampling_rate=self.sr,
                                 starttime=self.t0_epoch)
        return out

    def make_data(self, i: int) -> Data:
        """A `Data` of campaign day `i`, waveforms read."""
        return Data(self.date, f"pool/{i % len(self.days)}", self.reader,
                    duration=self.duration,
                    sampling_rate=self.sr).read_waveforms()


def device_normal(gen, shape, device, scale: float = 1.0):
    """float32 N(0, scale^2) drawn on `device` from torch Generator `gen`."""
    import torch

    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(scale) if scale != 1.0 else x


def to_host(x) -> np.ndarray:
    return np.ascontiguousarray(x.cpu().numpy(), dtype=np.float32)
