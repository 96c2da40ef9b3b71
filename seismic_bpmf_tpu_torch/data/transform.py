"""Transformed-wavefield container.

Copy of `seismic_bpmf_tpu.data.transform` with pandas imported only in
`data_frame_view`.  Reference parity: `WaveformTransform`
(BPMF/template_search.py:223-395) —
holds a transform of the continuous wavefield with the same axes as the data
(e.g. PhaseNet P/S probability series), supports time slicing so day-long
picker outputs can be reused for per-event picking
(BPMF/dataset.py:1833-1852).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..utils.time import epoch_from_utc, sec_to_samp, time_range
from .stream import Stream, Trace


class WaveformTransform:
    def __init__(
        self,
        transform_arr: np.ndarray,
        stations: Sequence[str],
        components: Sequence[str],
        starttime,
        sampling_rate_hz: float,
    ):
        self.stations = list(stations)
        self.components = list(components)
        self.starttime = np.datetime64(starttime, "ns")
        self.sampling_rate = float(sampling_rate_hz)
        self._arr = np.asarray(transform_arr, np.float32)
        self.n_samples = self._arr.shape[-1]

    # ------------------------------------------------------------------
    @property
    def sr(self):
        return self.sampling_rate

    @property
    def delta(self):
        return 1.0 / self.sampling_rate

    @property
    def duration(self):
        return self.n_samples / self.sampling_rate

    @property
    def time(self):
        end = self.starttime + np.timedelta64(
            int(self.duration * 1e9), "ns"
        )
        return time_range(self.starttime, end, self.delta, unit="ms")

    @property
    def transform_arr(self) -> np.ndarray:
        return self._arr

    @property
    def transform(self) -> Stream:
        """Stream view (built lazily)."""
        st = Stream()
        t0 = epoch_from_utc(self.starttime)
        for s, sta in enumerate(self.stations):
            for c, cp in enumerate(self.components):
                st += Trace(
                    self._arr[s, c],
                    station=str(sta),
                    channel=str(cp),
                    sampling_rate=self.sampling_rate,
                    starttime=t0,
                )
        return st

    def data_frame_view(self):
        """(stations x components) pandas DataFrame of the series (pandas
        imported here)."""
        import pandas as pd

        df = pd.DataFrame(index=self.stations, columns=self.components,
                          dtype=object)
        for s, sta in enumerate(self.stations):
            for c, cp in enumerate(self.components):
                df.loc[sta, cp] = self._arr[s, c]
        return df

    def get_np_array(self, stations, components=None, verbose=True):
        if components is None:
            components = self.components
        sta_idx = {s: i for i, s in enumerate(self.stations)}
        cp_idx = {c: i for i, c in enumerate(self.components)}
        out = np.zeros(
            (len(stations), len(components), self.n_samples), np.float32
        )
        for i, sta in enumerate(stations):
            if sta not in sta_idx:
                continue
            for j, cp in enumerate(components):
                if cp in cp_idx:
                    out[i, j] = self._arr[sta_idx[sta], cp_idx[cp]]
        return out

    def slice(
        self,
        starttime,
        duration: Optional[float] = None,
        num_samples: Optional[int] = None,
        stations=None,
        components=None,
    ) -> "WaveformTransform":
        """New instance covering [starttime, starttime + duration).

        Reference parity: BPMF/template_search.py:327-395.
        """
        if duration is None and num_samples is None:
            raise ValueError("specify duration or num_samples")
        if num_samples is None:
            num_samples = int(duration * self.sampling_rate)
        start = np.datetime64(starttime, "ns")
        i0 = int(
            sec_to_samp(
                epoch_from_utc(start) - epoch_from_utc(self.starttime),
                sr=self.sampling_rate,
            )
        )
        i0 = max(0, i0)
        i1 = min(self.n_samples, i0 + num_samples)
        arr = self._arr[..., i0:i1]
        if arr.shape[-1] < num_samples:
            arr = np.pad(
                arr, ((0, 0), (0, 0), (0, num_samples - arr.shape[-1]))
            )
        out_stations = list(stations) if stations is not None else self.stations
        out_components = (
            list(components) if components is not None else self.components
        )
        sub = WaveformTransform(
            arr, self.stations, self.components,
            self.starttime + np.timedelta64(
                int(round(i0 * self.delta * 1e9)), "ns"
            ),
            self.sampling_rate,
        )
        if out_stations != self.stations or out_components != self.components:
            sub = WaveformTransform(
                sub.get_np_array(out_stations, out_components),
                out_stations, out_components, sub.starttime,
                self.sampling_rate,
            )
        return sub
