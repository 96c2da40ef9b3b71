"""Event and Template containers with HDF5 IO.

Copy of the parts of `seismic_bpmf_tpu.data.events` that the day scans,
the P/S picking and the relocations use (reference parity: `Event`,
BPMF/dataset.py:1052-3240, and `Template`, BPMF/dataset.py:3243-4079),
with the same on-disk HDF5 schema.  Moveouts are stored as a numpy array
aligned to `stations`, picks and arrival times as `ops.picks.PickTable`s
(`picks_table`, `arrival_times_table`); the pandas tables `moveouts`,
`picks` and `arrival_times` are built only when they are read, with pandas
imported there.  Each of the two pick tables has one store, holding the
form set or read last (`Event._table`, `Event._frame`).
h5py is imported inside the functions that do file IO.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np

from ..ops.picks import PickTable, is_null
from ..utils.observe import logger
from ..utils.time import (
    epoch_from_utc, sec_to_samp, timedelta_sec, utc_from_epoch,
)
from .stream import Stream, Trace
from .waveforms import DEFAULT_ALIASES, get_np_array

DEFAULT_PHASE_ON_COMP = {"N": "S", "1": "S", "E": "S", "2": "S", "Z": "P"}
DEFAULT_OFFSET_PHASE = {"P": 1.0, "S": 4.0}


def _to_datetime64(t) -> np.datetime64:
    if isinstance(t, np.datetime64):
        return t.astype("datetime64[ns]")
    if isinstance(t, (int, float)):
        return utc_from_epoch(float(t))
    return np.datetime64(str(t), "ns")


def _nulls(values: np.ndarray) -> np.ndarray:
    """Boolean mask of the NaN / NaT / None cells of a column."""
    if values.dtype.kind == "M":
        return np.isnat(values)
    if values.dtype.kind == "f":
        return np.isnan(values)
    return np.array([is_null(v) for v in values], bool)


def _with_nulls(values: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """A copy of a column with NaN (NaT for times) where `mask` is set;
    integer columns become float64 as pandas makes them."""
    if values.dtype.kind in "iub":
        values = values.astype(np.float64)
    out = values.copy()
    out[mask] = np.datetime64("NaT") if out.dtype.kind == "M" else np.nan
    return out


def _arrivals(ot: np.datetime64, tts) -> np.ndarray:
    """ot + `Timedelta(seconds=tt)` for each travel time, datetime64[ns]."""
    return np.array([ot + timedelta_sec(t) for t in tts], "datetime64[ns]")


def event_id(origin_time) -> str:
    """'YYYYmmdd_HHMMSS.ffffff' of a datetime64 (the reference's
    `Timestamp.strftime("%Y%m%d_%H%M%S.%f")`, microseconds floored)."""
    s = str(np.datetime64(origin_time, "ns").astype("datetime64[us]"))
    return (f"{s[0:4]}{s[5:7]}{s[8:10]}_{s[11:13]}{s[14:16]}{s[17:19]}"
            f".{s[20:26]}")


class Event:
    """A detected or candidate earthquake: origin, moveouts, waveforms.

    Reference parity: BPMF/dataset.py:1052-1142 (constructor semantics).
    Moveouts are given in **seconds** as an (n_stations, n_phases) array.
    """

    def __init__(
        self,
        origin_time,
        moveouts,
        stations,
        phases,
        data_filename: str = "",
        data_path: str = "",
        latitude: Optional[float] = None,
        longitude: Optional[float] = None,
        depth: Optional[float] = None,
        component_aliases: Dict[str, List[str]] = DEFAULT_ALIASES,
        sampling_rate: Optional[float] = None,
        components=("N", "E", "Z"),
        id: Optional[str] = None,
        data_reader: Optional[Callable] = None,
    ):
        self.origin_time = _to_datetime64(origin_time)
        self.date = self.origin_time
        self.where = os.path.join(data_path, data_filename)
        self.component_aliases = component_aliases
        self.latitude, self.longitude = latitude, longitude
        self.depth = depth
        self.sampling_rate = sampling_rate
        self.stations = np.asarray(stations).astype("U")
        self.components = np.asarray(list(components)).astype("U")
        self.phases = np.asarray(phases).astype("U")

        mv = np.atleast_2d(np.asarray(moveouts))
        if np.issubdtype(mv.dtype, np.integer):
            logger.warning(
                "Event moveouts should be seconds, got an integer array — "
                "if these are sample counts, pass moveouts / sampling_rate"
            )
        self._moveouts_raw = mv
        self._moveouts_df = None
        self.id = event_id(self.origin_time) if id is None else str(id)
        self.data_reader = data_reader
        self.aux_data: Dict = {}
        self._tables = {"picks": None, "arrival_times": None}

    # ------------------------------------------------------------------
    @property
    def moveouts(self):
        """One column per phase ('moveouts_<PH>'), indexed by station, as
        a pandas DataFrame built on first access (pandas is imported
        here).  In-place `.loc` edits persist."""
        if self._moveouts_df is None:
            import pandas as pd

            self._moveouts_df = pd.DataFrame(
                self._moveouts_raw,
                index=pd.Index(self.stations, name="stations"),
                columns=[f"moveouts_{p.upper()}" for p in self.phases],
            )
        return self._moveouts_df

    @moveouts.setter
    def moveouts(self, value):
        self._moveouts_df = value

    def moveouts_table(self) -> np.ndarray:
        """(n_stations, n_phases) moveouts in seconds, rows in `stations`
        order (the DataFrame's values once it exists)."""
        if self._moveouts_df is not None:
            return np.asarray(self._moveouts_df.loc[self.stations].values)
        return self._moveouts_raw

    def moveouts_at(self, stations) -> np.ndarray:
        """Moveout rows (seconds) of the given stations, in that order."""
        row = {s: i for i, s in enumerate(self.stations)}
        return self.moveouts_table()[[row[s] for s in stations]]

    def _set_moveouts(self, table: np.ndarray):
        self._moveouts_raw, self._moveouts_df = table, None

    @property
    def origin_time_epoch(self) -> float:
        return epoch_from_utc(self.origin_time)

    @property
    def location(self):
        return [self.longitude, self.latitude, self.depth]

    @property
    def sr(self):
        return self.sampling_rate

    @property
    def n_samples(self):
        return int(sec_to_samp(self.duration, sr=self.sr))

    @property
    def waveforms_arr(self):
        return get_np_array(
            self.traces,
            self.stations,
            components=self.components,
            priority="HH",
            component_aliases=self.component_aliases,
            n_samples=self.n_samples,
            verbose=False,
        )

    @property
    def hmax_unc(self):
        return self._unc("hmax_unc")

    @property
    def hmin_unc(self):
        return self._unc("hmin_unc")

    @property
    def vmax_unc(self):
        return self._unc("vmax_unc")

    @property
    def az_hmax_unc(self):
        return self._unc("az_hmax_unc")

    @property
    def az_hmin_unc(self):
        return self._unc("az_hmin_unc")

    @property
    def pl_vmax_unc(self):
        return self._unc("pl_vmax_unc")

    def _unc(self, name):
        if name in self.aux_data:
            return self.aux_data[name]
        self.hor_ver_uncertainties()
        return self.aux_data[name]

    # ------------------------------------------------------------------
    def set_aux_data(self, aux_data: Dict):
        self.aux_data.update(aux_data)

    def set_components(self, components):
        self.components = np.asarray(list(components)).astype("U")

    def set_component_aliases(self, component_aliases: Dict):
        """Set the channel-alias map, e.g. {'N': ['N', '1'], ...}
        (reference parity: BPMF/dataset.py `set_component_aliases`)."""
        self.component_aliases = component_aliases

    @property
    def availability(self) -> np.ndarray:
        """Alias of `availability_per_sta` (set by `set_availability`)."""
        try:
            return self.availability_per_sta
        except AttributeError:
            raise RuntimeError("call set_availability first") from None

    def inherit_location(self, other: "Event"):
        """Reference parity: BPMF/dataset.py:1423-1439."""
        for attr in ("longitude", "latitude", "depth"):
            setattr(self, attr, getattr(other, attr))
        cov = getattr(other, "cov_mat", None)
        if cov is None and "cov_mat" in getattr(other, "aux_data", {}):
            cov = other.aux_data["cov_mat"]
        if cov is not None:
            self.cov_mat = cov
            self.set_aux_data({"cov_mat": cov})

    def set_availability(self, stations=None):
        """Availability = any non-zero sample on any component; sets
        `availability_per_cha` ((n_sta, n_comp) bool) and
        `availability_per_sta`."""
        stations = list(stations if stations is not None else self.stations)
        avail_cha = np.zeros((len(stations), len(self.components)), bool)
        if hasattr(self, "traces"):
            arr = self.waveforms_arr
            for s in range(len(stations)):
                avail_cha[s] = np.any(arr[s] != 0.0, axis=-1)
        self.availability_per_cha = avail_cha
        self.availability_per_sta = avail_cha.any(axis=1)
        return self.availability_per_sta

    # ------------------------------------------------------------------
    # waveforms
    # ------------------------------------------------------------------
    def read_waveforms(
        self,
        duration: float,
        phase_on_comp: Dict[str, str] = DEFAULT_PHASE_ON_COMP,
        component_aliases: Dict[str, List[str]] = DEFAULT_ALIASES,
        offset_phase: Dict[str, float] = DEFAULT_OFFSET_PHASE,
        time_shifted: bool = True,
        offset_ot: float = 20.0,
        data_reader: Optional[Callable] = None,
        **reader_kwargs,
    ):
        """Extract per-channel windows around the predicted phase arrivals.

        Reference parity: BPMF/dataset.py:1929-2069.  With `time_shifted`,
        the window on component `c` starts at
        ``origin_time + moveout(phase_on_comp[c]) - offset_phase[phase]``.
        """
        data_reader = data_reader or self.data_reader
        if data_reader is None:
            raise RuntimeError("a data_reader is required")
        self.data_reader = data_reader
        self.traces = Stream()
        self.duration = duration
        ot = self.origin_time_epoch
        table = self.moveouts_table()
        col = {p.upper(): i for i, p in enumerate(self.phases)}
        for s, sta in enumerate(self.stations):
            for comp in self.components:
                ph = phase_on_comp[comp].upper()
                if time_shifted:
                    start = (ot + float(table[s, col[ph]])
                             - offset_phase[ph])
                else:
                    start = ot - offset_ot
                for cp_alias in component_aliases[comp]:
                    st = data_reader(
                        self.where,
                        stations=[sta],
                        channels=f"*{cp_alias}",
                        starttime=utc_from_epoch(start),
                        endtime=utc_from_epoch(start + duration),
                        **reader_kwargs,
                    )
                    if len(st) > 0:
                        self.traces += st
                        break
        for ph, off in offset_phase.items():
            self.set_aux_data({f"offset_{ph.upper()}": off})
        for comp, ph in phase_on_comp.items():
            self.set_aux_data({f"phase_on_comp{comp}": ph})
        if len(self.traces) > 0:
            self.sampling_rate = self.traces[0].stats.sampling_rate
        if not time_shifted:
            self.trim_waveforms(
                starttime=ot - offset_ot,
                endtime=ot - offset_ot + duration,
            )
        return self

    def trim_waveforms(self, starttime=None, endtime=None):
        for tr in self.traces:
            tr.trim(starttime=starttime, endtime=endtime, pad=True,
                    fill_value=0.0)

    def get_np_array(self, stations=None, components=None) -> np.ndarray:
        """Dense (n_stations, n_components, n_samples) float32 array of the
        event's traces, zero rows for missing channels (reference parity:
        BPMF/dataset.py `Event.get_np_array`)."""
        stations = list(stations if stations is not None else self.stations)
        components = list(
            components if components is not None else self.components
        )
        return get_np_array(
            self.traces, stations, components=components,
            n_samples=self.n_samples,
            component_aliases=self.component_aliases,
        )

    def get_peak_amplitudes(self, stations=None,
                            components=None) -> np.ndarray:
        """(n_stations, n_components) peak |amplitude - mean| per channel
        (reference parity: BPMF/dataset.py:1494-1519, which demeans so
        that DC offsets do not count as signal)."""
        arr = self.get_np_array(stations, components)
        return np.max(
            np.abs(arr - arr.mean(axis=-1, keepdims=True)), axis=-1
        )

    def compute_snr(self, noise_window_sec: float = 5.0) -> np.ndarray:
        """Amplitude SNR per channel, RMS(signal) / RMS(noise) with the
        noise the first `noise_window_sec` of each window (reference
        parity: BPMF/dataset.py:1441-1520, simplified as in the JAX
        package).  Sets `snr`, (n_stations, n_components) float64 in
        `stations` x `components` order, and the aux data `snr_<comp>`
        (arrays aligned to `stations`; the JAX package keeps Series)."""
        arr = self.waveforms_arr
        n_noise = int(sec_to_samp(noise_window_sec, sr=self.sr))

        def rms(x):
            return np.sqrt(np.mean(x.astype(np.float64) ** 2, axis=-1))

        noise_rms = rms(arr[..., :n_noise])
        snr = np.where(noise_rms > 0,
                       rms(arr[..., n_noise:]) / np.maximum(noise_rms, 1e-30),
                       0.0)
        for c, cp in enumerate(self.components):
            self.set_aux_data({f"snr_{cp}": snr[:, c]})
        self._snr = snr
        return self._snr

    @property
    def snr(self) -> np.ndarray:
        try:
            return self._snr
        except AttributeError:
            raise RuntimeError("call compute_snr first") from None

    def n_closest_stations(self, n: int, available_stations=None):
        """The n stations of smallest first-phase moveout (reference
        parity: BPMF/dataset.py:1612-1652, moveout as distance proxy)."""
        mv = np.array(self.moveouts_table()[:, 0], np.float64)
        if available_stations is not None:
            mv[~np.isin(self.stations, list(available_stations))] = np.inf
        order = np.argsort(mv, kind="stable")
        return self.stations[order[:n]].astype("U")

    def n_best_SNR_stations(self, n: int, available_stations=None):
        """The n stations of highest mean SNR (reference parity:
        BPMF/dataset.py:1654-1704)."""
        snr = self.snr.mean(axis=1)
        if available_stations is not None:
            snr[~np.isin(self.stations, list(available_stations))] = -np.inf
        order = np.argsort(snr, kind="stable")[::-1]
        return self.stations[order[:n]].astype("U")

    def zero_out_clipped_waveforms(self, kurtosis_threshold: float = -1.0):
        """Zero the traces whose sample-distribution kurtosis is below the
        threshold: clipped recordings are platykurtic (reference parity:
        BPMF/dataset.py:2868-2894)."""
        from scipy.stats import kurtosis as scipy_kurtosis

        for tr in self.traces:
            if len(tr.data) and scipy_kurtosis(tr.data) < kurtosis_threshold:
                tr.data = np.zeros_like(tr.data)

    # ------------------------------------------------------------------
    # picking
    # ------------------------------------------------------------------
    def _table(self, name: str) -> Optional[PickTable]:
        """The `name` table ('picks' or 'arrival_times') as a PickTable
        (None before any).  Each table has one store, which holds what was
        set or read last; a DataFrame there is converted once and replaced,
        so repeated reads give one object and in-place edits persist."""
        value = self._tables[name]
        if value is not None and not isinstance(value, PickTable):
            value = self._tables[name] = PickTable.from_frame(value)
        return value

    def _frame(self, name: str):
        """The `name` table as the JAX package's DataFrame indexed by
        station, built from the PickTable in the store on first read
        (pandas imported there) and kept in its place."""
        value = self._tables[name]
        if value is None:
            raise AttributeError(name)
        if isinstance(value, PickTable):
            value = self._tables[name] = value.to_frame()
        return value

    @property
    def picks_table(self) -> Optional[PickTable]:
        """The picks as a PickTable (None before a pick)."""
        return self._table("picks")

    @picks_table.setter
    def picks_table(self, table):
        self._tables["picks"] = table

    @property
    def picks(self):
        """The picks of `pick_PS_phases` (or of the event's file) as a
        pandas DataFrame indexed by station.  No attribute before a
        pick."""
        return self._frame("picks")

    @picks.setter
    def picks(self, value):
        self._tables["picks"] = value

    @property
    def arrival_times_table(self) -> Optional[PickTable]:
        """The arrival times as a PickTable (None before any), columns
        {P,S}_tt_sec (float) and {P,S}_abs_arrival_times
        (datetime64[ns])."""
        return self._table("arrival_times")

    @arrival_times_table.setter
    def arrival_times_table(self, table):
        self._tables["arrival_times"] = table

    @property
    def arrival_times(self):
        """The arrival times as a pandas DataFrame indexed by station.  No
        attribute before any."""
        return self._frame("arrival_times")

    @arrival_times.setter
    def arrival_times(self, value):
        self._tables["arrival_times"] = value

    def pick_PS_phases(
        self,
        duration: float,
        picker: Optional[Callable] = None,
        threshold_P: float = 0.60,
        threshold_S: float = 0.60,
        offset_ot: float = 20.0,
        picker_sampling_rate: float = 100.0,
        component_order: str = "ZNE",
        waveform_transform=None,
        **reader_kwargs,
    ):
        """Pick P/S arrivals with an ML phase picker.

        `picker` follows the reference's picker-callable protocol
        (BPMF/dataset.py:1729-1736): probas (n_sta, 2, n_t) = picker(x
        (n_sta, 3, n_t)) with channel order `component_order` at
        `picker_sampling_rate` (the event's waveforms, read over
        [origin - offset_ot, + duration) when not read yet, are resampled
        to it); output phases ordered (P, S).  Or pass
        `waveform_transform` (a `WaveformTransform` of day-long P/S
        probability series with components ('P', 'S')) to slice
        precomputed picker outputs instead of running the model again
        (reference: BPMF/dataset.py:1833-1852).

        Sets and returns `picks_table`, an `ops.picks.PickTable` with
        columns {P,S}_{picks,probas,unc} (float32; picks and
        uncertainties in samples at the event's rate from origin -
        offset_ot) and {P,S}_abs_picks (datetime64[ns], NaT where no
        pick); `picks` is its DataFrame.  Reference parity:
        BPMF/dataset.py:1706-1927 (core path).
        """
        from scipy.signal import resample_poly

        from ..ops.picks import candidates, find_picks, get_picks

        if waveform_transform is not None:
            start = utc_from_epoch(self.origin_time_epoch - offset_ot)
            sub = waveform_transform.slice(
                start, duration=duration, stations=list(self.stations),
                components=["P", "S"],
            )
            probas = sub.transform_arr  # (n_sta, 2, n_t)
            sr_p = waveform_transform.sr
            if self.sampling_rate is None:
                self.sampling_rate = sr_p
        else:
            if picker is None:
                raise ValueError(
                    "provide `picker` or `waveform_transform`"
                )
            if not hasattr(self, "traces"):
                self.read_waveforms(
                    duration, time_shifted=False, offset_ot=offset_ot,
                    **reader_kwargs,
                )
            arr = self.waveforms_arr  # (n_sta, n_comp(NEZ), n)
            # reorder to the picker's component order
            comp_idx = {c: i for i, c in enumerate(self.components)}
            order = [comp_idx[c] for c in component_order if c in comp_idx]
            x = arr[:, order, :]
            if self.sr != picker_sampling_rate:
                up = int(round(picker_sampling_rate))
                down = int(round(self.sr))
                x = resample_poly(x, up, down, axis=-1)
            probas = np.asarray(picker(x))  # (n_sta, 2, n_t)
            sr_p = picker_sampling_rate
        rows = {}
        for s, sta in enumerate(self.stations):
            row = {}
            for p, ph in enumerate(("P", "S")):
                thr = threshold_P if ph == "P" else threshold_S
                values, means, stds = find_picks(probas[s, p], thr)
                row[f"{ph}_probas"] = values
                row[f"{ph}_picks"] = means / sr_p * self.sr  # native samples
                row[f"{ph}_unc"] = stds / sr_p * self.sr
            rows[sta] = row
        table = get_picks(candidates(rows), buffer_length=0)
        # absolute times
        t0 = epoch_from_utc(self.origin_time) - offset_ot
        for ph in ("P", "S"):
            v = table[f"{ph}_picks"]
            abs_t = np.full(len(v), np.datetime64("NaT"), "datetime64[ns]")
            for i in np.flatnonzero(~np.isnan(v)):
                abs_t[i] = utc_from_epoch(t0 + float(v[i]) / self.sr)
            table.columns[f"{ph}_abs_picks"] = abs_t
        self.picks_table = table
        return table

    # ------------------------------------------------------------------
    # moveouts, arrival times and distances (reference parity:
    # BPMF/dataset.py:2653-2689 and the helpers around them)
    # ------------------------------------------------------------------
    def set_moveouts_to_empirical_times(self):
        """Set moveouts from picked arrival times (seconds after origin).

        Reference parity: BPMF/dataset.py:2653-2671.  Picks of stations
        that are not the event's are skipped."""
        picks = self.picks_table
        if picks is None:
            raise RuntimeError("no picks; call pick_PS_phases first")
        ot = self.origin_time_epoch
        table = np.array(self.moveouts_table())
        row = {s: i for i, s in enumerate(self.stations)}
        for p, ph in enumerate(self.phases):
            col = f"{ph.upper()}_abs_picks"
            if col not in picks.columns:
                continue
            for sta, t in zip(picks.stations, picks[col]):
                if sta in row and not is_null(t):
                    table[row[sta], p] = epoch_from_utc(t) - ot
        self._set_moveouts(table)

    def set_moveouts_to_theoretical_times(self, travel_times):
        """Set moveouts from a (stations x phases) travel-time table: a
        DataFrame indexed by station, or a PickTable, with one column per
        phase name.

        Reference parity: BPMF/dataset.py:2673-2689."""
        if not isinstance(travel_times, PickTable):
            travel_times = PickTable.from_frame(travel_times)
        at = {s: i for i, s in enumerate(travel_times.stations)}
        table = np.array(self.moveouts_table())
        for p, ph in enumerate(self.phases):
            for s, sta in enumerate(self.stations):
                if sta in at:
                    table[s, p] = travel_times[ph][at[sta]]
        self._set_moveouts(table)

    def set_arrival_times_from_moveouts(self):
        """Arrival times assuming arrival = origin time + moveout
        (reference parity: BPMF/dataset.py
        `set_arrival_times_from_moveouts`): `arrival_times_table` with
        {P,S}_abs_arrival_times and {P,S}_tt_sec (float64)."""
        table = self.moveouts_table()
        columns = {}
        for p, ph in enumerate(self.phases):
            mv = np.asarray(table[:, p], np.float64)
            columns[f"{ph.upper()}_abs_arrival_times"] = _arrivals(
                self.origin_time, mv)
            columns[f"{ph.upper()}_tt_sec"] = mv
        self.arrival_times_table = PickTable(self.stations, columns)

    def set_source_receiver_dist(self, network):
        """Hypocentral and epicentral source-receiver distances (km) of the
        event's stations, from a `Network` (reference parity:
        BPMF/dataset.py `set_source_receiver_dist`); numpy arrays aligned to
        `stations` (the JAX package's Series hold the same values)."""
        from ..utils.geo import compute_distances

        idx = network.stations_idx(list(self.stations))
        lon, lat = network.longitude[idx], network.latitude[idx]
        hyp = compute_distances(
            [self.longitude], [self.latitude], [self.depth],
            lon, lat, network.depth[idx],
        )[0]
        epi = compute_distances(
            [self.longitude], [self.latitude], [0.0], lon, lat,
            np.zeros(len(idx)),
        )[0]
        self._source_receiver_dist = hyp
        self._source_receiver_epicentral_dist = epi
        return hyp

    @property
    def source_receiver_dist(self) -> np.ndarray:
        return self._distances("_source_receiver_dist")

    @property
    def source_receiver_epicentral_dist(self) -> np.ndarray:
        return self._distances("_source_receiver_epicentral_dist")

    def _distances(self, attr):
        try:
            return getattr(self, attr)
        except AttributeError:
            raise RuntimeError(
                "call set_source_receiver_dist(network) first") from None

    def remove_distant_stations(self, network=None,
                                max_distance_km: float = 50.0):
        """NaN out picks on stations farther than `max_distance_km`
        (reference parity: BPMF/dataset.py `remove_distant_stations`)."""
        if not hasattr(self, "_source_receiver_dist"):
            if network is None:
                raise RuntimeError(
                    "call set_source_receiver_dist(network) first or pass "
                    "`network`"
                )
            self.set_source_receiver_dist(network)
        picks = self.picks_table
        if picks is None:
            return
        dist = dict(zip(self.stations, self._source_receiver_dist))
        far = np.array([float(dist.get(s, -np.inf)) > max_distance_km
                        for s in picks.stations], bool)
        self.picks_table = PickTable(picks.stations, {
            c: _with_nulls(v, far) for c, v in picks.columns.items()})

    def update_picks(self):
        """Refresh relative pick times ({P,S}_picks_sec, float32) against
        the current origin time (reference parity: BPMF/dataset.py
        `update_picks`)."""
        picks = self.picks_table
        if picks is None:
            return
        ot = self.origin_time_epoch
        columns = dict(picks.columns)
        for ph in self.phases:
            ph = ph.upper()
            col = f"{ph}_abs_picks"
            if col not in columns:
                continue
            sec = np.array(columns.get(f"{ph}_picks_sec",
                                       np.full(len(picks), np.nan,
                                               np.float32)))
            for i in np.flatnonzero(~_nulls(columns[col])):
                sec[i] = np.float32(epoch_from_utc(columns[col][i]) - ot)
            columns[f"{ph}_picks_sec"] = sec
        self.picks_table = PickTable(picks.stations, columns)

    def update_travel_times(self):
        """Refresh {P,S}_tt_sec against the current origin time
        (reference parity: BPMF/dataset.py `update_travel_times`)."""
        at = self.arrival_times_table
        if at is None:
            return
        ot = self.origin_time_epoch
        columns = dict(at.columns)
        for ph in self.phases:
            ph = ph.upper()
            col = f"{ph}_abs_arrival_times"
            if col not in columns:
                continue
            tt = np.array(columns.get(f"{ph}_tt_sec",
                                      np.full(len(at), np.nan)))
            for i in np.flatnonzero(~_nulls(columns[col])):
                tt[i] = epoch_from_utc(columns[col][i]) - ot
            columns[f"{ph}_tt_sec"] = tt
        self.arrival_times_table = PickTable(at.stations, columns)

    def remove_outlier_picks(self, max_diff_percent: float = 25.0,
                             min_tt: float = 2.0):
        """Drop picks whose deviation from the predicted arrival time
        exceeds `max_diff_percent` of the predicted travel time.

        Reference parity: BPMF/dataset.py:2464-2520.  The predicted arrival
        comes from `arrival_times_table` where it has the station's
        {ph}_tt_sec (NLLoc's predictions after `relocate_NLLoc`), from
        {ph}_abs_arrival_times there or else origin time + that travel
        time; otherwise from origin time + moveout.  Picks whose predicted
        travel time is below `min_tt` are kept, and the travel time is
        floored at 5 samples."""
        picks = self.picks_table
        if picks is None:
            return
        ot = self.origin_time_epoch
        at = self.arrival_times_table
        at_row = ({} if at is None
                  else {s: i for i, s in enumerate(at.stations)})
        mv_row = {s: i for i, s in enumerate(self.stations)}
        mv_col = {f"moveouts_{p.upper()}": i
                  for i, p in enumerate(self.phases)}
        moveouts = self.moveouts_table()
        columns = dict(picks.columns)
        for ph in ("P", "S"):
            col = f"{ph}_abs_picks"
            if col not in columns:
                continue
            drop = np.zeros(len(picks), bool)
            for i, sta in enumerate(picks.stations):
                t = columns[col][i]
                if is_null(t):
                    continue
                j = at_row.get(sta)
                tt_col, abs_col = f"{ph}_tt_sec", f"{ph}_abs_arrival_times"
                if (j is not None and tt_col in at.columns
                        and not is_null(at[tt_col][j])):
                    predicted_tt = float(at[tt_col][j])
                    if abs_col in at.columns and not is_null(at[abs_col][j]):
                        predicted = epoch_from_utc(at[abs_col][j])
                    else:
                        # tables with only tt columns (e.g. hand-built):
                        # absolute arrival = origin time + predicted tt
                        predicted = ot + predicted_tt
                elif sta in mv_row and f"moveouts_{ph}" in mv_col:
                    predicted_tt = float(
                        moveouts[mv_row[sta], mv_col[f"moveouts_{ph}"]])
                    predicted = ot + predicted_tt
                else:
                    continue
                if predicted_tt < min_tt:
                    continue
                predicted_tt = max(predicted_tt, 5.0 / self.sr)
                pick = epoch_from_utc(t)
                drop[i] = (100.0 * abs(pick - predicted) / predicted_tt
                           > max_diff_percent)
            for c in (f"{ph}_picks", f"{ph}_probas", f"{ph}_unc", col):
                if c in columns:
                    columns[c] = _with_nulls(columns[c], drop)
        self.picks_table = PickTable(picks.stations, columns)

    # ------------------------------------------------------------------
    # location uncertainty
    # ------------------------------------------------------------------
    def hor_ver_uncertainties(self):
        """Horizontal/vertical marginals of the location covariance.

        From `self.cov_mat` (3x3, km^2, E-N-Z right-handed), computes the
        max/min horizontal and max vertical standard errors and azimuths.
        Reference parity: BPMF/dataset.py:1521-1610.
        """
        cov = getattr(self, "cov_mat", None)
        if cov is None:
            cov = self.aux_data.get("cov_mat")
        if cov is None:
            # unlocated event: report large defaults
            self.set_aux_data(
                {"hmax_unc": 15.0, "hmin_unc": 15.0, "vmax_unc": 15.0,
                 "az_hmax_unc": 0.0, "az_hmin_unc": 90.0,
                 "pl_vmax_unc": 0.0}
            )
            return
        cov = np.asarray(cov)
        # horizontal 2x2 block
        h = cov[:2, :2]
        w, v = np.linalg.eigh(h)
        hmax = float(np.sqrt(max(w[1], 0.0)))
        hmin = float(np.sqrt(max(w[0], 0.0)))
        az_hmax = float(np.degrees(np.arctan2(v[0, 1], v[1, 1]))) % 180.0
        az_hmin = float(np.degrees(np.arctan2(v[0, 0], v[1, 0]))) % 180.0
        vmax = float(np.sqrt(max(cov[2, 2], 0.0)))
        # plunge of the most-vertical semi-axis of the full 3-D ellipsoid,
        # measured from VERTICAL as in the reference (arccos of the
        # vertical direction cosine, folded to [0, 90];
        # BPMF/dataset.py:1607-1608): 0 deg = vertical axis
        w3, v3 = np.linalg.eigh(cov)
        vert = np.sqrt(np.maximum(w3, 0.0)) * np.abs(v3[2, :])
        i = int(np.argmax(vert))
        pl_vmax = float(np.degrees(np.arccos(
            np.clip(np.abs(v3[2, i]), 0.0, 1.0)
        )))
        self.set_aux_data(
            {"hmax_unc": hmax, "hmin_unc": hmin, "vmax_unc": vmax,
             "az_hmax_unc": az_hmax, "az_hmin_unc": az_hmin,
             "pl_vmax_unc": pl_vmax}
        )

    # ------------------------------------------------------------------
    # relocation (beam; the NLLoc glue lives in location/)
    # ------------------------------------------------------------------
    def relocate(self, *args, routine: str = "beam", **kwargs):
        routine = routine.lower()
        if routine == "beam":
            return self.relocate_beam(*args, **kwargs)
        elif routine == "nlloc":
            from ..location.nlloc import relocate_nlloc

            return relocate_nlloc(self, *args, **kwargs)
        raise ValueError(f"unknown relocation routine {routine!r}")

    def relocate_NLLoc(self, *args, **kwargs):
        """Reference-name alias (BPMF/dataset.py:2388-2421) for
        ``relocate(routine='nlloc')``."""
        return self.relocate(*args, routine="nlloc", **kwargs)

    def relocate_beam(
        self,
        beamformer,
        waveform_features=None,
        duration: float = 60.0,
        offset_ot: float = 10.0,
        phase_on_comp: Dict[str, str] = DEFAULT_PHASE_ON_COMP,
        component_aliases: Dict[str, List[str]] = DEFAULT_ALIASES,
        uncertainty_method: str = "spatial",
        restricted_domain_side_km: float = 100.0,
        out_of_bounds: str = "flexible",
        read_waveforms: bool = True,
        effective_kT: float = 0.33,
        gibbs_cutoff: float = 0.25,
        features_starttime: Optional[float] = None,
        **reader_kwargs,
    ):
        """Fine-grid beam relocation: backproject waveform features and move
        the hypocenter (and origin time) to the beam argmax.

        Reference parity: BPMF/dataset.py:2102-2269.  With
        ``waveform_features=None`` the event's own waveforms are read in
        picking mode (``duration`` seconds starting ``offset_ot`` before
        the origin time), std-normalized per station, and enveloped on the
        beamformer's device.

        `uncertainty_method`:
          - ``"spatial"``: the full (source, time) beam stays on the
            device; its first maximum (row-major, as numpy's argmax) is
            found there and only the beam's column at that time (n_src
            floats) comes to the host.  The uncertainty is the
            likelihood-weighted mean distance over the sources of a
            ``restricted_domain_side_km`` box at that time.
          - ``"temporal"``: the max-reduced beam; the uncertainty domain
            is the set of per-time argmax sources weighted by a Gibbs
            distribution of the max beam (``effective_kT``,
            ``gibbs_cutoff``).

        The origin time moves to the beam's argmax time when the features'
        absolute start time is known (features read here, or
        ``features_starttime`` in epoch seconds); otherwise it is left
        unchanged.  Sets `arrival_times_table` from the relocated source's
        moveouts."""
        from ..ops.cf import envelope

        if waveform_features is None:
            if read_waveforms:
                self.read_waveforms(
                    duration,
                    phase_on_comp=phase_on_comp,
                    component_aliases=component_aliases,
                    time_shifted=False,
                    offset_ot=offset_ot,
                    **reader_kwargs,
                )
            data_arr = get_np_array(
                self.traces, beamformer.network.stations,
                components=["N", "E", "Z"],
                n_samples=self.n_samples,
                component_aliases=self.component_aliases,
            )
            if data_arr is None:
                raise RuntimeError(
                    "relocate_beam found no waveforms for this event "
                    "(empty read window?); pass waveform_features or fix "
                    "the data_reader"
                )
            norm = np.std(data_arr, axis=(1, 2), keepdims=True)
            norm[norm == 0.0] = 1.0
            waveform_features = envelope(data_arr / norm,
                                         device=beamformer.device)
            if features_starttime is None and len(self.traces) > 0:
                features_starttime = float(self.traces[0].stats.starttime)

        if uncertainty_method == "spatial":
            src_idx, time_idx, column = beamformer.beam_peak(
                waveform_features, out_of_bounds=out_of_bounds)
            peak = float(column[src_idx])
        elif uncertainty_method == "temporal":
            beamformer.backproject(
                waveform_features, reduce="max",
                out_of_bounds=out_of_bounds,
            )
            maxbeam = np.asarray(beamformer.maxbeam)
            time_idx = int(np.argmax(maxbeam))
            src_idx = int(beamformer.maxbeam_sources[time_idx])
            peak = float(maxbeam[time_idx])
        else:
            raise ValueError(
                f"unknown uncertainty_method {uncertainty_method!r} "
                "(expected 'spatial' or 'temporal')"
            )

        sr = self.sr or beamformer.data.sr
        # with relative-to-first moveouts the beam peaks at the FIRST
        # arrival; shift back to the true origin time and restore absolute
        # travel times, as find_detections does
        mv_to_tt = 0.0
        if (beamformer.moveouts_relative_to_first
                and hasattr(beamformer.travel_times, "moveout_to_tt")):
            mv_to_tt = float(
                np.asarray(beamformer.travel_times.moveout_to_tt)[src_idx]
            )
        if features_starttime is not None:
            self.origin_time = _to_datetime64(
                utc_from_epoch(
                    features_starttime + time_idx / sr - mv_to_tt
                )
            )
        src = beamformer.source_coordinates
        self.longitude = float(src["longitude"][src_idx])
        self.latitude = float(src["latitude"][src_idx])
        self.depth = float(src["depth"][src_idx])

        if uncertainty_method == "spatial":
            domain = beamformer._rectangular_domain(
                self.longitude, self.latitude,
                side_km=restricted_domain_side_km,
            )
            likelihood = beamformer._likelihood(column)
            lik_domain = likelihood[domain]
        else:
            # Gibbs weights on the min-max-normalized max beam, so that
            # effective_kT / gibbs_cutoff are scale-free
            lik_t = beamformer._likelihood(maxbeam)
            gibbs = np.exp(-(1.0 - lik_t) / effective_kT)
            sel = gibbs > gibbs_cutoff
            domain = np.asarray(beamformer.maxbeam_sources)[sel]
            likelihood = gibbs
            lik_domain = gibbs[sel]
        beamformer.likelihood = likelihood
        hunc, vunc = beamformer._compute_location_uncertainty(
            self.longitude, self.latitude, self.depth, lik_domain, domain
        )
        self.set_aux_data(
            {"hmax_unc": hunc, "hmin_unc": hunc, "vmax_unc": vunc,
             "az_hmax_unc": 0.0, "maxbeam_reloc": peak}
        )

        # arrival-time table from the relocated source's moveouts
        # (+ moveout_to_tt converts relative-to-first moveouts back to
        # absolute travel times)
        tts = (np.asarray(beamformer.moveouts[src_idx], np.float64) / sr
               + mv_to_tt)
        columns = {}
        for p, ph in enumerate(beamformer.phases):
            ph = str(ph).upper()
            columns[f"{ph}_tt_sec"] = tts[:, p].astype(np.float32)
            columns[f"{ph}_abs_arrival_times"] = _arrivals(
                self.origin_time, tts[:, p])
        self.arrival_times_table = PickTable(beamformer.network.stations,
                                             columns)
        return self

    # ------------------------------------------------------------------
    # HDF5 IO (schema-compatible with the reference)
    # ------------------------------------------------------------------
    def write(
        self,
        db_filename: str,
        db_path: str = "",
        save_waveforms: bool = False,
        gid: Optional[str] = None,
        hdf5_file=None,
    ):
        """Write the event to HDF5 (reference schema,
        BPMF/dataset.py:2899-3012)."""
        import h5py

        where = os.path.join(db_path, db_filename)
        close = hdf5_file is None
        f0 = hdf5_file or h5py.File(where, mode="a")
        try:
            if gid is not None:
                if str(gid) in f0:
                    del f0[str(gid)]
                f = f0.create_group(str(gid))
            else:
                f = f0
                for key in list(f.keys()):
                    del f[key]
            attrs = {
                "origin_time": str(self.origin_time),
                "latitude": self.latitude,
                "longitude": self.longitude,
                "depth": self.depth,
                "moveouts": self.moveouts_table(),
                "stations": np.asarray(self.stations).astype("S"),
                "components": np.asarray(self.components).astype("S"),
                "phases": np.asarray(self.phases).astype("S"),
                "where": self.where,
                "sampling_rate": self.sampling_rate,
                "id": self.id,
            }
            for k, v in attrs.items():
                if v is None:
                    continue
                f.create_dataset(k, data=v)

            def _h5safe(v):
                """numpy unicode -> bytes (h5py has no '<U' conversion)."""
                if hasattr(v, "to_numpy"):
                    v = v.to_numpy()
                if isinstance(v, np.ndarray) and v.dtype.kind == "U":
                    return v.astype("S")
                if isinstance(v, np.str_):
                    return str(v)
                return v

            if self.aux_data:
                g = f.create_group("aux_data")
                for k, v in self.aux_data.items():
                    if isinstance(v, dict):
                        gg = g.create_group(k)
                        for k2, v2 in v.items():
                            gg.create_dataset(k2, data=_h5safe(v2))
                    else:
                        g.create_dataset(k, data=_h5safe(v))
            for table_name in ("picks", "arrival_times"):
                if not hasattr(self, table_name):
                    continue
                table = getattr(self, table_name)
                g = f.create_group(table_name)
                g.create_dataset(
                    "stations", data=np.asarray(table.index).astype("S")
                )
                for column in table.columns:
                    data = table[column]
                    if data.dtype.kind == "M":
                        data = data.dt.strftime("%Y-%m-%d %H:%M:%S.%f %z")
                    if data.dtype == np.dtype("O"):
                        data = data.astype("S")
                    g.create_dataset(column, data=np.asarray(data))
            if save_waveforms and hasattr(self, "traces"):
                g = f.create_group("waveforms")
                for tr in self.traces:
                    sta, cha = tr.stats.station, tr.stats.channel
                    if sta not in g:
                        g.create_group(sta)
                    if cha not in g[sta]:
                        g[sta].create_dataset(cha, data=tr.data)
        finally:
            if close:
                f0.close()

    def update_aux_data_database(
        self, keys=None, filename: Optional[str] = None, db_path: str = "",
        gid: Optional[str] = None,
    ):
        """Write (some of) the aux data into the event's existing HDF5
        database in place (reference parity: BPMF/dataset.py:2813-2866,
        without the lock files: one writer per file)."""
        import h5py

        filename = filename or os.path.basename(
            getattr(self, "path_database", self.where)
        )
        gid = gid if gid is not None else getattr(self, "hdf5_gid", None)
        keys = list(keys) if keys is not None else list(self.aux_data.keys())
        with h5py.File(os.path.join(db_path, filename), "a") as f0:
            f = f0[str(gid)] if gid is not None else f0
            g = f.require_group("aux_data")
            for k in keys:
                if k in g:
                    del g[k]
                v = self.aux_data[k]
                if hasattr(v, "to_numpy"):
                    v = v.to_numpy()
                if isinstance(v, np.ndarray) and v.dtype.kind == "U":
                    v = v.astype("S")
                g.create_dataset(k, data=v)

    @classmethod
    def read_from_file(
        cls,
        filename: Optional[str] = None,
        db_path: str = "",
        hdf5_file=None,
        gid: Optional[str] = None,
        data_reader: Optional[Callable] = None,
    ):
        """Read an event from the reference HDF5 schema
        (BPMF/dataset.py:1144-1269).  Pick and arrival tables, when the
        file holds them, become pandas DataFrames (pandas imported then)."""
        import h5py

        close = False
        if filename is not None:
            parent = h5py.File(os.path.join(db_path, filename), mode="r")
            f = parent[str(gid)] if gid is not None else parent
            close = True
        else:
            f = hdf5_file
            parent = None

        def _str(x):
            return x.decode("utf-8") if isinstance(x, bytes) else str(x)

        try:
            origin_time = _str(f["origin_time"][()])
            moveouts = f["moveouts"][()]
            stations = f["stations"][()].astype("U")
            phases = f["phases"][()].astype("U")
            where = _str(f["where"][()])
            data_path, data_filename = os.path.split(where)
            kwargs = {}
            for opt in ("latitude", "longitude", "depth", "sampling_rate"):
                if opt in f:
                    kwargs[opt] = f[opt][()]
            if "components" in f:
                kwargs["components"] = f["components"][()].astype("U")
            if "id" in f:
                kwargs["id"] = _str(f["id"][()])
            aux_data = {}
            if "aux_data" in f:
                for k in f["aux_data"]:
                    node = f["aux_data"][k]
                    if isinstance(node, h5py.Group):
                        aux_data[k] = {k2: node[k2][()] for k2 in node}
                    else:
                        v = node[()]
                        aux_data[k] = _str(v) if isinstance(v, bytes) else v
            tables = {}
            for table_name in ("picks", "arrival_times"):
                if table_name not in f:
                    continue
                import pandas as pd

                tbl = {}
                for k in f[table_name]:
                    v = f[table_name][k][()]
                    if v.dtype.kind == "S":
                        v = v.astype("U")
                        if k != "stations":
                            v = pd.to_datetime(v, format="mixed")
                    tbl[k] = v
                tables[table_name] = pd.DataFrame(tbl).set_index("stations")
            waveforms = None
            sr = kwargs.get("sampling_rate")
            if "waveforms" in f:
                waveforms = Stream()
                for sta in f["waveforms"]:
                    for cha in f["waveforms"][sta]:
                        waveforms += Trace(
                            f["waveforms"][sta][cha][()],
                            station=sta,
                            channel=cha,
                            sampling_rate=float(sr) if sr is not None else 1.0,
                        )
        finally:
            if close:
                parent.close()

        kwargs["data_reader"] = data_reader
        event = cls(origin_time, moveouts, stations, phases,
                    data_filename, data_path, **kwargs)
        if "cov_mat" in aux_data:
            event.cov_mat = aux_data["cov_mat"]
        event.set_aux_data(aux_data)
        for name, df in tables.items():
            setattr(event, name, df)
        if waveforms is not None and len(waveforms) > 0:
            event.traces = waveforms
            if "n_samples" in aux_data and sr is not None:
                event.duration = float(aux_data["n_samples"]) / float(sr)
        if gid is not None:
            event.hdf5_gid = str(gid)
        if filename is not None:
            event.path_database = os.path.join(db_path, filename)
        return event

    def plot(self, **kwargs):
        """Waveform gallery with pick markers (reference:
        BPMF/dataset.py:3076-3240)."""
        from ..viz import plot_event

        return plot_event(self, **kwargs)

    def __repr__(self):
        return (
            f"Event(id={self.id}, ot={self.origin_time}, "
            f"lon={self.longitude}, lat={self.latitude}, dep={self.depth}, "
            f"{len(self.stations)} stations)"
        )


class Template(Event):
    """A template event: an Event with windowed waveforms and integer-sample
    moveouts keyed by the phase used on each component.

    Reference parity: BPMF/dataset.py:3243-4079.
    """

    @classmethod
    def init_from_event(cls, event: Event, attach_waveforms: bool = True):
        """Reference parity: BPMF/dataset.py:3321-3405."""
        db_path, db_filename = os.path.split(event.where)
        hypo = {k: getattr(event, k)
                for k in ("latitude", "longitude", "depth", "sampling_rate",
                          "components", "id")}
        template = cls(
            event.origin_time, event.moveouts_table(), event.stations,
            event.phases, db_filename, db_path, **hypo,
        )
        template.picks_table = event.picks_table
        template.arrival_times_table = event.arrival_times_table
        keep = [f"offset_{ph}" for ph in event.phases] + [
            "tid", "cov_mat", "Mw", "Mw_err", "hmax_unc", "hmin_unc",
            "vmax_unc", "az_hmax_unc",
        ]
        keep += [k for k in event.aux_data if k.startswith("phase_on_comp")]
        keep += [k for k in event.aux_data if k.startswith("snr")]
        aux = {k: event.aux_data[k] for k in keep if k in event.aux_data}
        if hasattr(event, "duration"):
            template.duration = event.duration
        else:
            template.duration = float(event.aux_data["n_samples"]) / event.sr
        if attach_waveforms:
            if not hasattr(event, "traces"):
                raise RuntimeError(
                    "call event.read_waveforms before init_from_event"
                )
            template.traces = event.traces
            template.set_availability()
        aux["n_samples"] = template.n_samples
        if "cov_mat" in aux:
            template.cov_mat = aux["cov_mat"]
        template.set_aux_data(aux)
        return template

    @classmethod
    def read_from_file(cls, filename, db_path="", gid=None, **kwargs):
        event = Event.read_from_file(filename, db_path=db_path, gid=gid)
        template = cls.init_from_event(event, attach_waveforms=False)
        if hasattr(event, "traces"):
            template.traces = event.traces
        template.id = str(template.aux_data.get("tid", template.id))
        template.where = os.path.join(db_path, filename)
        return template

    # ------------------------------------------------------------------
    @property
    def tid(self):
        return self.id

    @property
    def template_idx(self):
        return self.id

    @property
    def moveouts_win(self):
        """The windows' moveouts (each phase's moveout less its pre-pick
        offset) as the moveout DataFrame (pandas imported here; reference
        parity: BPMF/dataset.py:3464-3475)."""
        mv = self.moveouts.copy()
        for ph in self.phases:
            mv[f"moveouts_{ph.upper()}"] = (
                self.moveouts[f"moveouts_{ph.upper()}"]
                - self.aux_data[f"offset_{ph.upper()}"]
            )
        return mv

    @property
    def moveouts_arr(self) -> np.ndarray:
        """(n_stations, n_components) int samples: per component, the
        moveout of its phase (phase_on_comp) minus that phase's pre-pick
        offset.  Reference parity: BPMF/dataset.py:3451-3475."""
        table = self.moveouts_table()
        col = {p.upper(): i for i, p in enumerate(self.phases)}
        dtype = (table.dtype if np.issubdtype(table.dtype, np.floating)
                 else np.float64)
        out = np.empty((len(self.stations), len(self.components)), dtype)
        for j, cp in enumerate(self.components):
            ph = str(self.aux_data[f"phase_on_comp{cp}"]).upper()
            out[:, j] = table[:, col[ph]] - self.aux_data[f"offset_{ph}"]
        return sec_to_samp(out, sr=self.sr)

    def read_waveforms(self, stations=None, components=None):
        """Read template waveforms from the template's own HDF5 file.

        Reference parity: BPMF/dataset.py:3588-3649.
        """
        event = Event.read_from_file(filename=os.path.basename(self.where),
                                     db_path=os.path.dirname(self.where))
        if hasattr(event, "traces"):
            self.traces = event.traces
            for tr in self.traces:
                tr.stats.sampling_rate = self.sr
        return self

    def distance(self, longitude, latitude, depth) -> float:
        """Hypocentral distance (km) to a point."""
        from ..utils.geo import two_point_distance

        return float(
            two_point_distance(
                self.longitude, self.latitude, self.depth,
                longitude, latitude, depth,
            )
        )

    def find_monochromatic_traces(
        self, autocorr_peak_threshold: float = 0.33,
        num_peaks_criterion: int = 5,
    ) -> list:
        """Ids of the traces that look monochromatic (sensor glitches): at
        least `num_peaks_criterion` autocorrelation peaks above the
        threshold (reference parity: BPMF/dataset.py:3506-3585)."""
        from scipy.signal import find_peaks

        flagged = []
        for tr in self.traces:
            x = tr.data.astype(np.float64)
            if len(x) < 8 or np.allclose(x, 0):
                continue
            x = x - x.mean()
            ac = np.correlate(x, x, mode="full")[len(x) - 1:]
            if ac[0] <= 0:
                continue
            ac /= ac[0]
            peaks, _ = find_peaks(ac, height=autocorr_peak_threshold)
            if len(peaks) >= num_peaks_criterion:
                flagged.append(tr.id)
        return flagged

    def write(self, db_filename, db_path="", save_waveforms=True, **kwargs):
        super().write(db_filename, db_path=db_path,
                      save_waveforms=save_waveforms, **kwargs)

    # ------------------------------------------------------------------
    # the per-template detection database (reference:
    # BPMF/dataset.py:3703-3892); h5py is imported when these run
    # ------------------------------------------------------------------
    def read_catalog(
        self,
        filename: Optional[str] = None,
        db_path: str = "",
        extra_attributes=("cc", "n_dev"),
    ):
        """This template's detection file as a `data.Catalog` (reference
        parity: BPMF/dataset.py:3703-3850)."""
        from .catalog import Catalog

        filename = filename or f"detections_tp{self.tid}.h5"
        return Catalog.read_from_detection_file(
            filename, db_path=db_path,
            extra_attributes=tuple(extra_attributes) + ("tid",),
        )

    def write_detections(self, detections, filename=None, db_path=""):
        """Write this template's detections, one group per event."""
        import h5py

        filename = filename or f"detections_tp{self.tid}.h5"
        with h5py.File(os.path.join(db_path, filename), "a") as f:
            for ev in detections:
                ev.write(filename, db_path=db_path, gid=ev.id, hdf5_file=f)

    def write_summary(self, summary: Dict, filename=None, db_path=""):
        """Cache summary arrays (recurrence times, CC histories, ...)
        (reference parity: BPMF/dataset.py:3852-3892)."""
        import h5py

        filename = filename or f"summary_template{self.tid}.h5"
        with h5py.File(os.path.join(db_path, filename), "a") as f:
            for key, value in summary.items():
                if key in f:
                    del f[key]
                f.create_dataset(key, data=value)

    def read_summary(self, filename=None, db_path="") -> Dict:
        """The arrays of `write_summary` ({} without a file)."""
        filename = filename or f"summary_template{self.tid}.h5"
        path = os.path.join(db_path, filename)
        if not os.path.isfile(path):
            return {}
        import h5py

        with h5py.File(path, "r") as f:
            return {key: f[key][()] for key in f.keys()}

    def plot(self, **kwargs):
        """Waveform gallery (reference: BPMF/plotting_utils.py:23-124)."""
        from ..viz import plot_template

        return plot_template(self, **kwargs)

    def plot_recurrence_times(self, db_path: str = "", **kwargs):
        """Inter-detection times from this template's detection file
        (reference: BPMF/dataset.py:4003-4079)."""
        from ..viz import plot_recurrence_times

        cat = self.read_catalog(db_path=db_path)
        return plot_recurrence_times(cat, **kwargs)

    def plot_detection(self, idx_or_gid, filename: Optional[str] = None,
                       db_path: str = "", duration: float = 60.0,
                       phase_on_comp: Dict[str, str] = DEFAULT_PHASE_ON_COMP,
                       offset_ot: float = 10.0, data_reader=None, **kwargs):
        """Plot one detection from this template's detection file: read
        the event group, fetch its waveforms in picking mode, and render
        the gallery (reference parity: BPMF/dataset.py:3896-4000).

        `idx_or_gid`: integer position in the (sorted) group list, or the
        group name itself."""
        import h5py

        from ..viz import plot_event

        filename = filename or f"detections_tp{self.tid}.h5"
        path = os.path.join(db_path, filename)
        with h5py.File(path, "r") as f:
            gids = sorted(f.keys())
        gid = (str(idx_or_gid) if str(idx_or_gid) in gids
               else gids[int(idx_or_gid)])
        ev = Event.read_from_file(path, gid=gid)
        ev.data_reader = data_reader or self.data_reader
        ev.read_waveforms(
            duration, phase_on_comp=phase_on_comp, time_shifted=False,
            offset_ot=offset_ot,
        )
        return plot_event(ev, **kwargs)

    def __repr__(self):
        return (
            f"Template(tid={self.tid}, ot={self.origin_time}, "
            f"lon={self.longitude}, lat={self.latitude}, dep={self.depth})"
        )
