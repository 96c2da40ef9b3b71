"""Event and Template containers with HDF5 IO.

Copy of the parts of `seismic_bpmf_tpu.data.events` that the day scans and
the P/S picking use (reference parity: `Event`, BPMF/dataset.py:1052-3240,
and `Template`, BPMF/dataset.py:3243-4079), with the same on-disk HDF5
schema.  Moveouts are stored as a numpy array aligned to `stations`, and
picks as an `ops.picks.PickTable`; the pandas tables `moveouts` and
`picks` are built only when they are read, with pandas imported there.
h5py is imported inside the functions that do file IO.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np

from ..utils.observe import logger
from ..utils.time import epoch_from_utc, sec_to_samp, utc_from_epoch
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
        self.picks_table = None
        self._picks_df = None

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

    # ------------------------------------------------------------------
    def set_aux_data(self, aux_data: Dict):
        self.aux_data.update(aux_data)

    def set_components(self, components):
        self.components = np.asarray(list(components)).astype("U")

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

    # ------------------------------------------------------------------
    # picking
    # ------------------------------------------------------------------
    @property
    def picks(self):
        """The picks of `pick_PS_phases` (or of the event's file) as a
        pandas DataFrame indexed by station, built from `picks_table` on
        first access (pandas is imported here).  No attribute before a
        pick."""
        if self._picks_df is None:
            if self.picks_table is None:
                raise AttributeError("picks")
            self._picks_df = self.picks_table.to_frame()
        return self._picks_df

    @picks.setter
    def picks(self, value):
        self._picks_df = value

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
        self.picks_table, self._picks_df = table, None
        return table

    # ------------------------------------------------------------------
    # methods that reach modules not ported yet
    # ------------------------------------------------------------------
    def relocate(self, *args, **kwargs):
        raise NotImplementedError(
            "Event.relocate is not ported yet (ROADMAP Queue 1 #16)"
        )

    relocate_NLLoc = relocate
    relocate_beam = relocate

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
        template._picks_df = event._picks_df
        if hasattr(event, "arrival_times"):
            template.arrival_times = event.arrival_times
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

    def write(self, db_filename, db_path="", save_waveforms=True, **kwargs):
        super().write(db_filename, db_path=db_path,
                      save_waveforms=save_waveforms, **kwargs)

    def write_detections(self, detections, filename=None, db_path=""):
        """Write this template's detections, one group per event."""
        import h5py

        filename = filename or f"detections_tp{self.tid}.h5"
        with h5py.File(os.path.join(db_path, filename), "a") as f:
            for ev in detections:
                ev.write(filename, db_path=db_path, gid=ev.id, hdf5_file=f)

    def __repr__(self):
        return (
            f"Template(tid={self.tid}, ot={self.origin_time}, "
            f"lon={self.longitude}, lat={self.latitude}, dep={self.depth})"
        )
