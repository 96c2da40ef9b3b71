"""Earthquake catalog container without pandas.

Counterpart of `seismic_bpmf_tpu.data.catalog.Catalog` (reference parity:
BPMF/dataset.py:298-854): an event table (longitude / latitude / depth /
origin_time + arbitrary extras) with constructors from Event lists,
column dicts and HDF5 detection databases.  The table is a dict of
equal-length numpy columns, `Catalog.catalog`, sorted by origin time (a
stable sort); `origin_time` is datetime64[ns].  Where the JAX package
takes or returns a DataFrame, this one takes or returns such a dict.
"""

from __future__ import annotations

import csv
import os
import re
from typing import Dict, Sequence

import numpy as np

from ..utils.geo import two_point_distance
from .events import Event

_BASE = ("longitude", "latitude", "depth", "origin_time")
_NUMBER = re.compile(r"[-+]?(\d+\.?\d*(e[-+]?\d+)?|\.\d+|nan|inf)", re.I)
class Catalog:
    def __init__(self, longitudes, latitudes, depths, origin_times,
                 **extra_fields):
        data = {
            "longitude": np.asarray(longitudes, dtype=np.float64),
            "latitude": np.asarray(latitudes, dtype=np.float64),
            "depth": np.asarray(depths, dtype=np.float64),
            "origin_time": np.array(
                [np.datetime64(str(t), "ns") for t in origin_times],
                dtype="datetime64[ns]"),
        }
        n = len(data["origin_time"])
        for k, v in extra_fields.items():
            v = np.asarray(v)
            if v.shape[:1] != (n,):
                raise ValueError(f"column {k!r} has {v.shape[:1]} rows, the "
                                 f"catalog {n}")
            data[k] = v
        order = np.argsort(data["origin_time"], kind="stable")
        self.catalog: Dict[str, np.ndarray] = {
            k: v[order] for k, v in data.items()}

    # ------------------------------------------------------------------
    @property
    def n_events(self) -> int:
        return len(self.catalog["origin_time"])

    @property
    def columns(self) -> list:
        return list(self.catalog)

    @property
    def origin_times_epoch(self) -> np.ndarray:
        return self.catalog["origin_time"].astype("int64") / 1e9

    # column accessors (reference parity: BPMF/dataset.py:343-358)
    @property
    def origin_time(self) -> np.ndarray:
        return self.catalog["origin_time"]

    @property
    def latitude(self) -> np.ndarray:
        return self.catalog["latitude"]

    @property
    def longitude(self) -> np.ndarray:
        return self.catalog["longitude"]

    @property
    def depth(self) -> np.ndarray:
        return self.catalog["depth"]

    def __len__(self):
        return self.n_events

    def __getitem__(self, key):
        return self.catalog[key]

    def event_count(self, start_date=None, end_date=None, freq: str = "1D",
                    offset: float = 0.0, trim_start: bool = True,
                    trim_end: bool = False, mode: str = "end"):
        """Binned seismicity rate: (bin times datetime64[ns], counts), the
        series of `utils.stats.event_count` over the origin times (read to
        the microsecond), as the JAX package's `Catalog.event_count` gives
        it.  The range defaults to the first event's day to the day after
        the last.  pandas is imported on call."""
        from ..utils.stats import event_count

        times = self.catalog["origin_time"]
        if len(times) == 0:
            raise ValueError("event_count on an empty catalog")
        if start_date is None:
            start_date = times.min().astype("datetime64[D]")
        if end_date is None:
            end_date = (times.max() + np.timedelta64(1, "D")
                        - np.timedelta64(1, "ns")).astype("datetime64[D]")
        s = event_count(np.datetime_as_string(times.astype("datetime64[us]")),
                        str(start_date), str(end_date), freq=freq,
                        offset=offset, trim_start=trim_start,
                        trim_end=trim_end, mode=mode)
        return (s.index.values.astype("datetime64[ns]"),
                s.values.astype(np.int64))

    # ------------------------------------------------------------------
    @classmethod
    def read_from_events(cls, events: Sequence[Event],
                         extra_attributes: Sequence[str] = (),
                         fill_value=np.nan) -> "Catalog":
        """Reference parity: BPMF/dataset.py:383-434."""
        base = {
            "longitudes": [ev.longitude for ev in events],
            "latitudes": [ev.latitude for ev in events],
            "depths": [ev.depth for ev in events],
            "origin_times": [ev.origin_time for ev in events],
        }
        extras: Dict[str, list] = {"event_id": [ev.id for ev in events]}
        for attr in extra_attributes:
            vals = []
            for ev in events:
                if hasattr(ev, attr):
                    vals.append(getattr(ev, attr))
                elif attr in ev.aux_data:
                    vals.append(ev.aux_data[attr])
                else:
                    vals.append(fill_value)
            extras[attr] = vals
        return cls(**base, **extras)

    @classmethod
    def from_columns(cls, columns: Dict) -> "Catalog":
        """A catalog from a dict of equal-length columns holding at least
        longitude, latitude, depth and origin_time (the JAX package's
        `read_from_dataframe`; reference parity: BPMF/dataset.py:436-458)."""
        extras = {k: v for k, v in columns.items() if k not in _BASE}
        return cls(columns["longitude"], columns["latitude"],
                   columns["depth"], columns["origin_time"], **extras)

    @classmethod
    def read_from_dataframe(cls, df) -> "Catalog":
        """A catalog from a pandas DataFrame with at least longitude,
        latitude, depth and origin_time columns (reference parity:
        BPMF/dataset.py:436-458); its columns become numpy arrays."""
        return cls.from_columns({c: df[c].to_numpy() for c in df.columns})

    @classmethod
    def read_from_detection_file(
        cls,
        filename: str,
        db_path: str = "",
        gid_pattern: str = "*",
        extra_attributes: Sequence[str] = ("cc", "n_dev", "tid"),
        return_events: bool = False,
    ):
        """Read every event group of an HDF5 detection database.

        Reference parity: BPMF/dataset.py:460-580."""
        import fnmatch

        import h5py

        events = []
        with h5py.File(os.path.join(db_path, filename), mode="r") as f:
            for gid in f.keys():
                if not fnmatch.fnmatch(gid, gid_pattern):
                    continue
                events.append(Event.read_from_file(hdf5_file=f[gid]))
        cat = cls.read_from_events(events, extra_attributes=extra_attributes)
        if return_events:
            return cat, events
        return cat

    @classmethod
    def concatenate(cls, catalogs: Sequence["Catalog"]) -> "Catalog":
        """Reference parity: BPMF/dataset.py:363-381.  A column that a
        catalog lacks is filled with NaN there."""
        names = []
        for c in catalogs:
            names += [k for k in c.catalog if k not in names]
        cols = {}
        for k in names:
            parts = [np.asarray(c.catalog[k]) if k in c.catalog
                     else np.full(c.n_events, np.nan) for c in catalogs]
            cols[k] = np.concatenate(parts)
        return cls.from_columns(cols)

    # ------------------------------------------------------------------
    def flag_multiples(self, dt_criterion: float = 3.0,
                       distance_criterion: float = 5.0) -> np.ndarray:
        """Time+distance multiples flag (single-template-free variant);
        sets and returns the boolean column 'unique_event'."""
        cat = self.catalog
        t = self.origin_times_epoch
        n = self.n_events
        unique = np.ones(n, dtype=bool)
        for i in range(n):
            if not unique[i]:
                continue
            j = i + 1
            while j < n and t[j] - t[i] <= dt_criterion:
                d = two_point_distance(
                    cat["longitude"][i], cat["latitude"][i], cat["depth"][i],
                    cat["longitude"][j], cat["latitude"][j], cat["depth"][j],
                )
                if d <= distance_criterion:
                    unique[j] = False
                j += 1
        self.catalog["unique_event"] = unique
        return unique

    def write(self, path: str):
        """The table as CSV, one column per key, origin_time as ISO
        strings."""
        names = self.columns
        with open(path, "w", newline="") as f:
            out = csv.writer(f)
            out.writerow(names)
            for i in range(self.n_events):
                out.writerow([str(self.catalog[k][i]) for k in names])

    @classmethod
    def read(cls, path: str) -> "Catalog":
        """A catalog written by `write`.  Columns of plain decimal numbers
        (or nan / inf) become float64, of True/False bool, the rest stay
        strings."""
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        names, rows = rows[0], rows[1:]
        cols = {}
        for j, k in enumerate(names):
            raw = [r[j] for r in rows]
            if k == "origin_time":
                cols[k] = raw
            elif raw and all(v in ("True", "False") for v in raw):
                cols[k] = np.array([v == "True" for v in raw])
            elif raw and all(_NUMBER.fullmatch(v) for v in raw):
                cols[k] = np.array(raw, dtype=np.float64)
            else:
                cols[k] = np.array(raw)
        return cls.from_columns(cols)

    # ------------------------------------------------------------------
    # plots (reference: BPMF/dataset.py:298-854 Catalog plot methods)
    # ------------------------------------------------------------------
    def plot_map(self, network=None, **kwargs):
        from ..viz import plot_catalog

        return plot_catalog(self, network=network, **kwargs)

    def plot_time_statistics(self, **kwargs):
        from ..viz import plot_time_statistics

        return plot_time_statistics(self, **kwargs)

    def plot_time_of_day(self, **kwargs):
        from ..viz import plot_time_of_day

        return plot_time_of_day(self, **kwargs)

    def plot_space_time(self, axis: str = "longitude", **kwargs):
        from ..viz import plot_space_time

        return plot_space_time(self, axis=axis, **kwargs)

    def plot_recurrence_times(self, tid=None, **kwargs):
        from ..viz import plot_recurrence_times

        return plot_recurrence_times(self, tid=tid, **kwargs)
