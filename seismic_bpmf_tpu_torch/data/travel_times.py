"""Travel-time table container.

Copy of `seismic_bpmf_tpu.data.travel_times.TravelTimes` without pandas:
the tables are ``{phase: {station: (n_sources,) array}}`` dictionaries in
station order, and the source coordinates a `SourceTable` of numpy
columns.  HDF5 file contract identical to the reference and to
pykonal-generated tables (BPMF/template_search.py:30-220): datasets
``tt_<PHASE>/<station>`` with per-source travel times (any grid shape,
flattened) and ``source_coordinates/{longitude,latitude,depth}``.  h5py is
imported inside the file-IO functions only.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from ..utils.time import sec_to_samp


class SourceTable:
    """Columns of per-source values (longitude, latitude, depth, ...) and
    their row labels `index`.  Built from a dict of arrays, a DataFrame or
    another SourceTable; ``table[name]`` is a numpy column."""

    def __init__(self, columns, index=None):
        if isinstance(columns, SourceTable):
            index = columns.index if index is None else index
            columns = columns.columns
        elif hasattr(columns, "to_numpy") and hasattr(columns, "index"):
            # a DataFrame: its columns and its row labels
            index = np.asarray(columns.index) if index is None else index
            columns = {c: columns[c].to_numpy() for c in columns.columns}
        self.columns: Dict[str, np.ndarray] = {
            k: np.asarray(v) for k, v in columns.items()}
        n = len(next(iter(self.columns.values()))) if self.columns else 0
        self.index = np.arange(n) if index is None else np.asarray(index)

    def __getitem__(self, name) -> np.ndarray:
        return self.columns[name]

    def __contains__(self, name) -> bool:
        return name in self.columns

    def __len__(self) -> int:
        return len(self.index)


class TravelTimes:
    """Reference parity: BPMF/template_search.py:30-220."""

    def __init__(self, tt_filename: str, tt_folder_path: str = ""):
        self.where = os.path.join(tt_folder_path, tt_filename)

    # ------------------------------------------------------------------
    @property
    def n_sources(self) -> int:
        return len(self.source_indexes)

    @property
    def phases(self):
        tts = self.tts
        return None if tts is None else list(tts)

    @property
    def source_coords(self):
        return self.source_coordinates

    # reference-name aliases (BPMF/template_search.py:57-80)
    @property
    def num_sources(self) -> int:
        return self.n_sources

    @property
    def tts(self):
        if hasattr(self, "travel_times"):
            return self.travel_times
        if hasattr(self, "travel_times_samp"):
            return self.travel_times_samp
        return None

    @staticmethod
    def _stations_of(table) -> list:
        """Station labels of a {phase: {station: ...}} table, in the order
        they first appear."""
        out = {}
        for stas in table.values():
            out.update(dict.fromkeys(stas))
        return list(out)

    # ------------------------------------------------------------------
    def read(
        self,
        phases: Sequence[str],
        source_indexes: Optional[np.ndarray] = None,
        read_coords: bool = False,
        stations: Optional[Sequence[str]] = None,
    ) -> "TravelTimes":
        import h5py

        tts = {}
        with h5py.File(self.where, mode="r") as fin:
            grid_shape = fin["source_coordinates"]["depth"].shape
            if source_indexes is None:
                self.source_indexes = np.arange(int(np.prod(grid_shape)))
            else:
                self.source_indexes = np.asarray(source_indexes)
            for ph in phases:
                tts[ph] = {}
                for sta in fin[f"tt_{ph}"].keys():
                    if stations is not None and sta not in stations:
                        continue
                    tts[ph][sta] = (
                        fin[f"tt_{ph}"][sta][()]
                        .reshape(-1)[self.source_indexes]
                        .astype("float32")
                    )
            self.travel_times = tts
            if read_coords:
                coords = {}
                for coord in fin["source_coordinates"].keys():
                    coords[coord] = (
                        fin["source_coordinates"][coord][()]
                        .reshape(-1)[self.source_indexes]
                    )
                self.source_coordinates = SourceTable(
                    coords, index=self.source_indexes)
        return self

    def convert_to_samples(self, sampling_rate: float,
                           remove_tt_seconds: bool = False):
        self.travel_times_samp = {
            ph: {sta: sec_to_samp(v, sr=sampling_rate)
                 for sta, v in stas.items()}
            for ph, stas in self.travel_times.items()
        }
        self.sampling_rate = sampling_rate
        if remove_tt_seconds:
            del self.travel_times
        return self

    def get_travel_times_array(
        self,
        units: str = "seconds",
        stations: Optional[Sequence[str]] = None,
        phases: Optional[Sequence[str]] = None,
        relative_to_first: bool = False,
    ) -> np.ndarray:
        """(n_sources, n_stations, n_phases) array; with `relative_to_first`
        the per-source earliest arrival is subtracted and kept in
        `self.moveout_to_tt` (for origin-time correction,
        BPMF/template_search.py:212-219)."""
        assert units in ("seconds", "samples")
        attr = (
            self.travel_times if units == "seconds"
            else self.travel_times_samp
        )
        if stations is None:
            stations = self._stations_of(attr)
        if phases is None:
            phases = list(attr)
        dtype = np.asarray(attr[phases[0]][stations[0]]).dtype
        tts = np.zeros((self.n_sources, len(stations), len(phases)),
                       dtype=dtype)
        for s, sta in enumerate(stations):
            for p, ph in enumerate(phases):
                tts[:, s, p] = attr[ph][sta]
        if relative_to_first:
            first = np.min(tts, axis=(1, 2), keepdims=True)
            tts = tts - first
            self.moveout_to_tt = first.squeeze()
            if units == "samples":
                self.moveout_to_tt = self.moveout_to_tt / self.sampling_rate
        return tts

    # ------------------------------------------------------------------
    @classmethod
    def from_arrays(cls, tts: dict, source_coordinates
                    ) -> "TravelTimes":
        """Build an in-memory table (no HDF5 file) with the same layout as
        `read(read_coords=True)`: the JAX package's travel-time
        dictionaries go in unchanged.

        tts : {phase: {station: (n_sources,) seconds}}
        source_coordinates : {'longitude','latitude','depth': (n_sources,)}
            (or a DataFrame / SourceTable with those columns)
        """
        self = cls("", "")
        self.travel_times = {
            ph: {s: np.asarray(v, np.float32) for s, v in stas.items()}
            for ph, stas in tts.items()
        }
        self.source_coordinates = SourceTable(source_coordinates)
        self.source_indexes = np.asarray(self.source_coordinates.index)
        return self

    @staticmethod
    def write_table(
        path: str,
        tts: dict,
        source_coordinates: dict,
    ):
        """Write a travel-time table in the reference HDF5 contract.

        tts : {phase: {station: (n_sources,) seconds}}
        source_coordinates : {'longitude','latitude','depth': (n_sources,)}
        """
        import h5py

        with h5py.File(path, "w") as f:
            g = f.create_group("source_coordinates")
            for k, v in source_coordinates.items():
                g.create_dataset(k, data=np.asarray(v))
            for ph, stations in tts.items():
                gp = f.create_group(f"tt_{ph}")
                for sta, v in stations.items():
                    gp.create_dataset(str(sta), data=np.asarray(v))


def grid_travel_times(
    source_longitudes,
    source_latitudes,
    source_depths,
    receiver_longitudes,
    receiver_latitudes,
    receiver_depths,
    vp_km_s: float = 6.0,
    vs_km_s: float = 3.45,
):
    """Homogeneous-velocity travel times (s), P and S, (n_sources,
    n_receivers) each: straight rays at `vp_km_s` and `vs_km_s`, for tests
    and quick starts (production tables come from an eikonal solver with
    the same HDF5 contract)."""
    from ..utils.geo import compute_distances

    d = compute_distances(
        source_longitudes, source_latitudes, source_depths,
        receiver_longitudes, receiver_latitudes, receiver_depths,
    )
    return d / vp_km_s, d / vs_km_s


def load_travel_times(path, phases, source_indexes=None,
                      return_coords=False, stations=None):
    """Function-level travel-time loader (BPMF/utils.py:590-659 API):
    ``{phase: {station: (n_sources,) seconds}}`` in sorted station order
    (the JAX package returns the same vectors as a DataFrame's cells); with
    `source_indexes`, the sources of those flat grid indexes, in grid
    order.  With `return_coords`, also their coordinates as a
    `SourceTable` indexed by the flat grid index."""
    import h5py

    with h5py.File(path, "r") as f:
        grid_shape = f["source_coordinates"]["depth"].shape
        mask = sel = None
        if source_indexes is not None:
            # a boolean-mask gather returns ascending unique grid order
            sel = np.unique(np.asarray(source_indexes))
            mask = np.zeros(grid_shape, dtype=bool)
            mask[np.unravel_index(sel, grid_shape)] = True

        def values(v):
            return v[mask].ravel() if mask is not None else v.ravel()

        sta_all = sorted({s for ph in phases for s in f[f"tt_{ph}"].keys()})
        rows = [s for s in sta_all if stations is None or s in stations]
        tts = {ph: {sta: values(f[f"tt_{ph}"][sta][()]) for sta in rows
                    if sta in f[f"tt_{ph}"]}
               for ph in phases}
        if return_coords:
            idx = (sel if sel is not None
                   else np.arange(int(np.prod(grid_shape))))
            coords = SourceTable(
                {c: values(f["source_coordinates"][c][()])
                 for c in f["source_coordinates"].keys()}, index=idx)
    if return_coords:
        return tts, coords
    return tts


def get_moveout_array(tts, stations, phases) -> np.ndarray:
    """(n_sources, n_stations, n_phases) seconds from `load_travel_times`'
    tables (``tts[phase][station]``; the JAX package's DataFrame reads the
    same way), ordered by `stations` and `phases` (BPMF/utils.py:563-588
    API)."""
    cols = np.stack(
        [np.asarray(tts[ph][sta], dtype=float)
         for sta in stations for ph in phases],
        axis=-1,
    )
    return cols.reshape(-1, len(stations), len(phases))
