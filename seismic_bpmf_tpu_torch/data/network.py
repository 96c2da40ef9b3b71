"""Seismic network metadata.

Copy of `seismic_bpmf_tpu.data.network` that keeps the station table as
numpy arrays (no pandas).  File contract identical to the reference
(BPMF/dataset.py:109-129): a text file whose first line is
"<start_date> <end_date>", second line the component codes, followed by a
tab-separated table with columns including `station_code`,
`network_code`, `elevation_m`, `latitude`, `longitude`.
"""

from __future__ import annotations

import copy
import csv
import os
from typing import Dict, Optional

import numpy as np

from ..utils.geo import geodesic_distance_km


class Network:
    """Station metadata table (reference parity: BPMF/dataset.py:26-295)."""

    def __init__(self, network_file: str, network_path: str = ""):
        self.where = os.path.join(network_path, network_file)

    # ------------------------------------------------------------------
    @classmethod
    def from_arrays(cls, stations, components=("N", "E", "Z"),
                    networks=None, latitude=None, longitude=None,
                    elevation_m=None, depth_km=None, start_date=None,
                    end_date=None) -> "Network":
        """Build a Network from per-station arrays (missing coordinates are
        zeros; depth defaults to -elevation / 1000)."""
        net = cls.__new__(cls)
        net.where = "<memory>"
        stations = np.asarray(stations).astype("U")
        n = len(stations)

        def col(x, fill, dtype):
            return (np.full(n, fill, dtype) if x is None
                    else np.asarray(x, dtype).reshape(n))

        net._stations = stations
        net._networks = (np.full(n, "", "U8") if networks is None
                         else np.asarray(networks).astype("U"))
        net._latitude = col(latitude, 0.0, np.float64)
        net._longitude = col(longitude, 0.0, np.float64)
        net._elevation = col(elevation_m, 0.0, np.float64)
        net._depth = (-net._elevation / 1000.0 if depth_km is None
                      else col(depth_km, 0.0, np.float64))
        net.components = list(components)
        net.start_date = start_date
        net.end_date = end_date
        return net

    @classmethod
    def from_dataframe(cls, metadata, components=("N", "E", "Z"),
                       start_date=None, end_date=None) -> "Network":
        """Build a Network from a dataframe with columns stations, networks,
        latitude, longitude, elevation_m[, depth_km]."""

        def get(name):
            return (np.asarray(metadata[name]) if name in metadata.columns
                    else None)

        return cls.from_arrays(
            get("stations"), components=components,
            networks=get("networks"), latitude=get("latitude"),
            longitude=get("longitude"), elevation_m=get("elevation_m"),
            depth_km=get("depth_km"), start_date=start_date,
            end_date=end_date,
        )

    def read(self) -> "Network":
        with open(self.where, "r") as fin:
            line1 = fin.readline().strip().split()
            components = fin.readline().strip().split()
            rows = list(csv.DictReader(fin, delimiter="\t"))
        cols: Dict[str, list] = {}
        for row in rows:
            for k, v in row.items():
                cols.setdefault(k, []).append(v)
        net = Network.from_arrays(
            cols["station_code"], components=components,
            networks=cols.get("network_code"),
            latitude=np.asarray(cols["latitude"], np.float64),
            longitude=np.asarray(cols["longitude"], np.float64),
            elevation_m=np.asarray(cols["elevation_m"], np.float64),
            start_date=np.datetime64(line1[0]),
            end_date=np.datetime64(line1[1]),
        )
        net.where = self.where
        self.__dict__.update(net.__dict__)
        return self

    def write(self, path: Optional[str] = None):
        """Write the reference-format network file."""
        path = path or self.where
        with open(path, "w") as f:
            f.write(f"{self.start_date} {self.end_date}\n")
            f.write(" ".join(self.components) + "\n")
            f.write("station_code\tnetwork_code\tlatitude\tlongitude\t"
                    "elevation_m\n")
            for i in range(self.n_stations):
                f.write(f"{self._stations[i]}\t{self._networks[i]}\t"
                        f"{self._latitude[i]}\t{self._longitude[i]}\t"
                        f"{self._elevation[i]}\n")

    # ------------------------------------------------------------------
    @property
    def n_stations(self) -> int:
        return len(self.stations)

    @property
    def n_components(self) -> int:
        return len(self.components)

    @property
    def stations(self) -> np.ndarray:
        return self._stations

    @property
    def station_indexes(self) -> Dict[str, int]:
        return {s: i for i, s in enumerate(self._stations)}

    def stations_idx(self, stations):
        """Integer indexes of `stations` (str or sequence) in this network."""
        if isinstance(stations, str):
            stations = [stations]
        index = self.station_indexes
        return np.asarray([index[s] for s in stations], np.int64)

    @property
    def networks(self) -> np.ndarray:
        return self._networks

    @property
    def latitude(self) -> np.ndarray:
        return self._latitude

    @property
    def longitude(self) -> np.ndarray:
        return self._longitude

    @property
    def depth(self) -> np.ndarray:
        return self._depth

    @property
    def elevation(self) -> np.ndarray:
        return self._elevation

    def datelist(self) -> np.ndarray:
        """The days from `start_date` to `end_date`, both included, as
        datetime64[ns] (the JAX package's `pd.date_range` values)."""
        start = np.datetime64(str(self.start_date), "D")
        end = np.datetime64(str(self.end_date), "D")
        return np.arange(start, end + np.timedelta64(1, "D"),
                         np.timedelta64(1, "D")).astype("datetime64[ns]")

    # ------------------------------------------------------------------
    def box(self, lat_min, lat_max, lon_min, lon_max) -> "Network":
        """The stations strictly inside the geographic box."""
        sel = (
            (self.latitude > lat_min)
            & (self.latitude < lat_max)
            & (self.longitude > lon_min)
            & (self.longitude < lon_max)
        )
        return self.subset(list(self.stations[sel]), self.components, "keep")

    def subset(self, stations, components, method: str = "keep") -> "Network":
        sub = copy.deepcopy(self)
        stations = list(np.atleast_1d(stations))
        components = list(np.atleast_1d(components))
        if method == "keep":
            idx = self.stations_idx(stations)
            sub.components = components
        elif method == "discard":
            drop = set(stations)
            idx = np.asarray([i for i, s in enumerate(self._stations)
                              if s not in drop], np.int64)
            sub.components = [c for c in sub.components if c not in components]
        else:
            raise ValueError("method should be 'keep' or 'discard'")
        for name in ("_stations", "_networks", "_latitude", "_longitude",
                     "_elevation", "_depth"):
            setattr(sub, name, getattr(self, name)[idx])
        sub.__dict__.pop("_interstation_distances", None)
        return sub

    def plot_map(self, margin_deg: float = 0.2, **kwargs):
        """Station map (reference: BPMF/dataset.py:234-295)."""
        from ..viz import initialize_map

        return initialize_map(
            (float(self.longitude.min()) - margin_deg,
             float(self.longitude.max()) + margin_deg),
            (float(self.latitude.min()) - margin_deg,
             float(self.latitude.max()) + margin_deg),
            seismic_stations={
                "longitude": self.longitude,
                "latitude": self.latitude,
                "stations": list(self.stations),
            },
            **kwargs,
        )

    @property
    def interstation_distances(self) -> np.ndarray:
        """(n_sta, n_sta) hypocentral-style distances (km), rows and
        columns in station order."""
        cached = getattr(self, "_interstation_distances", None)
        if cached is not None and cached.shape[0] == self.n_stations:
            return cached
        d_epi = geodesic_distance_km(
            self.longitude[:, None], self.latitude[:, None],
            self.longitude[None, :], self.latitude[None, :],
        )
        self._interstation_distances = np.sqrt(
            d_epi**2 + (self.depth[:, None] - self.depth[None, :]) ** 2
        )
        return self._interstation_distances
