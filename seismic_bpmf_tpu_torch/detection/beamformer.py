"""Backprojection detection engine.

Counterpart of `seismic_bpmf_tpu/detection/beamformer.py` (reference
parity: `Beamformer`, BPMF/template_search.py:398-1333).  The beam runs
through cached `ops.bp.BeamformPlan`s (the CUDA kernel on the card, its
plain version on the CPU), the detection threshold on the same device;
weight policies, detection extraction and the uncertainty integrals are
host numpy, as in the JAX package.
"""

from __future__ import annotations

import os
import zlib
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import Config, DEFAULT_CONFIG
from ..data.events import Event
from ..data.travel_times import SourceTable
from ..ops.bp import BeamformPlan, _precision_mode
from ..ops.picks import peak_candidates, suppress_peaks
from ..ops.thresholds import bp_detection_threshold
from ..parallel.mesh import mesh_device
from ..parallel.sharded import ShardedBeamformPlan
from ..utils.observe import GLOBAL_TIMER
from ..utils.time import sec_to_samp, utc_from_epoch

MAX_PLANS = 4  # device-resident plans kept per Beamformer


class Beamformer:
    """Holds data + network + phases + travel times; runs backprojection.

    `device` follows the package rule (CUDA unless 'cpu' is asked for);
    there is no engine knob.  With `mesh=` (`parallel.make_mesh`, axes
    'src' and 'time') the beam runs sharded over the mesh
    (`parallel.sharded.ShardedBeamformPlan`) and gathers on its first
    device.  `precision` keeps the JAX package's rung
    names ('highest', 'high', 'default') as error classes: every rung runs
    the f32 kernel."""

    def __init__(
        self,
        data=None,
        network=None,
        phases: Optional[Sequence[str]] = None,
        travel_times=None,
        moveouts_relative_to_first: bool = True,
        cfg: Config = DEFAULT_CONFIG,
        mesh=None,
        precision: str = "high",
        device=None,
    ):
        _precision_mode(precision)  # an unknown rung raises here
        self.device = mesh_device(mesh, device)
        self.data = data
        self.network = network
        self.phases = list(phases) if phases is not None else None
        self.travel_times = travel_times
        self.moveouts_relative_to_first = moveouts_relative_to_first
        self.cfg = cfg
        self.mesh = mesh
        self.precision = precision

    # ------------------------------------------------------------------
    @property
    def moveouts(self) -> np.ndarray:
        """(n_src, n_sta, n_ph) int-sample moveouts (reference:
        BPMF/template_search.py:444-454), cached: set_network/set_phases/
        set_travel_times invalidate."""
        key = (id(self.travel_times), tuple(self.stations),
               tuple(self.phases), self.moveouts_relative_to_first)
        cached = getattr(self, "_moveouts_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        mv = self.travel_times.get_travel_times_array(
            units="samples",
            stations=self.stations,
            phases=self.phases,
            relative_to_first=self.moveouts_relative_to_first,
        )
        self._moveouts_cache = (key, mv)
        return mv

    @property
    def stations(self):
        return self.network.stations

    @property
    def n_stations(self):
        return self.network.n_stations

    @property
    def n_phases(self):
        return len(self.phases)

    @property
    def n_sources(self):
        return self.travel_times.n_sources

    @property
    def num_sources(self):
        # reference-name alias (BPMF/template_search.py:478-483)
        return self.n_sources

    @property
    def source_coordinates(self) -> SourceTable:
        if hasattr(self, "_source_coordinates"):
            return self._source_coordinates
        return self.travel_times.source_coordinates

    def set_source_coordinates(self, source_coords):
        """Override the source-coordinate table (dict, DataFrame or
        SourceTable with longitude/latitude/depth); reference parity:
        BPMF/template_search.py:753-762."""
        self._source_coordinates = SourceTable(source_coords)

    # ------------------------------------------------------------------
    def set_data(self, data):
        self.data = data
        self.starttime = data.date

    def set_network(self, network):
        self.network = network
        self._moveouts_cache = None

    def set_phases(self, phases):
        self.phases = list(phases)
        self._moveouts_cache = None

    def set_travel_times(self, travel_times):
        self.travel_times = travel_times
        self._moveouts_cache = None

    def set_weights(self, weights_phases=None, weights_sources=None):
        if weights_phases is not None:
            self.weights_phases = np.asarray(weights_phases, np.float32)
        if weights_sources is not None:
            self.weights_sources = np.asarray(weights_sources, np.float32)

    # ------------------------------------------------------------------
    # source-weight policies (reference: template_search.py:763-949)
    # ------------------------------------------------------------------
    def _operational_stations(self) -> np.ndarray:
        if self.data is not None and hasattr(self.data,
                                             "availability_per_sta"):
            row = {s: i for i, s in
                   enumerate(self.data.availability_stations)}
            avail = np.asarray(self.data.availability_per_sta)
            return avail[[row[s] for s in self.stations]].astype(bool)
        return np.ones(self.n_stations, dtype=bool)

    def _weights_sources_closest(self, num_closest_stations: int):
        w = np.ones((self.n_sources, self.n_stations), np.float32)
        operational = self._operational_stations()
        mv = self.moveouts[:, operational, 0]
        k = min(mv.shape[1], num_closest_stations)
        if 0 < k < self.n_stations:
            cutoff = np.max(
                np.partition(mv, k - 1)[:, :k], axis=1, keepdims=True
            )
            w[self.moveouts[:, :, 0] > cutoff] = 0.0
        w[:, ~operational] = 0.0
        return w

    def _weights_sources_max_moveout(self, max_moveout):
        w = np.zeros((self.n_sources, self.n_stations), np.float32)
        operational = self._operational_stations()
        mv = np.min(self.moveouts, axis=-1)
        w[mv < max_moveout] = 1.0
        w[:, ~operational] = 0.0
        return w

    def _station_density_weights(
        self, cutoff_dist=None, lower_percentile=0.0, upper_percentile=100.0
    ):
        """Reference parity: BPMF/template_search.py:897-949."""
        dists = np.asarray(self.network.interstation_distances)
        if cutoff_dist is None:
            cutoff_dist = np.median(dists[dists != 0.0])
        w = 1.0 / np.sum(np.exp(-(dists**2) / cutoff_dist**2), axis=1)
        if lower_percentile > 0.0:
            w = np.clip(w, np.percentile(w, lower_percentile), w.max())
        if upper_percentile < 100.0:
            w = np.clip(w, w.min(), np.percentile(w, upper_percentile))
        return w.astype(np.float32)

    def set_weights_sources(
        self,
        n_min_stations: int = 0,
        normalize: bool = False,
        weight_station_density: bool = False,
        method: str = "closest_stations",
        **kwargs,
    ):
        if self.data is not None and hasattr(self.data, "traces"):
            self.data.set_availability(list(self.stations))
        if method == "closest_stations":
            w = self._weights_sources_closest(kwargs["num_closest_stations"])
        elif method == "max_moveout":
            w = self._weights_sources_max_moveout(kwargs["max_moveout"])
        else:
            raise ValueError(f"invalid method {method!r}")
        if n_min_stations > 0:
            n_per_src = np.sum(w > 0.0, axis=-1)
            w[n_per_src < n_min_stations, :] = 0.0
        if weight_station_density:
            w *= self._station_density_weights(
                cutoff_dist=kwargs.get("cutoff_dist"),
                lower_percentile=kwargs.get("lower_percentile", 0.0),
                upper_percentile=kwargs.get("upper_percentile", 100.0),
            )[None, :]
        if normalize:
            norm = w.sum(axis=1, keepdims=True)
            norm[norm == 0.0] = 1.0
            w = w / norm
        self.weights_sources = w

    # ------------------------------------------------------------------
    def _plan(self, n_samp: int, reduce: str, out_of_bounds: str):
        """The cached plan of these moveouts and weights.  The plan bakes
        in moveouts and both weight sets, so the key fingerprints their
        content: re-running set_weights* rebuilds, never reuses stale
        device tables.  A plan of the same content for another day length,
        reduction or policy shares the cached plan's tables
        (`BPTables.retimed`).  At most MAX_PLANS stay cached.  With a mesh
        the plans are `ShardedBeamformPlan`s, keyed the same way.  A build
        is a `bp_plan` stage."""
        moveouts = self.moveouts
        content = tuple(
            # the bytes in place: a 1M-source grid's moveouts are GBs
            zlib.crc32(memoryview(np.ascontiguousarray(a)).cast("B"))
            for a in (moveouts, self.weights_phases, self.weights_sources)
        )
        key = (reduce, out_of_bounds, n_samp, self.precision, content)
        plans = getattr(self, "_plans", {})
        if key in plans:
            plans[key] = plans.pop(key)
        else:
            same = [p.tables for k, p in plans.items() if k[4] == content]
            kw = dict(reduce=reduce, out_of_bounds=out_of_bounds,
                      precision=self.precision,
                      tables=same[-1] if same else None)
            with GLOBAL_TIMER.stage("bp_plan"):
                plans[key] = (
                    BeamformPlan(moveouts, self.weights_phases,
                                 self.weights_sources, n_samp,
                                 device=self.device, **kw)
                    if self.mesh is None else
                    ShardedBeamformPlan(moveouts, self.weights_phases,
                                        self.weights_sources, n_samp,
                                        self.mesh, **kw))
            while len(plans) > MAX_PLANS:
                plans.pop(next(iter(plans)))
            self._plans = plans
        return plans[key]

    def _check_weights(self):
        if not hasattr(self, "weights_phases"):
            raise RuntimeError("set weights_phases first (set_weights)")
        if not hasattr(self, "weights_sources"):
            raise RuntimeError("set weights_sources first")

    def backproject(
        self,
        waveform_features,
        reduce: str = "max",
        out_of_bounds: str = "strict",
    ):
        """Beamform the features (host array or device tensor, (n_sta,
        n_comp, n_samp)) over the source grid.

        Reference parity: BPMF/template_search.py:508-572.  reduce='max'
        sets and returns (maxbeam, maxbeam_sources) as host arrays;
        'none' sets and returns the (n_src, n_samp) beam."""
        self._check_weights()
        plan = self._plan(int(waveform_features.shape[-1]), reduce,
                          out_of_bounds)
        out = plan(waveform_features)
        if reduce == "max":
            self.maxbeam = out[0].cpu().numpy()
            self.maxbeam_sources = out[1].cpu().numpy()
            return self.maxbeam, self.maxbeam_sources
        self.beam = out.cpu().numpy()
        return self.beam

    def beam_peak(self, waveform_features, out_of_bounds: str):
        """The full (n_src, n_samp) beam of the features, kept on the
        device: (source, sample) of its first maximum in row-major order
        (numpy's `argmax` of the host beam) and the beam's column at that
        sample as a host array of n_src floats, the only part of the beam
        that leaves the device.  Relocation's spatial route (a 1M-source
        grid's beam of a minute is GBs)."""
        self._check_weights()
        plan = self._plan(int(waveform_features.shape[-1]), "none",
                          out_of_bounds)
        beam = plan(waveform_features)
        src, t = divmod(int(torch.argmax(beam)), beam.shape[1])
        column = beam[:, t].cpu().numpy()
        return src, t, column

    # ------------------------------------------------------------------
    def compute_detection_threshold(
        self, window_sec: float = 3600.0, overlap: float = 0.75,
        num_dev: Optional[float] = None,
    ) -> np.ndarray:
        """The max beam's detection threshold, on the device and back (the
        `bp_threshold` stage)."""
        if num_dev is None:
            num_dev = self.cfg.n_dev_bp_threshold
        window = int(sec_to_samp(window_sec, sr=self.data.sr))
        with GLOBAL_TIMER.stage("bp_threshold"):
            self.detection_threshold = bp_detection_threshold(
                self.maxbeam, window, overlap=overlap, num_dev=num_dev,
                device=self.device,
            ).cpu().numpy()
        return self.detection_threshold

    def find_detections(
        self,
        detection_threshold,
        minimum_interevent_time: float,
        n_max_stations: Optional[int] = None,
        data_reader=None,
    ):
        """Peak-pick the max beam and build Events.

        Reference parity: BPMF/template_search.py:574-673.  The peaks
        (`detect_peaks`' two steps; meters `bp_peak_candidates`, the local
        maxima, and `bp_peaks_kept`, those the `mpd` suppression keeps) and
        their grouping are the `bp_peaks` stage.
        """
        detection_threshold = np.asarray(detection_threshold)
        if detection_threshold.ndim == 0:
            detection_threshold = np.full(
                len(self.maxbeam), float(detection_threshold), np.float32
            )
        self.detection_threshold = detection_threshold
        sr = self.data.sr
        min_iet = int(sec_to_samp(minimum_interevent_time, sr=sr))

        with GLOBAL_TIMER.stage("bp_peaks"):
            x, candidates = peak_candidates(self.maxbeam)
            peak_indexes = suppress_peaks(x, candidates, min_iet)
            GLOBAL_TIMER.add("bp_peak_candidates", float(len(candidates)))
            GLOBAL_TIMER.add("bp_peaks_kept", float(len(peak_indexes)))
            peak_indexes = peak_indexes[
                self.maxbeam[peak_indexes]
                > detection_threshold[peak_indexes]
            ]
            # keep the largest peak inside each group
            for i in range(len(peak_indexes)):
                lo = max(0, peak_indexes[i] - min_iet // 2)
                hi = min(peak_indexes[i] + min_iet // 2, len(self.maxbeam))
                idx = np.arange(lo, hi)
                upd = np.where(peak_indexes == peak_indexes[i])[0]
                peak_indexes[upd] = idx[np.argmax(self.maxbeam[idx])]
            peak_indexes = np.unique(peak_indexes)
        source_indexes = self.maxbeam_sources[peak_indexes]

        detections = []
        coords = self.source_coordinates
        data_path, data_filename = os.path.split(str(self.data.where))
        for i in range(len(peak_indexes)):
            src_pos = source_indexes[i]
            ot = self.data.date_epoch + peak_indexes[i] / sr
            mv = self.moveouts[src_pos].astype(np.float64) / sr
            if hasattr(self.travel_times, "moveout_to_tt"):
                ot = ot - float(self.travel_times.moveout_to_tt[src_pos])
                mv = mv + float(self.travel_times.moveout_to_tt[src_pos])
            if n_max_stations is not None and n_max_stations < len(mv):
                mv_max = np.sort(mv[:, 0])[n_max_stations - 1]
            else:
                mv_max = np.finfo(np.float32).max
            stations_in = np.asarray(self.stations)[mv[:, 0] <= mv_max]
            mv_in = mv[mv[:, 0] <= mv_max]
            event = Event(
                utc_from_epoch(ot),
                mv_in,
                stations_in,
                self.phases,
                data_filename,
                data_path,
                latitude=float(coords["latitude"][src_pos]),
                longitude=float(coords["longitude"][src_pos]),
                depth=float(coords["depth"][src_pos]),
                sampling_rate=sr,
                data_reader=data_reader or getattr(self.data, "data_reader",
                                                   None),
            )
            event.set_aux_data(
                {
                    "maxbeam": float(self.maxbeam[peak_indexes[i]]),
                    "source_index": int(coords.index[src_pos]),
                }
            )
            detections.append(event)

        self.peak_indexes = peak_indexes
        self.source_indexes = source_indexes
        return detections, peak_indexes, source_indexes

    # ------------------------------------------------------------------
    # maxbeam post-processing (reference: template_search.py:675-701,
    # 951-969, 1402-1415)
    # ------------------------------------------------------------------
    @staticmethod
    def _baseline(x: np.ndarray, window: int) -> np.ndarray:
        """Piecewise-linear curve through windowed minima."""
        from scipy.interpolate import interp1d

        n_windows = int(np.ceil(x.size / window))
        minima = np.zeros(n_windows, dtype=x.dtype)
        minima_args = np.zeros(n_windows, dtype=np.int64)
        for i in range(n_windows):
            seg = x[i * window : (i + 1) * window]
            minima_args[i] = i * window + int(np.argmin(seg))
            minima[i] = x[minima_args[i]]
        interpolator = interp1d(
            minima_args, minima, kind="linear", fill_value="extrapolate"
        )
        return interpolator(np.arange(x.size))

    def remove_baseline(self, window_sec: float, attribute: str = "maxbeam"):
        """Subtract the local-minima baseline (a crude high-pass)."""
        window = int(sec_to_samp(window_sec, sr=self.data.sr))
        x = getattr(self, attribute)
        setattr(self, attribute, x - self._baseline(x, window))

    def smooth_maxbeam(self, window_sec: float):
        """Gaussian smoothing of the max beam."""
        from scipy.ndimage import gaussian_filter1d

        window = int(sec_to_samp(window_sec, sr=self.data.sr))
        self.smoothed = gaussian_filter1d(self.maxbeam, window)
        return self.smoothed

    def return_pd_series(self, attribute: str = "maxbeam"):
        """Attribute as a time-indexed pandas Series (pandas is imported
        here)."""
        import pandas as pd

        x = getattr(self, attribute)
        index = pd.date_range(
            start=str(self.data.date),
            freq=pd.Timedelta(seconds=1.0 / self.data.sr),
            periods=len(x),
        )
        return pd.Series(data=x, index=index)

    @staticmethod
    def _likelihood(beam_volume: np.ndarray) -> np.ndarray:
        """Min-max normalized beam (reference:
        BPMF/template_search.py:498-506)."""
        rng = beam_volume.max() - beam_volume.min()
        if rng == 0:
            return np.zeros_like(beam_volume)
        lik = (beam_volume - beam_volume.min()) / rng
        return np.clip(lik, 0.0, 1.0)

    def plot_detection(self, detection, duration: float = 60.0,
                       offset_ot: float = 10.0, data_reader=None, **kwargs):
        """Waveform gallery of one detection over the day's max beam
        (reference parity: BPMF/template_search.py:1040-1133)."""
        from ..viz import plot_detection

        if not getattr(detection, "traces", None):
            detection.read_waveforms(
                duration, time_shifted=False, offset_ot=offset_ot,
                data_reader=data_reader or getattr(
                    self.data, "data_reader", None
                ),
            )
        if hasattr(self.data, "date_epoch"):
            detection._context_time = (
                detection.origin_time_epoch - self.data.date_epoch
            )
        return plot_detection(
            detection, context=getattr(self, "maxbeam", None),
            context_sr=self.data.sr, context_label="max beam", **kwargs,
        )

    def plot_maxbeam(self, detection_indices=None, **kwargs):
        """Max-beam time series with detections marked (reference parity:
        BPMF/template_search.py 'plot_maxbeam')."""
        from ..viz import plot_maxbeam

        return plot_maxbeam(self, detection_indices=detection_indices,
                            **kwargs)

    def plot_likelihood(self, beam_over_sources, ax=None, figsize=(10, 8),
                        **kwargs):
        """Source-grid likelihood map (min-max normalized beam) with the
        maximum marked (reference parity:
        BPMF/template_search.py:1135-1200)."""
        from ..viz.plots import _host, _plt

        lik = self._likelihood(_host(beam_over_sources))
        src = self.source_coordinates
        if ax is None:
            fig, ax = _plt().subplots(figsize=figsize)
        else:
            fig = ax.get_figure()
        sc = ax.scatter(
            src["longitude"], src["latitude"], c=lik,
            s=kwargs.pop("s", 8), cmap=kwargs.pop("cmap", "magma"),
            **kwargs,
        )
        best = int(np.argmax(lik))
        ax.plot(float(src["longitude"][best]),
                float(src["latitude"][best]), "*", color="C0",
                ms=14, mec="k")
        fig.colorbar(sc, ax=ax, label="likelihood")
        ax.set_xlabel("Longitude")
        ax.set_ylabel("Latitude")
        return fig

    def _rectangular_domain(self, lon0, lat0, side_km: float = 100.0):
        """Boolean mask of grid sources inside a `side_km` box centered at
        (`lon0`, `lat0`).

        Reference parity: BPMF/template_search.py:1232-1267 — except that
        the reference applies the cos(latitude) shrink factor to the
        latitude difference instead of the longitude difference (swapped
        conversion constants); here longitude degrees are scaled by
        cos(latitude) as geometry dictates.
        """
        r_earth_km = 6371.0
        km_per_deg = 2.0 * np.pi * r_earth_km / 360.0
        km_per_deg_lon = km_per_deg * np.cos(np.deg2rad(lat0))
        lons = self.source_coordinates["longitude"]
        lats = self.source_coordinates["latitude"]
        return (
            (np.abs(lons - lon0) * km_per_deg_lon < side_km / 2.0)
            & (np.abs(lats - lat0) * km_per_deg < side_km / 2.0)
        )

    def _compute_location_uncertainty(
        self, event_longitude, event_latitude, event_depth, likelihood,
        domain,
    ):
        """(horizontal, vertical) location uncertainty in km: the
        likelihood-weighted mean epicentral distance / |depth difference|
        from the event over the `domain` sources (boolean mask or index
        array).  Reference parity: BPMF/template_search.py:1269-1333."""
        from ..utils.geo import two_point_epicentral_distance

        src = self.source_coordinates
        lons = src["longitude"][domain]
        lats = src["latitude"][domain]
        deps = src["depth"][domain]
        likelihood = np.asarray(likelihood, np.float64)
        wsum = float(likelihood.sum())
        if wsum <= 0.0 or lons.size == 0:
            return float("inf"), float("inf")
        d_epi = two_point_epicentral_distance(
            event_latitude, event_longitude, lats, lons
        )
        hunc = float(np.sum(likelihood * d_epi) / wsum)
        vunc = float(np.sum(likelihood * np.abs(event_depth - deps)) / wsum)
        return hunc, vunc

    def location_uncertainty(self, beam_over_sources: np.ndarray):
        """Likelihood-weighted RMS distance from the argmax source.

        Reference parity: BPMF/template_search.py:1269-1333.
        """
        from ..utils.geo import two_point_distance

        lik = self._likelihood(beam_over_sources)
        best = int(np.argmax(beam_over_sources))
        src = self.source_coordinates
        d = two_point_distance(
            src["longitude"], src["latitude"], src["depth"],
            float(src["longitude"][best]),
            float(src["latitude"][best]),
            float(src["depth"][best]),
        )
        w = lik**2
        if w.sum() == 0:
            return np.inf
        w = w / w.sum()
        return float(np.sqrt(np.sum(w * d**2)))
