"""Event and template group containers: the batch arrays of a family or a
template bank.

Counterpart of `seismic_bpmf_tpu.data.groups` (reference parity:
`Family`/`EventGroup`, BPMF/dataset.py:4082-4373, `TemplateGroup`,
BPMF/dataset.py:4376-5353, and `Stack`, BPMF/dataset.py:5356-5677) without
pandas.  They assemble the dense arrays the kernels and the stacking
consume:

  moveouts_arr  : (n, n_stations, n_components) int32 samples
  waveforms_arr : (n, n_stations, n_components, n_samples) float32

`TemplateGroup.from_arrays` builds a group straight from these arrays
(and the bank's metadata) and `TemplateGroup.from_group` reads them off
another group object, so a bank made elsewhere (by the JAX package, for
one) can be carried over.

The inter-template tables (distances, directional errors, ellipsoid
separations, CC) are plain numpy (n_tp, n_tp) arrays whose rows and
columns follow `tids`; `table_at(table, tid_i, tid_j)` reads one entry by
template id.  The JAX package keeps the same numbers in DataFrames.

`EventGroup.SVDWF_stack` stacks every (station, component) panel of a
family in one batched SVD on `device` (`utils.stacking.svdwf_panels`);
`Stack.pick_PS_phases_family_mode` returns a `PickTable`, as
`Event.pick_PS_phases` does, and skips only the members that have no data
to read (an error of the picker or of the device propagates).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..ops.picks import PickTable
from ..utils.geo import two_point_distance
from ..utils.time import sec_to_samp, utc_from_epoch
from .events import (
    DEFAULT_OFFSET_PHASE, DEFAULT_PHASE_ON_COMP, Event, Template,
    _to_datetime64,
)
from .network import Network
from .waveforms import get_np_array

# what a family member without data raises when it is picked: its reader
# finds no file or no channel (OSError, KeyError), its window is empty (its
# array is None: TypeError) or too short (ValueError, IndexError)
MEMBER_WITHOUT_DATA = (OSError, KeyError, TypeError, ValueError, IndexError)


def _normalized(arr: np.ndarray, method: str) -> np.ndarray:
    if method == "rms":
        norm = np.std(arr, axis=-1, keepdims=True)
    elif method == "max":
        norm = np.max(np.abs(arr), axis=-1, keepdims=True)
    else:
        raise ValueError("method must be 'rms' or 'max'")
    norm[norm == 0.0] = 1.0
    return arr / norm


class EventGroup:
    """A set of events aligned on a common network (stacking input).

    Reference parity: BPMF/dataset.py:4082-4373.
    """

    def __init__(self, events: Sequence[Event], network: Network):
        self.events = list(events)
        self.network = network

    @property
    def n_events(self):
        return len(self.events)

    @property
    def components(self):
        return list(self.network.components)

    @property
    def stations(self):
        return self.network.stations

    def get_moveouts_arr(self) -> np.ndarray:
        """(n_ev, n_sta, n_comp) int32 samples (phase-on-component, S where
        an event names none)."""
        mv = np.zeros(
            (self.n_events, len(self.stations), len(self.components)),
            np.int32,
        )
        for e, ev in enumerate(self.events):
            table = ev.moveouts_table()
            row = {s: i for i, s in enumerate(ev.stations)}
            col = {p.upper(): i for i, p in enumerate(ev.phases)}
            for c, cp in enumerate(self.components):
                ph = str(ev.aux_data.get(f"phase_on_comp{cp}", "S")).upper()
                if ph not in col:
                    raise KeyError(f"moveouts_{ph}")
                for s, sta in enumerate(self.stations):
                    if sta in row:
                        mv[e, s, c] = sec_to_samp(
                            float(table[row[sta], col[ph]]), sr=ev.sr)
        return mv

    def read_waveforms(self, duration: float, **kwargs) -> "EventGroup":
        """Read every event's time-shifted windows; kwargs go to
        `Event.read_waveforms` (offset_phase, phase_on_comp, ...)."""
        for ev in self.events:
            ev.read_waveforms(duration, **kwargs)
        return self

    def get_waveforms_arr(self, **kwargs) -> np.ndarray:
        arrs = [
            get_np_array(ev.traces, self.stations,
                         components=self.components,
                         n_samples=ev.n_samples, verbose=False)
            for ev in self.events
        ]
        n = min(a.shape[-1] for a in arrs)
        self.waveforms_arr = np.stack([a[..., :n] for a in arrs])
        return self.waveforms_arr

    def normalize(self, method: str = "rms"):
        """Normalize each event's waveforms (rms or max) in the batch
        array."""
        self.waveforms_arr = _normalized(self.waveforms_arr, method)
        self._normalize_method = method

    def set_network(self, network: Network):
        """Re-target the group onto a new (e.g. subset) Network, rebuilding
        the batch array and re-applying its normalization (reference
        parity: BPMF/dataset.py:4172-4203)."""
        self.network = network
        if hasattr(self, "waveforms_arr"):
            self.get_waveforms_arr()
            if getattr(self, "_normalize_method", None):
                self.normalize(self._normalize_method)
        return self

    def SVDWF_stack(
        self,
        freqmin: float,
        freqmax: float,
        sampling_rate: float,
        expl_var: float = 0.4,
        max_singular_values: int = 5,
        generator=None,
        device=None,
    ) -> "Stack":
        """SVD-Wiener-filtered stack -> `Stack`, every panel that is not
        all zeros in one batched SVD on `device` (CUDA unless 'cpu' is
        asked for).  Reference parity: BPMF/dataset.py:4275-4373."""
        from ..utils.stacking import stack_panels

        if not hasattr(self, "waveforms_arr"):
            self.get_waveforms_arr()
        stacked = stack_panels(
            self.waveforms_arr, device=device, expl_var=expl_var,
            max_singular_values=max_singular_values, freqmin=freqmin,
            freqmax=freqmax, sampling_rate=sampling_rate,
            generator=generator)
        stack = Stack(
            stacked,
            self.stations,
            self.components,
            sampling_rate=sampling_rate,
            phases=self.events[0].phases,
            moveouts=self.events[0].moveouts_table(),
        )
        stack.events = self.events
        return stack


class Stack(Event):
    """An Event wrapping stacked traces (reference:
    BPMF/dataset.py:5356-5677)."""

    def __init__(
        self,
        waveforms: np.ndarray,
        stations,
        components,
        sampling_rate: float,
        phases=("P", "S"),
        moveouts: Optional[np.ndarray] = None,
    ):
        if moveouts is None:
            moveouts = np.zeros((len(stations), len(phases)), np.float32)
        super().__init__(
            np.datetime64("now", "ns"),
            np.asarray(moveouts, np.float32),
            stations,
            phases,
            sampling_rate=sampling_rate,
            components=components,
        )
        from .stream import Stream, Trace

        self.traces = Stream()
        for s, sta in enumerate(stations):
            for c, cp in enumerate(components):
                self.traces += Trace(
                    waveforms[s, c],
                    station=str(sta),
                    channel=f"HH{cp}",
                    sampling_rate=sampling_rate,
                )
        self.duration = waveforms.shape[-1] / sampling_rate
        # the full stacked windows: read_waveforms slices from them
        self.stacked_traces = self.traces

    def read_waveforms(
        self,
        duration: float,
        phase_on_comp=DEFAULT_PHASE_ON_COMP,
        offset_phase=DEFAULT_OFFSET_PHASE,
        time_shifted: bool = True,
        offset_ot: float = 10.0,
        **kwargs,
    ):
        """Slice phase windows from the stacked traces (reference parity:
        BPMF/dataset.py:5451-5523): the stacked channel of component `c`
        starts `offset_<PH>` seconds (aux data, else the default pre-pick
        offset) before its phase arrival.  `time_shifted=True` moves each
        window to the new `offset_phase`; `time_shifted=False` starts every
        window `offset_ot` seconds before the origin time.  Samples outside
        the stack are zeros."""
        from .stream import Stream, Trace

        if not hasattr(self, "stacked_traces"):
            self.stacked_traces = self.traces
        sr = self.sr
        n = int(sec_to_samp(duration, sr=sr))
        table = self.moveouts_table()
        row = {s: i for i, s in enumerate(self.stations)}
        col = {p.upper(): i for i, p in enumerate(self.phases)}
        out = Stream()
        for sta in self.stations:
            for cp in self.components:
                ph = str(phase_on_comp[cp]).upper()
                orig_off = float(self.aux_data.get(
                    f"offset_{ph}", DEFAULT_OFFSET_PHASE[ph]
                ))
                mv = float(table[row[sta], col[ph]])
                if time_shifted:
                    rel = orig_off - float(offset_phase[ph])
                else:
                    rel = orig_off - mv - float(offset_ot)
                src = self.stacked_traces.select(station=str(sta),
                                                 component=cp)
                if not src:
                    continue
                x = np.asarray(src[0].data)
                k0 = int(sec_to_samp(rel, sr=sr))
                seg = np.zeros(n, np.float32)
                a0, a1 = max(0, k0), min(len(x), k0 + n)
                if a1 > a0:
                    seg[a0 - k0:a1 - k0] = x[a0:a1]
                out += Trace(seg, station=str(sta), channel=f"HH{cp}",
                             sampling_rate=sr)
        self.traces = out
        self.duration = duration
        self.set_aux_data({
            f"offset_{str(p).upper()}": float(offset_phase[p])
            for p in offset_phase
        })
        self.set_availability(stations=self.stations)
        return self

    def set_arrival_times_from_moveouts(self, offset_ot: float = 0.0):
        """Shift the origin by `offset_ot`, then fill the arrival times
        from the moveouts (reference parity: BPMF/dataset.py:5447-5449)."""
        if offset_ot:
            self.origin_time = _to_datetime64(utc_from_epoch(
                self.origin_time_epoch + float(offset_ot)
            ))
        return super().set_arrival_times_from_moveouts()

    def pick_PS_phases_family_mode(
        self,
        duration: float,
        picker,
        threshold_P: float = 0.60,
        threshold_S: float = 0.60,
        **kwargs,
    ) -> Optional[PickTable]:
        """Pick each member event attached by `EventGroup.SVDWF_stack` and
        combine the picks: per station and phase, the probability-weighted
        mean pick, the weighted spread across members as its uncertainty
        and the largest probability (reference parity:
        BPMF/dataset.py:5524-5677).  Sets and returns `picks_table`, float64
        columns {P,S}_{picks,unc,probas} (NaN where no member picked); None
        when no member was picked.

        A member is skipped when it has no waveforms and no reader, or when
        reading or picking it raises one of `MEMBER_WITHOUT_DATA` (the JAX
        package skips a member on any exception, which would hide a fault
        of the picker or the device)."""
        if not hasattr(self, "events"):
            raise RuntimeError("no member events attached to this Stack")
        member_picks = []
        for ev in self.events:
            if not hasattr(ev, "traces") and ev.data_reader is None:
                continue
            try:
                member_picks.append(ev.pick_PS_phases(
                    duration, picker, threshold_P=threshold_P,
                    threshold_S=threshold_S, **kwargs,
                ))
            except MEMBER_WITHOUT_DATA:
                continue
        if not member_picks:
            return None
        stations = [str(s) for s in self.stations]
        rows = [{str(s): i for i, s in enumerate(p.stations)}
                for p in member_picks]
        columns = {}
        for ph in ("P", "S"):
            means, uncs, probas = [], [], []
            for sta in stations:
                vals, ws = [], []
                for p, row in zip(member_picks, rows):
                    i = row.get(sta)
                    if i is not None and not np.isnan(p[f"{ph}_picks"][i]):
                        vals.append(float(p[f"{ph}_picks"][i]))
                        ws.append(float(p[f"{ph}_probas"][i]))
                if vals:
                    vals, ws = np.asarray(vals), np.asarray(ws)
                    m = float(np.sum(vals * ws) / ws.sum())
                    means.append(m)
                    uncs.append(float(np.sqrt(
                        np.sum(ws * (vals - m) ** 2) / ws.sum())))
                    probas.append(float(ws.max()))
                else:
                    means.append(np.nan)
                    uncs.append(np.nan)
                    probas.append(np.nan)
            columns[f"{ph}_picks"] = np.asarray(means, np.float64)
            columns[f"{ph}_unc"] = np.asarray(uncs, np.float64)
            columns[f"{ph}_probas"] = np.asarray(probas, np.float64)
        self.picks_table = PickTable(stations, columns)
        return self.picks_table


class TemplateGroup:
    """The matched-filter-side fleet container."""

    def __init__(self, templates: Sequence[Template], network: Network):
        self.templates = list(templates)
        self.network = network
        self.tids = np.asarray([tp.tid for tp in self.templates])
        # tid -> position in the bank
        self.tindexes = {tid: i for i, tid in enumerate(self.tids)}

    @classmethod
    def read_from_files(cls, filenames: Sequence[str], network: Network,
                        db_path: str = "") -> "TemplateGroup":
        templates = [
            Template.read_from_file(os.path.basename(fn),
                                    db_path=os.path.dirname(fn) or db_path)
            for fn in filenames
        ]
        return cls(templates, network)

    @classmethod
    def from_arrays(
        cls,
        waveforms_arr,
        moveouts_arr,
        tids,
        stations,
        components=("N", "E", "Z"),
        sampling_rate: float = 25.0,
        phases=("P", "S"),
        moveouts_sec=None,
        locations=None,
        origin_times=None,
        network: Optional[Network] = None,
        cov_mats=None,
        uncertainties=None,
    ) -> "TemplateGroup":
        """A group holding the given bank.

        waveforms_arr (n_tp, n_sta, n_comp, L) and moveouts_arr
        (n_tp, n_sta, n_comp) int samples, aligned to `stations` and
        `components`; moveouts_sec (n_tp, n_sta, n_phases) per-template
        phase moveouts in seconds (the Events a detection builds carry
        them); locations (n_tp, 3) longitude, latitude, depth;
        origin_times (n_tp,) datetime64 or epoch seconds; cov_mats a
        sequence of (3, 3) location covariances or None per template;
        uncertainties a sequence of dicts with 'hmax_unc' / 'vmax_unc' (km)
        or None per template."""
        waveforms_arr = np.asarray(waveforms_arr, np.float32)
        moveouts_arr = np.asarray(moveouts_arr, np.int32)
        n_tp, n_sta, n_comp, L = waveforms_arr.shape
        stations = np.asarray(stations).astype("U")
        if moveouts_arr.shape != (n_tp, n_sta, n_comp) or len(stations) != n_sta:
            raise ValueError("waveforms_arr, moveouts_arr and stations "
                             "disagree on the bank's shape")
        if moveouts_sec is None:
            moveouts_sec = np.zeros((n_tp, n_sta, len(phases)), np.float32)
        if network is None:
            network = Network.from_arrays(stations, components=components)
        templates = []
        for i in range(n_tp):
            lon, lat, dep = (locations[i] if locations is not None
                             else (None, None, None))
            tp = Template(
                origin_times[i] if origin_times is not None else 0.0,
                np.asarray(moveouts_sec[i]), stations, phases,
                latitude=None if lat is None else float(lat),
                longitude=None if lon is None else float(lon),
                depth=None if dep is None else float(dep),
                sampling_rate=float(sampling_rate), components=components,
                id=str(tids[i]),
            )
            tp.duration = L / float(sampling_rate)
            tp.set_aux_data({"tid": tids[i], "n_samples": L})
            if cov_mats is not None and cov_mats[i] is not None:
                tp.cov_mat = np.asarray(cov_mats[i], float)
                tp.set_aux_data({"cov_mat": tp.cov_mat})
            if uncertainties is not None and uncertainties[i]:
                tp.set_aux_data(dict(uncertainties[i]))
            templates.append(tp)
        group = cls(templates, network)
        group._waveforms_arr = waveforms_arr
        group._moveouts_arr = moveouts_arr
        return group

    @classmethod
    def from_group(cls, other) -> "TemplateGroup":
        """Carry a bank over from another group object: this package's or
        the JAX package's `TemplateGroup`, read through the attributes both
        have.  Taken across: `waveforms_arr`, `moveouts_arr`, `tids`, the
        stations and components, and per template the sampling rate,
        phases, moveouts in seconds, location, origin time and, where
        present, `cov_mat` and the `hmax_unc` / `vmax_unc` aux data (which
        the directional errors read).  Arrays are copied as numpy; nothing
        of the other object is kept."""
        stations = [str(s) for s in other.stations]
        mv_sec, covs, uncs = [], [], []
        for tp in other.templates:
            if hasattr(tp, "moveouts_at"):
                mv_sec.append(np.asarray(tp.moveouts_at(stations)))
            else:  # a station-indexed table
                mv_sec.append(np.asarray(tp.moveouts.loc[stations].values))
            cov = getattr(tp, "cov_mat", None)
            if cov is None:
                cov = tp.aux_data.get("cov_mat")
            covs.append(None if cov is None else np.asarray(cov, float))
            uncs.append({k: float(tp.aux_data[k])
                         for k in ("hmax_unc", "vmax_unc")
                         if tp.aux_data.get(k) is not None})
        first = other.templates[0]
        return cls.from_arrays(
            np.array(other.waveforms_arr, np.float32),
            np.array(other.moveouts_arr, np.int32),
            [tp.tid for tp in other.templates], stations,
            components=tuple(str(c) for c in other.components),
            sampling_rate=float(first.sr),
            phases=tuple(str(p) for p in first.phases),
            moveouts_sec=np.stack(mv_sec),
            locations=np.array([[tp.longitude, tp.latitude, tp.depth]
                                for tp in other.templates], float),
            origin_times=[tp.origin_time for tp in other.templates],
            cov_mats=covs, uncertainties=uncs,
        )

    # ------------------------------------------------------------------
    @property
    def n_templates(self):
        return len(self.templates)

    @property
    def stations(self):
        return self.network.stations

    @property
    def components(self):
        return list(self.network.components)

    @property
    def moveouts_arr(self) -> np.ndarray:
        """(n_tp, n_sta, n_comp) int32 samples aligned to the network."""
        if hasattr(self, "_moveouts_arr"):
            return self._moveouts_arr
        stations = list(self.stations)
        mv = np.zeros((self.n_templates, len(stations),
                       len(self.components)), np.int32)
        for t, tp in enumerate(self.templates):
            row = {s: i for i, s in enumerate(tp.stations)}
            common = [s for s in stations if s in row]
            idx = [stations.index(s) for s in common]
            mv[t, idx, :] = tp.moveouts_arr[[row[s] for s in common]]
        self._moveouts_arr = mv
        return mv

    @property
    def waveforms_arr(self) -> np.ndarray:
        if hasattr(self, "_waveforms_arr"):
            return self._waveforms_arr
        self.read_waveforms()
        return self._waveforms_arr

    @property
    def availability_arr(self) -> np.ndarray:
        """(n_tp, n_sta, n_comp) bool: template channel has data."""
        return np.any(self.waveforms_arr != 0.0, axis=-1)

    @property
    def network_to_template_map(self) -> np.ndarray:
        """(n_tp, n_sta, n_comp) bool mask of channels present per template.

        Reference parity: BPMF/dataset.py:4977-5008.
        """
        return self.availability_arr

    def read_waveforms(self):
        arrs = []
        for tp in self.templates:
            if not hasattr(tp, "traces"):
                tp.read_waveforms()
            arrs.append(
                get_np_array(
                    tp.traces,
                    self.stations,
                    components=self.components,
                    n_samples=tp.n_samples,
                    verbose=False,
                )
            )
        n = min(a.shape[-1] for a in arrs)
        self._waveforms_arr = np.stack([a[..., :n] for a in arrs]).astype(
            np.float32
        )
        return self._waveforms_arr

    def normalize(self, method: str = "rms"):
        """Normalize each template channel (rms or max) in the batch
        array."""
        self._waveforms_arr = _normalized(self.waveforms_arr, method)
        self._normalize_method = method

    def set_network(self, network: Network):
        """Re-target the group onto a new (e.g. subset) Network: drop the
        cached arrays and tables, rebuild the waveforms against the new
        station list and re-apply the normalization (reference parity:
        BPMF/dataset.py:4172-4203)."""
        had_waveforms = hasattr(self, "_waveforms_arr")
        self.network = network
        for cache in ("_moveouts_arr", "_waveforms_arr", "_intertp_dist",
                      "_dir_errors", "_ellips_dist", "_intertemplate_cc"):
            self.__dict__.pop(cache, None)
        if had_waveforms:
            self.read_waveforms()
            if getattr(self, "_normalize_method", None):
                self.normalize(self._normalize_method)
        return self

    def set_network_to_template_map(self):
        """Build the per-template channel-presence map (reference parity:
        BPMF/dataset.py `set_network_to_template_map`; the
        `network_to_template_map` property holds it)."""
        _ = self.network_to_template_map

    def box(self, lon_min: float, lon_max: float, lat_min: float,
            lat_max: float) -> "TemplateGroup":
        """A new group of the templates located inside the geographic box
        (reference parity: BPMF/dataset.py `TemplateGroup.box`)."""
        kept = [
            tp for tp in self.templates
            if (tp.longitude is not None and tp.latitude is not None
                and lon_min <= tp.longitude <= lon_max
                and lat_min <= tp.latitude <= lat_max)
        ]
        return TemplateGroup(kept, self.network)

    def n_closest_stations(self, n: int, available_stations=None) -> dict:
        """{tid: the n closest stations} (reference parity:
        BPMF/dataset.py `TemplateGroup.n_closest_stations`)."""
        return {
            tp.tid: tp.n_closest_stations(n, available_stations)
            for tp in self.templates
        }

    def n_best_SNR_stations(self, n: int, available_stations=None) -> dict:
        """{tid: the n stations of best SNR}, the closest stations for a
        template whose SNR cannot be computed (no waveforms)."""
        for tp in self.templates:
            if not hasattr(tp, "_snr"):
                try:
                    tp.compute_snr()
                except (AttributeError, KeyError, ValueError):
                    pass
        return {
            tp.tid: (
                tp.n_best_SNR_stations(n, available_stations)
                if hasattr(tp, "_snr")
                else tp.n_closest_stations(n, available_stations)
            )
            for tp in self.templates
        }

    def read_catalog(self, db_path: str = "",
                     extra_attributes=("cc", "n_dev"), **kwargs):
        """The detection catalog of every template of the group, from the
        per-template detection files (reference parity: BPMF/dataset.py
        `TemplateGroup.read_catalog`); a template without a file adds
        nothing.  Sets and returns `catalog`, a `data.Catalog`."""
        from .catalog import Catalog

        cats = []
        for tp in self.templates:
            try:
                cats.append(tp.read_catalog(
                    db_path=db_path, extra_attributes=extra_attributes,
                    **kwargs,
                ))
            except (OSError, KeyError):
                continue
        if not cats:
            raise FileNotFoundError(
                f"no detection files under {db_path!r} for any template"
            )
        self.catalog = Catalog.concatenate(cats)
        return self.catalog

    def plot_detection(self, row_idx, db_path: str = "", **kwargs):
        """Plot one event of `self.catalog` via the template that
        detected it (reference parity: BPMF/dataset.py:5298-5353)."""
        if not hasattr(self, "catalog"):
            self.read_catalog(db_path=db_path)
        row = int(row_idx)
        tid = str(self.catalog["tid"][row])
        tp = self.templates[int(self.tindexes[tid])]
        ot = self.catalog["origin_time"][row]
        cat_tp = tp.read_catalog(db_path=db_path)
        idx = int(np.argmin(np.abs(cat_tp["origin_time"] - ot)))
        # detection groups are written under the event id
        # (Template.write_detections), carried as the event_id column
        return tp.plot_detection(str(cat_tp["event_id"][idx]),
                                 db_path=db_path, **kwargs)

    def plot_recurrence_times(self, db_path: str = "", **kwargs):
        """Recurrence times over the whole group's detections
        (reference parity: BPMF/dataset.py `plot_recurrence_times`)."""
        from ..viz import plot_recurrence_times

        if not hasattr(self, "catalog"):
            self.read_catalog(db_path=db_path)
        return plot_recurrence_times(self.catalog, **kwargs)

    # ------------------------------------------------------------------
    # inter-template similarity and dedup
    # ------------------------------------------------------------------
    def table_at(self, table: np.ndarray, tid_i, tid_j):
        """One entry of an (n_tp, n_tp) inter-template table by template
        ids (the tables' rows and columns follow `tids`)."""
        return table[self.tindexes[tid_i], self.tindexes[tid_j]]

    def _locations(self):
        return (np.array([tp.longitude for tp in self.templates], float),
                np.array([tp.latitude for tp in self.templates], float),
                np.array([tp.depth for tp in self.templates], float))

    @property
    def intertemplate_distances(self) -> np.ndarray:
        """(n_tp, n_tp) float64 hypocentral distances in km, a numpy array
        in `tids` order (read entries with `table_at`)."""
        if hasattr(self, "_intertp_dist"):
            return self._intertp_dist
        lon, lat, dep = self._locations()
        self._intertp_dist = np.asarray(two_point_distance(
            lon[:, None], lat[:, None], dep[:, None],
            lon[None, :], lat[None, :], dep[None, :],
        ), np.float64)
        return self._intertp_dist

    @property
    def directional_errors(self) -> np.ndarray:
        """(n_tp, n_tp) float32 numpy array in `tids` order: entry [i, j] is
        the 68 %-confidence half-length (km) of template i's
        location-uncertainty ellipsoid along the direction from template i
        to template j.

        Reference parity: BPMF/dataset.py:4594-4663 (`compute_dir_errors`),
        with the JAX package's divergence kept: direction vectors live in
        a consistent local km frame.  Templates without a `cov_mat` fall
        back to an isotropic ellipsoid from their hmax/vmax aux data, then
        to the reference's 15 km default."""
        if hasattr(self, "_dir_errors"):
            return self._dir_errors
        s_68_3df = 3.52  # 68 % chi^2 quantile, 3 degrees of freedom
        lon, lat, dep = self._locations()
        km_per_deg = 2.0 * np.pi * 6371.0 / 360.0
        xyz = np.stack([
            (lon - lon.mean()) * km_per_deg * np.cos(np.deg2rad(lat.mean())),
            (lat - lat.mean()) * km_per_deg,
            dep,
        ], axis=1)
        n = len(self.templates)
        errors = np.zeros((n, n), np.float32)
        for t, tp in enumerate(self.templates):
            u = xyz - xyz[t]
            norm = np.sqrt((u**2).sum(axis=1, keepdims=True))
            u = np.divide(u, norm, out=np.zeros_like(u), where=norm > 0)
            cov = getattr(tp, "cov_mat", None)
            if cov is None:
                cov = tp.aux_data.get("cov_mat")
            if cov is not None:
                cov_dir = np.abs(np.einsum("ji,jk,ki->i", u.T,
                                           np.asarray(cov, float), u.T))
                errors[t] = np.sqrt(s_68_3df * cov_dir)
            else:
                hunc = float(tp.aux_data.get("hmax_unc", 0.0) or 0.0)
                vunc = float(tp.aux_data.get("vmax_unc", 0.0) or 0.0)
                if hunc > 0.0 or vunc > 0.0:
                    errors[t] = np.sqrt(
                        (u[:, 0]**2 + u[:, 1]**2) * hunc**2
                        + u[:, 2]**2 * vunc**2
                    )
                else:
                    errors[t] = 15.0  # reference default (dataset.py:4658)
        self._dir_errors = errors
        return self._dir_errors

    @property
    def ellipsoid_distances(self) -> np.ndarray:
        """(n_tp, n_tp) numpy array in `tids` order: separation between two
        templates' uncertainty ellipsoids along the inter-template
        direction, negative when they overlap (reference parity:
        BPMF/dataset.py:4665-4688: distance minus both directional
        errors)."""
        if hasattr(self, "_ellips_dist"):
            return self._ellips_dist
        de = self.directional_errors
        self._ellips_dist = self.intertemplate_distances - de - de.T
        return self._ellips_dist

    # reference-name aliases (BPMF/dataset.py:4560-4688)
    @property
    def intertemplate_dist(self) -> np.ndarray:
        return self.intertemplate_distances

    @property
    def dir_errors(self) -> np.ndarray:
        return self.directional_errors

    @property
    def ellipsoid_dist(self) -> np.ndarray:
        return self.ellipsoid_distances

    def compute_intertemplate_dist(self):
        # distances feed both derived tables; drop them too
        for cache in ("_intertp_dist", "_dir_errors", "_ellips_dist"):
            self.__dict__.pop(cache, None)
        _ = self.intertemplate_distances

    def compute_dir_errors(self):
        # a stale separation table must not survive a refresh
        for cache in ("_dir_errors", "_ellips_dist"):
            self.__dict__.pop(cache, None)
        _ = self.directional_errors

    def compute_ellipsoid_dist(self, refresh_dir_errors: bool = True):
        """Recompute the ellipsoid-separation table; by default the
        directional errors are refreshed too (``refresh_dir_errors=False``
        reuses the cached ones, as the reference does)."""
        if refresh_dir_errors:
            self.__dict__.pop("_dir_errors", None)
        self.__dict__.pop("_ellips_dist", None)
        _ = self.ellipsoid_distances

    def compute_intertemplate_cc(
        self,
        distance_threshold: float = 5.0,
        n_stations: int = 10,
        max_lag: int = 10,
        device_step: int = 1,
        cache_file: Optional[str] = None,
        device=None,
    ) -> np.ndarray:
        """Pairwise max-lag-corrected template CC through
        `ops.matched_filter.matched_filter` on `device` (CUDA unless 'cpu'
        is asked for); returns an (n_tp, n_tp) float32 numpy array in `tids`
        order (read entries with `table_at`).

        For each template pair within `distance_threshold` (ellipsoid
        distance), slides template 2 across template 1's waveforms within
        +-`max_lag` samples and takes the weighted network CC maximum.
        `cache_file` caches the matrix in HDF5 keyed by a parameter hash
        (recomputed on any parameter or template-set change; h5py is
        imported then).  Reference parity: BPMF/dataset.py:4690-4932."""
        from ..ops.matched_filter import matched_filter as mf_op

        cache_key = None
        if cache_file is not None:
            import hashlib

            import h5py

            hsh = hashlib.sha1()
            hsh.update(np.asarray(
                [distance_threshold, n_stations, max_lag, device_step],
                np.float64).tobytes())
            hsh.update(",".join(map(str, self.tids)).encode())
            hsh.update(np.ascontiguousarray(self.moveouts_arr).tobytes())
            cache_key = f"cc_{hsh.hexdigest()[:16]}"
            if os.path.isfile(cache_file):
                with h5py.File(cache_file, "r") as f:
                    if cache_key in f:
                        self._intertemplate_cc = f[cache_key][()]
                        return self._intertemplate_cc

        n_tp = self.n_templates
        cc = np.zeros((n_tp, n_tp), np.float32)
        np.fill_diagonal(cc, 1.0)
        ell = self.ellipsoid_distances
        wf = self.waveforms_arr  # (n_tp, n_sta, n_comp, n_samp)
        mv = self.moveouts_arr
        for i in range(n_tp):
            close = np.flatnonzero(ell[i] <= distance_threshold)
            close = close[close > i]
            if close.size == 0:
                continue
            # template i's waveforms (padded) are the "data"; moveout
            # differences that leave it are masked by the engine
            data = np.pad(wf[i], ((0, 0), (0, 0), (max_lag, max_lag)))
            templates = wf[close]
            rel_mv = mv[close] - mv[i][None, ...]
            weights = np.any(templates != 0.0, axis=-1).astype(np.float32)
            norm = weights.sum(axis=(1, 2), keepdims=True)
            norm[norm == 0] = 1.0
            weights = weights / norm
            ccs = mf_op(templates, rel_mv + max_lag, weights, data,
                        step=device_step, device=device)  # (n_close, n_lags)
            cc_max = ccs.max(dim=1).values.cpu().numpy()
            cc[i, close] = cc_max
            cc[close, i] = cc_max
        if cache_key is not None:
            import h5py

            with h5py.File(cache_file, "a") as f:
                if cache_key in f:
                    del f[cache_key]
                f.create_dataset(cache_key, data=cc)
        self._intertemplate_cc = cc
        return self._intertemplate_cc

    @property
    def intertemplate_cc(self) -> np.ndarray:
        """The cached inter-template CC table, computed on the default
        device when there is none yet."""
        if not hasattr(self, "_intertemplate_cc"):
            self.compute_intertemplate_cc()
        return self._intertemplate_cc

    def remove_multiples(
        self,
        catalog: dict,
        dt_criterion: float = 3.0,
        distance_criterion: float = 5.0,
        similarity_criterion: float = 0.33,
        ranking_metric: str = "cc",
        device=None,
    ) -> dict:
        """Flag multi-template detections of the same event, keeping the
        detection with the highest `ranking_metric`.

        `catalog` is a dict of equal-length columns with 'origin_time'
        (epoch seconds), 'tid' and the ranking metric (the JAX package
        takes a DataFrame).  Sequential scan over the time-sorted catalog
        (a stable sort), as in the reference (BPMF/dataset.py:5130-5295).
        Returns the sorted columns as numpy arrays plus a boolean
        'unique_event'.  The CC criterion applies when the group holds a
        CC table or can compute one from its waveforms (on `device`)."""
        order = np.argsort(np.asarray(catalog["origin_time"], np.float64),
                           kind="stable")
        cat = {k: np.asarray(v)[order] for k, v in catalog.items()}
        n = len(order)
        unique = np.ones(n, dtype=bool)
        ell = self.ellipsoid_distances
        cc = getattr(self, "_intertemplate_cc", None)
        if cc is None:
            try:
                cc = self.compute_intertemplate_cc(device=device)
            except (OSError, KeyError):  # no waveforms to correlate
                cc = None
        times = cat["origin_time"].astype(np.float64)
        tids = cat["tid"]
        metric = cat[ranking_metric]
        known = self.tindexes
        i = 0
        while i < n:
            j = i + 1
            group = [i]
            while j < n and times[j] - times[group[-1]] <= dt_criterion:
                tid_i, tid_j = tids[group[0]], tids[j]
                both = tid_i in known and tid_j in known
                close = (
                    tid_i == tid_j
                    or (both and self.table_at(ell, tid_i, tid_j)
                        <= distance_criterion)
                    or (both and cc is not None
                        and self.table_at(cc, tid_i, tid_j)
                        >= similarity_criterion)
                )
                if close:
                    group.append(j)
                j += 1
            if len(group) > 1:
                best = group[int(np.argmax(metric[group]))]
                for g in group:
                    if g != best:
                        unique[g] = False
            i = group[-1] + 1
        cat["unique_event"] = unique
        return cat
