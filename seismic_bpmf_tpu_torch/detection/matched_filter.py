"""Matched-filter detection engine.

Counterpart of `seismic_bpmf_tpu/detection/matched_filter.py` (reference
parity: `MatchedFilter`, BPMF/similarity_search.py:22-1028).  The CC scan
runs through cached `ops.mf.MatchedFilterPlan`s (the CUDA kernel on the
card, its plain version on the CPU); the threshold and top-k candidate
extraction run on the same device (`ops.thresholds`); candidates are
refined, deduplicated and turned into Events on the host.
"""

from __future__ import annotations

import logging
import os
import weakref
import zlib
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config, DEFAULT_CONFIG
from ..data.events import Event
from ..ops.cf import scalar_kurtosis
from ..ops.host_ops import dedup_detection_indexes
from ..ops.mf import MatchedFilterPlan, pad_day_data
from ..ops.reference import GAUSSIAN_SAMPLE_LEN, matched_filter_at
from ..ops.thresholds import (
    _rms_plan, batch_candidates, detect_candidates, time_dependent_threshold,
)
from ..parallel.mesh import mesh_device
from ..parallel.sharded import ShardedMatchedFilterPlan, mf_layout, shard_day
from ..utils.observe import GLOBAL_TIMER
from ..utils.time import sec_to_samp, utc_from_epoch

logger = logging.getLogger("seismic_bpmf_tpu_torch.detection.matched_filter")


class MatchedFilter:
    """Runs the template-matching scan and extracts detections.

    `device` follows the package rule (CUDA unless 'cpu' is asked for);
    `rng` is the numpy Generator that draws the threshold zero-fill when
    no `white_noise` is passed.  `precision` keeps the JAX package's rung
    names: 'highest' and 'default' scan in f32, 'high' with every product
    split in bf16 parts on the tensor cores (`ops.mf`); 'screen' scans
    the bf16-rounded day, widens candidate extraction by `screen_margin`
    and recomputes every candidate's CC exactly (float64, host) before
    the threshold decision.  With `mesh=` (`parallel.make_mesh`, axes
    'tp' and 'time') the scan runs sharded over the mesh
    (`parallel.sharded.ShardedMatchedFilterPlan`) and the CC gathers on
    its first device, where the extraction runs."""

    def __init__(
        self,
        template_group,
        min_channels: int = 6,
        min_stations: int = 3,
        max_kurto: float = 100.0,
        remove_edges: bool = True,
        normalize: bool = True,
        max_CC_threshold: float = 0.80,
        threshold_type: str = "rms",
        step: Optional[int] = None,
        max_memory_gb: Optional[float] = None,
        anomalous_cdf_at_mean_plus_1sig: float = 0.0,
        window_for_validation_Tmax: float = 100.0,
        cfg: Config = DEFAULT_CONFIG,
        mesh=None,
        precision: str = "high",
        template_chunk: int = 256,
        screen_margin: float = 0.01,
        device=None,
        rng: Optional[np.random.Generator] = None,
    ):
        if precision not in ("highest", "high", "default", "screen"):
            raise ValueError(f"unknown precision {precision!r}")
        self.device = mesh_device(mesh, device)
        self.rng = rng if rng is not None else np.random.default_rng()
        self.template_group = template_group
        self.min_channels = min_channels
        self.min_stations = min_stations
        self.max_kurto = max_kurto
        self.remove_edges = remove_edges
        self.normalize = normalize
        self.max_CC_threshold = max_CC_threshold
        self.threshold_type = threshold_type.lower()
        self.step = step if step is not None else max(
            1, cfg.matched_filter_step_samp)
        self.max_memory_gb = max_memory_gb
        self.anomalous_cdf_at_mean_plus_1sig = anomalous_cdf_at_mean_plus_1sig
        self.window_for_validation_Tmax = window_for_validation_Tmax
        self.cfg = cfg
        self.mesh = mesh
        self.precision = precision
        self.screen_margin = float(screen_margin)
        # templates per plan (bounds the device-resident rows of one call)
        self.template_chunk = template_chunk

    def _scan(self, run, templates, moveouts, weights):
        """CC of the `run` templates through per-chunk plans cached across
        days: the template rows move to the device once per template set;
        only the day's data moves.  With a mesh, one
        `parallel.sharded.ShardedMatchedFilterPlan` scans the run, its
        template shards and the day's time shards over the mesh."""
        n_samp = self.data_arr.shape[-1]
        # the plans bake in template waveforms, moveouts AND channel
        # weights, so the cache key fingerprints their content
        content = (
            zlib.crc32(np.ascontiguousarray(templates).tobytes()),
            zlib.crc32(np.ascontiguousarray(moveouts).tobytes()),
            zlib.crc32(np.ascontiguousarray(weights).tobytes()),
        )
        key = (tuple(run.tolist()), n_samp, self.step, self.precision,
               content)
        plans = getattr(self, "_plans", {})
        # every plan shares one padded layout derived from the FULL bank,
        # so each day is padded and uploaded once
        pad_left, max_mv = self._bank_pad_overrides()
        chunk = self.template_chunk
        if key in plans:
            # true LRU: refresh recency on a hit
            plans[key] = plans.pop(key)
        else:
            with GLOBAL_TIMER.stage("mf_plan"):
                plans[key] = [
                    ShardedMatchedFilterPlan(
                        templates, moveouts, weights, n_samp, self.mesh,
                        precision=self._rung(), pad_left=pad_left,
                        max_moveout=max_mv)
                ] if self.mesh is not None else [
                    MatchedFilterPlan(
                        templates[i : i + chunk], moveouts[i : i + chunk],
                        weights[i : i + chunk], n_samp,
                        precision=self._rung(), pad_left=pad_left,
                        max_moveout=max_mv,
                        device=self.device,
                    )
                    for i in range(0, len(templates), chunk)
                ]
            # bound the device-resident plans across a campaign whose
            # weights drift: ~2 full bank sweeps' worth of plan sets
            n_keys = max(
                4,
                2 * -(-self.template_group.n_templates
                      // max(1, len(templates))),
            )
            while len(plans) > n_keys:
                plans.pop(next(iter(plans)))
            self._plans = plans
        first = plans[key][0]
        pad_key = (id(self.data_arr), n_samp, first.pad_left,
                   first.layout if self.mesh is not None else first.ext,
                   self._upload_dtype())
        if getattr(self, "_data_pad_key", None) == pad_key:
            data_pad = self._data_pad
        else:
            with GLOBAL_TIMER.stage("mf_upload"):
                data_pad = first.pad_data(self.data_arr,
                                          dtype=self._upload_dtype())
            self._data_pad, self._data_pad_key = data_pad, pad_key
        outs = []
        for plan in plans[key]:
            out = plan(data_pad)
            if self.step > 1:
                L = templates.shape[-1]
                out = out[:, :: self.step][:, : (n_samp - L) // self.step + 1]
            outs.append(out)
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    def _rung(self) -> str:
        """The kernel rung of the scan: 'screen' scans at 'default'."""
        return "default" if self.precision == "screen" else self.precision

    def _bank_pad_overrides(self):
        """(pad_left, max_moveout) of the FULL bank."""
        mv_bank = np.asarray(
            self.template_group.moveouts_arr
        ).reshape(self.template_group.n_templates, -1)
        return (int(-min(0, mv_bank.min(initial=0))),
                int(mv_bank.max(initial=0)))

    def _device_memory_gb(self) -> float:
        """Device memory in GB for the extraction-chunk bound (16 GB on
        the CPU, where it only sizes chunks)."""
        if self.device.type == "cuda":
            _, total = torch.cuda.mem_get_info(self.device)
            return total / 1024.0**3
        return 16.0

    def _extraction_chunk(self, n_templates: int) -> int:
        """Templates whose CC series may be device-resident at once.

        `max_memory_gb` keeps the reference semantics (GB divided by the
        per-template CC-row size, BPMF/similarity_search.py:726-807).
        Unset, a quarter of device memory holds the chunk's CC stack: the
        batched extraction makes a few stack-sized temporaries beside it."""
        row_gb = max(self.memory_cc_time_series_gb, 1e-9)
        if self.max_memory_gb is not None:
            chunk = max(1, int(self.max_memory_gb / row_gb))
            if chunk < 2 and n_templates >= 2:
                logger.warning(
                    "max_memory_gb=%.3g fits %d CC row(s) on device — "
                    "the batched extraction pipeline is disabled and "
                    "the scan runs per-template; raise max_memory_gb "
                    "(one row is %.3g GB)",
                    self.max_memory_gb, chunk, row_gb,
                )
            return chunk
        return max(1, int(self._device_memory_gb() / 4.0 / (4.0 * row_gb)))

    # ------------------------------------------------------------------
    @property
    def components(self):
        return self.template_group.components

    @property
    def stations(self):
        return self.template_group.stations

    @property
    def network(self):
        return self.template_group.network

    @property
    def memory_cc_time_series_gb(self) -> float:
        """Per-template CC-series size in GB (reference:
        BPMF/similarity_search.py:153-161)."""
        if not hasattr(self, "data"):
            return 0.0
        nbytes = 4 * int(self.data.duration / (self.step / self.data.sr))
        return nbytes / 1024.0**3

    # ------------------------------------------------------------------
    def _prepare_data_arr(self, data):
        """Host side of `set_data`: channel extraction + RMS normalization
        (reference: BPMF/similarity_search.py:163-185), the
        `mf_normalize` stage."""
        with GLOBAL_TIMER.stage("mf_normalize"):
            arr = data.get_np_array(
                self.stations, components=self.components
            ).astype(np.float32)
            norm = None
            if self.normalize:
                norm = np.std(arr, axis=-1, keepdims=True)
                norm[norm == 0.0] = 1.0
                arr = arr / norm
                norm = norm.squeeze(-1)
        return arr, norm

    def _upload_dtype(self) -> str:
        """`screen` ships the day as bf16 and casts back to f32 on the
        device; the other rungs ship f32."""
        return "bfloat16" if self.precision == "screen" else "float32"

    def preupload_day(self, data):
        """Prepare `data` for a later `set_data(data)`: normalize and start
        the padded device upload on the calling (prefetch) thread.  One
        day may be in flight at a time.  Its host seconds go to the
        `mf_set_data` stage of `utils.observe.GLOBAL_TIMER`, split into
        `mf_normalize` and `mf_upload`."""
        with GLOBAL_TIMER.stage("mf_set_data"):
            arr, norm = self._prepare_data_arr(data)
            bundle = {"arr": arr, "norm": norm, "ref": weakref.ref(data)}
            n_samp = int(arr.shape[-1])
            L = int(self.template_group.waveforms_arr.shape[-1])
            pad_left, max_mv = self._bank_pad_overrides()
            with GLOBAL_TIMER.stage("mf_upload"):
                if self.mesh is None:
                    pad_left, ext = MatchedFilterPlan.data_layout(
                        n_samp, L, pad_left, max_mv)
                    pad = pad_day_data(
                        arr, arr.shape[0] * arr.shape[1], n_samp, pad_left,
                        ext, dtype=self._upload_dtype(), device=self.device)
                else:
                    # the time shards on their devices, halos exchanged
                    grid = self.mesh.grid("tp", "time")
                    ext = mf_layout(n_samp, L, pad_left, max_mv,
                                    grid.shape[1])
                    pad = shard_day(arr, grid, ext,
                                    dtype=self._upload_dtype())
            bundle["pad"] = (
                pad, (id(arr), n_samp, pad_left, ext, self._upload_dtype()))
        pre = getattr(self, "_preloaded", None)
        if not isinstance(pre, dict):
            pre = {}
        pre = {k: b for k, b in pre.items() if b["ref"]() is not None}
        pre[id(data)] = bundle
        self._preloaded = pre
        return data

    def set_data(self, data):
        """Attach continuous data; RMS-normalize channels (reference:
        BPMF/similarity_search.py:163-185).  Consumes a pending
        `preupload_day(data)` bundle when one matches."""
        self.data = data
        self._data_pad, self._data_pad_key = None, None
        pre = getattr(self, "_preloaded", None)
        bundle = pre.pop(id(data), None) if isinstance(pre, dict) else None
        if bundle is not None and bundle["ref"]() is data:
            self.data_arr = bundle["arr"]
            if bundle["norm"] is not None:
                self.data_norm = bundle["norm"]
            self._data_pad, self._data_pad_key = bundle["pad"]
            return
        with GLOBAL_TIMER.stage("mf_set_data"):
            self.data_arr, norm = self._prepare_data_arr(data)
        if norm is not None:
            self.data_norm = norm

    # ------------------------------------------------------------------
    # channel-weight policies (reference: similarity_search.py:288-474)
    # ------------------------------------------------------------------
    def _apply_validity(self, weights: np.ndarray) -> np.ndarray:
        invalid = (
            np.sum(weights != 0.0, axis=(1, 2)) < self.min_channels
        ) | (
            np.sum(np.sum(weights, axis=2) > 0.0, axis=1) < self.min_stations
        )
        weights[invalid] = 0.0
        return weights

    def _operational(self) -> np.ndarray:
        """Template channels with data, and with data in the day when the
        day's availability is set (`Data.set_availability`)."""
        operational = self.template_group.availability_arr.copy()
        if hasattr(self.data, "availability_per_cha"):
            row = {s: i for i, s in
                   enumerate(self.data.availability_stations)}
            rows = [row[s] for s in self.stations]
            operational &= self.data.availability_per_cha[rows][None, ...]
        return operational

    def _weights_channels_simple(self):
        w = np.float32(self.template_group.network_to_template_map)
        return self._apply_validity(w)

    def _weights_channels_closest(self, num_closest_stations: int):
        tg = self.template_group
        w = np.ones((tg.n_templates, self.network.n_stations,
                     self.network.n_components), np.float32)
        operational = self._operational()
        op_sta = np.any(operational, axis=-1)
        mv = tg.moveouts_arr[..., 0].astype(np.int64)
        mv = np.where(op_sta, mv, np.iinfo(np.int32).max)
        k = min(mv.shape[1], num_closest_stations)
        if 0 < k < self.network.n_stations:
            cutoff = np.max(
                np.partition(mv, k - 1)[:, :k], axis=1, keepdims=True
            )
            w[tg.moveouts_arr[:, :, 0] > cutoff, :] = 0.0
        w[~operational] = 0.0
        return self._apply_validity(w)

    def _weights_channels_max_moveout(self, max_moveout_sec: float):
        tg = self.template_group
        sr = tg.templates[0].sr
        w = np.zeros((tg.n_templates, self.network.n_stations,
                      self.network.n_components), np.float32)
        operational = self._operational()
        op_sta = np.any(operational, axis=-1)
        mv = np.min(tg.moveouts_arr, axis=-1)
        valid = (mv < int(max_moveout_sec * sr)) & op_sta
        w[valid, :] = 1.0
        w[~operational] = 0.0
        return self._apply_validity(w)

    def set_weights_channels(
        self,
        n_min_stations: int = 0,
        normalize: bool = True,
        weight_station_density: bool = False,
        method: str = "simple",
        **kwargs,
    ):
        if method == "simple":
            w = self._weights_channels_simple()
        elif method == "closest_stations":
            w = self._weights_channels_closest(
                kwargs["num_closest_stations"]
            )
        elif method == "max_moveout":
            w = self._weights_channels_max_moveout(kwargs["max_moveout_sec"])
        else:
            raise ValueError(f"invalid method {method!r}")
        if n_min_stations > 0:
            n_sta = np.sum(np.any(w > 0.0, axis=-1), axis=1)
            w[n_sta < n_min_stations, :] = 0.0
        if weight_station_density:
            dists = self.network.interstation_distances
            cutoff = kwargs.get("cutoff_dist") or np.median(
                dists[dists != 0.0]
            )
            wd = 1.0 / np.sum(np.exp(-(dists**2) / cutoff**2), axis=1)
            w *= wd[None, :, None].astype(np.float32)
        if normalize:
            norm = w.sum(axis=(1, 2), keepdims=True)
            norm[norm == 0.0] = 1.0
            w = w / norm
        self.weights_channels = w

    # ------------------------------------------------------------------
    def compute_cc_time_series(self, tids=None):
        """CC series of (a subset of) the template bank, kept on the
        device as one stacked chunk (reference parity:
        BPMF/similarity_search.py:476-546)."""
        tg = self.template_group
        if tids is None:
            select = np.arange(tg.n_templates)
        else:
            select = np.asarray([tg.tindexes[t] for t in tids], np.int64)
        self.tids_subset = list(tg.tids[select])
        self._weights_arr = self.weights_channels[select]

        invalid = self._weights_arr.sum(axis=(1, 2)) == 0
        run = select[~invalid]
        self.cc = {}
        # drop any previous chunk's stack (a chunk with no valid template
        # would otherwise hand a stale one to the batched extraction)
        self._cc_stack = (None, None)
        if len(run) > 0:
            cc_sums = torch.nan_to_num(self._scan(
                run, tg.waveforms_arr[run], tg.moveouts_arr[run],
                self.weights_channels[run],
            ))
            self._cc_stack = ([tg.tids[t] for t in run], cc_sums)
            if not getattr(self, "_defer_rows", False):
                for i, t in enumerate(run):
                    self.cc[tg.tids[t]] = cc_sums[i]
        for t in select[invalid]:
            self.cc[tg.tids[t]] = np.zeros(1, np.float32)
        return self.cc

    # ------------------------------------------------------------------
    def select_cc_indexes(self, cc_t: np.ndarray, threshold: np.ndarray,
                          search_win: float) -> np.ndarray:
        """Above-threshold peak indexes, deduped within `search_win` and
        validated against the local CC CDF (reference parity:
        BPMF/similarity_search.py:187-286)."""
        sr = self.data.sr
        cc_idx = np.flatnonzero(cc_t > threshold - self._margin())
        cc_idx = dedup_detection_indexes(cc_idx, cc_t, search_win)

        if self.anomalous_cdf_at_mean_plus_1sig > 0.0 and len(cc_idx):
            window = int(
                1.0 / self.cfg.min_freq_hz * self.window_for_validation_Tmax
            )
            cc_1sig = threshold / self.cfg.n_dev_mf_threshold
            if self.threshold_type == "mad":
                cc_1sig = cc_1sig * 1.48
            valid = np.ones(len(cc_idx), dtype=bool)
            for i, idx in enumerate(cc_idx):
                lo = max(0, idx - window // 2)
                hi = lo + window
                if hi >= len(cc_t):
                    hi = len(cc_t) - 1
                    lo = hi - window
                half = (hi - lo) // 2
                cc1 = cc_t[lo : lo + half]
                cc2 = cc_t[lo + half : hi]
                frac = min(
                    np.mean(cc1 < cc_1sig[idx]) if len(cc1) else 1.0,
                    np.mean(cc2 < cc_1sig[idx]) if len(cc2) else 1.0,
                )
                if frac < self.anomalous_cdf_at_mean_plus_1sig:
                    valid[i] = False
            cc_idx = cc_idx[valid]

        if self.remove_edges and len(cc_idx):
            keep = self._inside_edges(cc_idx * self.step)
            cc_idx = cc_idx[keep]
        return cc_idx

    def _inside_edges(self, det: np.ndarray) -> np.ndarray:
        sr = self.data.sr
        lo = int(sec_to_samp(self.cfg.data_buffer_sec, sr=sr))
        hi = int(sec_to_samp(self.data.duration + self.cfg.data_buffer_sec,
                             sr=sr))
        return (det >= lo) & (det < hi)

    def _margin(self) -> float:
        """Candidate-extraction widening: nonzero only in screen mode."""
        return self.screen_margin if self.precision == "screen" else 0.0

    def _exact_cc_at(self, tid, tt, cc_idx) -> np.ndarray:
        """Exact network CC at the given CC indexes (float64 host compute,
        ~L*n_ch MACs per lag)."""
        tg = self.template_group
        t = self.tids_subset.index(tid)
        return matched_filter_at(
            tg.waveforms_arr[tt], tg.moveouts_arr[tt],
            self._weights_arr[t], self.data_arr, cc_idx, step=self.step,
        )

    @staticmethod
    def _dedup_sparse(cand, vals, search_win):
        """Sequential nearest-pair dedup on sparse candidates (same
        semantics as `ops.reference.dedup_detection_indexes`)."""
        keep = list(range(len(cand)))
        i = 1
        while i < len(keep):
            a, b = keep[i - 1], keep[i]
            if cand[b] - cand[a] < search_win:
                del keep[i - 1 if vals[b] > vals[a] else i]
            else:
                i += 1
        return np.asarray(keep, dtype=np.int64)

    MAX_CANDIDATES = 1024
    MAX_CANDIDATE_BLOCKS = 256

    def _batch_extract(self, white_noise, fetch: bool = True):
        """Threshold + top-k candidate extraction for every device CC row
        of the current chunk in one batch.  With ``fetch=False`` the work
        is only queued (`self._cand_pending`); `_batch_extract_collect`
        reads it later.  Returns the white-noise fill actually used."""
        self._cand_cache = {}
        self._cand_pending = None
        if self.anomalous_cdf_at_mean_plus_1sig > 0.0:
            return white_noise
        stack_tids, stack = getattr(self, "_cc_stack", (None, None))
        if (
            stack_tids is not None
            and stack.ndim == 2 and stack.shape[-1] > 1
            and set(stack_tids) <= set(self.tids_subset)
        ):
            dev_tids = list(stack_tids)
        else:
            dev_tids = [
                tid for tid, cc in self.cc.items()
                if isinstance(cc, torch.Tensor) and cc.ndim == 1
                and cc.shape[0] > 1
            ]
        if len(dev_tids) < 2:
            self._materialize_rows()
            return white_noise
        if white_noise is None and self.threshold_type != "rms":
            # (rms leaves None: the cached RmsExtractionPlan draws and
            # keys its fill once per geometry)
            n_noise = (int(stack.shape[-1]) if stack_tids == dev_tids
                       else int(self.cc[dev_tids[0]].shape[0]))
            white_noise = self.rng.normal(size=n_noise).astype(np.float32)
        sr = self.data.sr
        caps = np.array(
            [self.max_CC_threshold
             * self._weights_arr[self.tids_subset.index(tid)].sum()
             for tid in dev_tids],
            np.float32,
        )
        cc_in = (stack if stack_tids == dev_tids
                 else torch.stack([self.cc[tid] for tid in dev_tids]))
        swin = int(sec_to_samp(self.threshold_window_dur, sr=sr))
        eplan = None
        if self.threshold_type == "rms":
            # a fill we got FROM the last plan must not round-trip into the
            # cache key (it would mint a second entry per geometry)
            pkey = (int(cc_in.shape[-1]), swin, self.overlap,
                    self.MAX_CANDIDATES, self.MAX_CANDIDATE_BLOCKS)
            if (white_noise is getattr(self, "_rms_plan_noise", None)
                    and getattr(self, "_rms_plan_key", None) == pkey):
                eplan = self._rms_plan_obj
            else:
                eplan = _rms_plan(pkey[0], pkey[1], pkey[2], white_noise,
                                  pkey[3], pkey[4], device=self.device,
                                  rng=self.rng)
            self._rms_plan_obj = eplan
            self._rms_plan_key = pkey
            self._rms_plan_noise = eplan.white_noise
            if not eplan.supported:
                eplan = None
                if white_noise is None:
                    # one fill shared by the batch and any per-row rerun
                    white_noise = self.rng.normal(
                        size=GAUSSIAN_SAMPLE_LEN).astype(np.float32)
            else:
                white_noise = eplan.white_noise
        if eplan is not None:
            out = eplan.extract(cc_in, caps, self.cfg.n_dev_mf_threshold,
                                margin=self._margin(), pack=eplan.can_pack)
        else:
            out = batch_candidates(
                cc_in, caps, swin, self.cfg.n_dev_mf_threshold,
                overlap=self.overlap, white_noise=white_noise,
                k=self.MAX_CANDIDATES, k_blocks=self.MAX_CANDIDATE_BLOCKS,
                threshold_type=self.threshold_type, margin=self._margin(),
            )
        self._cand_pending = (dev_tids, eplan, out)
        if fetch:
            self._batch_extract_collect()
        return white_noise

    def _materialize_rows(self):
        """Per-tid CC rows for the paths that read them."""
        stack_tids, stack = getattr(self, "_cc_stack", (None, None))
        if stack_tids is not None:
            for i, tid in enumerate(stack_tids):
                if tid not in self.cc:
                    self.cc[tid] = stack[i]

    def _batch_extract_collect(self):
        """Fetch a queued `_batch_extract` result into `self._cand_cache`
        (the `mf_collect` stage: the wait for the device and the copy).
        Rows whose block bound failed stay uncached (the per-template
        path re-extracts them exactly); returns those tids."""
        if self._cand_pending is None:
            return []
        dev_tids, eplan, out = self._cand_pending
        self._cand_pending = None
        with GLOBAL_TIMER.stage("mf_collect"):
            if eplan is not None and not isinstance(out, tuple):
                idx, cc_vals, thr_vals, n_above, kurto, blocks_hit = (
                    eplan.unpack(out))
            else:
                idx, cc_vals, thr_vals, n_above, kurto, blocks_hit = (
                    a.cpu().numpy() for a in out)
        needs_rerun = []
        for j, tid in enumerate(dev_tids):
            if blocks_hit[j] > self.MAX_CANDIDATE_BLOCKS:
                needs_rerun.append(tid)
                continue
            self._cand_cache[tid] = (
                idx[j], cc_vals[j], thr_vals[j], int(n_above[j]),
                float(kurto[j]),
            )
        return needs_rerun

    def _candidates_device(self, tid, cc_dev, weights_t, white_noise,
                           max_candidates=4096):
        """Threshold + top-k candidates of one device row; only O(k)
        values reach the host.  Returns (cand_idx, cc_vals, thr_vals,
        kurto) sorted by lag, or None on candidate overflow."""
        cached = getattr(self, "_cand_cache", {}).pop(tid, None)
        if cached is not None:
            idx, cc_vals, thr_vals, n_above, kurto = cached
        else:
            sr = self.data.sr
            thr = time_dependent_threshold(
                cc_dev,
                int(sec_to_samp(self.threshold_window_dur, sr=sr)),
                self.cfg.n_dev_mf_threshold,
                overlap=self.overlap,
                threshold_type=self.threshold_type,
                white_noise=white_noise, rng=self.rng,
            )
            thr = torch.clamp(
                thr, max=float(np.float32(self.max_CC_threshold
                                          * weights_t.sum())))
            idx, cc_vals, thr_vals, n_above, kurto = detect_candidates(
                cc_dev, thr, k=max_candidates, margin=self._margin()
            )
        if n_above > len(idx):
            return None
        order = np.argsort(idx[:n_above], kind="stable")
        return (idx[:n_above][order], cc_vals[:n_above][order],
                thr_vals[:n_above][order], kurto)

    def _search_win(self, tt: int) -> float:
        tg = self.template_group
        min_iet = int(sec_to_samp(self.minimum_interevent_time,
                                  sr=self.data.sr))
        d_mv = np.max(tg.moveouts_arr[tt], axis=-1) - np.min(
            tg.moveouts_arr[tt], axis=-1)
        d_mv = int(np.median(d_mv)) + 1
        return min(10 * min_iet, max(d_mv, min_iet)) / self.step

    def _find_detections_t(self, tid, white_noise=None):
        """Per-template detection extraction (reference:
        BPMF/similarity_search.py:600-724)."""
        tt = int(self.template_group.tindexes[tid])
        t = self.tids_subset.index(tid)
        cc_t = self.cc[tid]
        weights_t = self._weights_arr[t]

        if (isinstance(cc_t, torch.Tensor)
                and self.anomalous_cdf_at_mean_plus_1sig <= 0.0):
            out = self._candidates_device(tid, cc_t, weights_t, white_noise)
            if out is not None:
                cand, cc_vals, thr_vals, kurto = out
                if self.sanity_check and kurto > self.max_kurto:
                    return []
                keep = self._dedup_sparse(cand, cc_vals, self._search_win(tt))
                cand, cc_vals, thr_vals = (
                    cand[keep], cc_vals[keep], thr_vals[keep])
                if self.remove_edges and len(cand):
                    m = self._inside_edges(cand * self.step)
                    cand, cc_vals, thr_vals = cand[m], cc_vals[m], thr_vals[m]
                return self._build_events(tid, tt, cand, cc_vals, thr_vals)
            # overflow: fall through to the host path on the fetched series

        cc_t = (cc_t.cpu().numpy() if isinstance(cc_t, torch.Tensor)
                else np.asarray(cc_t))
        if not np.any(cc_t != 0.0):
            return []
        threshold = time_dependent_threshold(
            torch.from_numpy(np.ascontiguousarray(cc_t)),
            int(sec_to_samp(self.threshold_window_dur, sr=self.data.sr)),
            self.cfg.n_dev_mf_threshold,
            overlap=self.overlap,
            threshold_type=self.threshold_type,
            white_noise=white_noise, rng=self.rng,
        ).numpy()
        threshold = np.minimum(self.max_CC_threshold * weights_t.sum(),
                               threshold)
        if self.sanity_check and scalar_kurtosis(cc_t) > self.max_kurto:
            return []
        cc_idx = self.select_cc_indexes(cc_t, threshold, self._search_win(tt))
        return self._build_events(tid, tt, cc_idx, cc_t[cc_idx],
                                  threshold[cc_idx])

    def _build_events(self, tid, tt, cc_idx, cc_vals, thr_vals):
        """Detection Events from selected CC indexes.

        In screen mode this is where exactness is restored: each
        candidate's CC is recomputed exactly and the threshold decision is
        re-taken on the exact value.  The host seconds of the refine and of
        the Events go to the `mf_refine` and `mf_events` stages of
        `utils.observe.GLOBAL_TIMER`."""
        if self.precision == "screen" and len(cc_idx):
            GLOBAL_TIMER.add("mf_candidates", len(cc_idx))
            with GLOBAL_TIMER.stage("mf_refine"):
                cc_vals = self._exact_cc_at(tid, tt, cc_idx)
            keep = cc_vals > np.asarray(thr_vals)
            cc_idx = np.asarray(cc_idx)[keep]
            cc_vals = cc_vals[keep]
            thr_vals = np.asarray(thr_vals)[keep]
        with GLOBAL_TIMER.stage("mf_events"):
            tg = self.template_group
            sr = self.data.sr
            template = tg.templates[tt]
            stations = list(self.stations)
            # per-template station-ordered moveout rows (seconds), cached: the
            # bank is fixed for the engine's lifetime
            mv_cache = getattr(self, "_tpl_mv_cache", None)
            if mv_cache is None:
                mv_cache = self._tpl_mv_cache = {}
            mv = mv_cache.get(tt)
            if mv is None:
                mv = mv_cache[tt] = template.moveouts_at(stations)
            mv_arr = tg.moveouts_arr[tt]
            data_path, data_filename = os.path.split(str(self.data.where))
            detections = []
            for i, idx in enumerate(cc_idx):
                det_idx = int(idx) * self.step
                ot = self.data.date_epoch + det_idx / sr
                event = Event(
                    utc_from_epoch(ot), mv, stations, template.phases,
                    data_filename, data_path, sampling_rate=sr,
                    data_reader=getattr(self.data, "data_reader", None),
                )
                event.inherit_location(template)
                aux = {
                    "cc": float(cc_vals[i]),
                    "n_threshold": float(cc_vals[i] / thr_vals[i]),
                    "tid": tid,
                }
                aux["n_dev"] = aux["n_threshold"] * self.cfg.n_dev_mf_threshold
                if getattr(self, "extract_peak_amplitudes", False):
                    aux["peak_amplitudes"] = self._peak_amplitudes(det_idx,
                                                                   mv_arr)
                event.set_aux_data(aux)
                detections.append(event)
            return detections

    def _peak_amplitudes(self, detection_index: int, mv_arr: np.ndarray,
                         offset_sec: float = 1.0,
                         duration_sec: float = 3.0) -> np.ndarray:
        """Peak absolute amplitude per channel around each phase arrival
        (de-normalized; reference parity:
        BPMF/similarity_search.py:695-714)."""
        sr = self.data.sr
        n_off = int(sec_to_samp(offset_sec, sr=sr))
        n_dur = int(sec_to_samp(duration_sec, sr=sr))
        n_sta, n_comp = mv_arr.shape
        peaks = np.zeros((n_sta, n_comp), np.float32)
        for s in range(n_sta):
            for c in range(n_comp):
                i0 = detection_index + int(mv_arr[s, c]) - n_off
                win = self.data_arr[s, c, max(0, i0) : max(0, i0 + n_dur)]
                if win.size:
                    peak = float(np.abs(win).max())
                    if self.normalize and hasattr(self, "data_norm"):
                        peak *= float(self.data_norm[s, c])
                    peaks[s, c] = peak
        return peaks

    def find_detections(self, minimum_interevent_time: float,
                        threshold_window_dur: float = 1800.0,
                        overlap: float = 0.25, sanity_check: bool = True,
                        verbose: int = 0,
                        white_noise: Optional[np.ndarray] = None) -> Dict:
        """Reference parity: BPMF/similarity_search.py:548-598."""
        self.minimum_interevent_time = minimum_interevent_time
        self.threshold_window_dur = threshold_window_dur
        self.overlap = overlap
        self.sanity_check = sanity_check
        white_noise = self._batch_extract(white_noise)
        detections = {}
        for tid in list(self.cc.keys()):
            detections[tid] = self._find_detections_t(
                tid, white_noise=white_noise)
            if verbose > 0:
                print(f"Template {tid} detected {len(detections[tid])} "
                      f"events.")
        return detections

    def plot_detection(self, detection, duration: float = 60.0,
                       offset_ot: float = 10.0, data_reader=None, **kwargs):
        """Waveform gallery of one detection over its template's CC series
        (reference parity: BPMF/similarity_search.py:922-1020; requires
        the CC series, i.e. `compute_cc_time_series` ran with the series
        kept)."""
        from ..viz import plot_detection

        tid = detection.aux_data.get("tid")
        cc_t = getattr(self, "cc", {}).get(tid)
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
            detection, context=cc_t, context_sr=self.data.sr,
            context_label=f"network CC (template {tid})", **kwargs,
        )

    def plot_cc(self, tid, ax=None, detection=None, figsize=(15, 7)):
        """CC time series + detection threshold for one template
        (reference parity: BPMF/similarity_search.py:812-900)."""
        from ..viz.plots import _host, _plt

        if tid not in getattr(self, "cc", {}):
            raise KeyError(
                f"{tid!r} not in self.cc — run compute_cc_time_series first"
            )
        if ax is None:
            fig, ax = _plt().subplots(figsize=figsize)
        else:
            fig = ax.get_figure()
        sr = self.data.sr
        cc_t = _host(self.cc[tid]).astype(np.float32)
        # threshold_window_dur/overlap are set by the detection entry
        # points; fall back to their defaults so plot_cc works right
        # after compute_cc_time_series
        threshold = time_dependent_threshold(
            torch.from_numpy(cc_t),
            int(sec_to_samp(
                getattr(self, "threshold_window_dur", 1800.0), sr=sr
            )),
            self.cfg.n_dev_mf_threshold,
            overlap=getattr(self, "overlap", 0.25),
            threshold_type=self.threshold_type, rng=self.rng,
        ).numpy()
        t = np.arange(len(cc_t)) / sr
        ax.plot(t, cc_t, lw=0.4, label=f"CC (template {tid})")
        ax.plot(t, threshold, "--", color="C3", label="threshold")
        if detection is not None:
            i = int(
                (detection.origin_time_epoch - self.data.date_epoch) * sr
            ) if hasattr(self.data, "date_epoch") else None
            if i is not None and 0 <= i < len(cc_t):
                ax.plot(t[i], cc_t[i], "o", color="C3", ms=6)
        ax.set_xlabel("Time (s)")
        ax.set_ylabel("Network CC")
        ax.legend(loc="upper right")
        return fig

    def run_matched_filter_search(
        self,
        minimum_interevent_time: float,
        threshold_window_dur: float = 1800.0,
        overlap: float = 0.25,
        sanity_check: bool = True,
        extract_peak_amplitudes: bool = False,
        verbose: int = 0,
        **kwargs,
    ) -> Dict:
        """Full scan in template chunks bounded by `max_memory_gb`
        (reference: BPMF/similarity_search.py:726-807).

        Every chunk's CC scan and batched extraction are queued back to
        back on the device before any result is read (the `mf_dispatch`
        stage), so chunk N's extraction and fetch overlap chunk N+1's scan;
        the `mf_detect` stage then collects each chunk (`mf_collect`,
        `mf_rescan` on a candidate overflow) and selects its detections.
        Meters: `mf_candidates` (handed to the `screen` refine, 0 where
        none was) and `mf_detections` (the Events kept)."""
        self.extract_peak_amplitudes = extract_peak_amplitudes
        tg = self.template_group
        n_chunk = self._extraction_chunk(tg.n_templates)
        detections: Dict = {}
        t_mf = t_det = 0.0
        if self.precision == "screen":
            GLOBAL_TIMER.add("mf_candidates", 0)
        white_noise = kwargs.get("white_noise")

        if self.anomalous_cdf_at_mean_plus_1sig > 0.0:
            for lo in range(0, tg.n_templates, n_chunk):
                with GLOBAL_TIMER.stage("mf_dispatch") as span:
                    self.compute_cc_time_series(
                        tids=tg.tids[lo : lo + n_chunk])
                t_mf += span.seconds
                with GLOBAL_TIMER.stage("mf_detect") as span:
                    detections.update(self.find_detections(
                        minimum_interevent_time,
                        threshold_window_dur=threshold_window_dur,
                        overlap=overlap, sanity_check=sanity_check,
                        verbose=verbose, white_noise=white_noise,
                    ))
                t_det += span.seconds
        else:
            self.minimum_interevent_time = minimum_interevent_time
            self.threshold_window_dur = threshold_window_dur
            self.overlap = overlap
            self.sanity_check = sanity_check
            contexts = []
            with GLOBAL_TIMER.stage("mf_dispatch") as span:
                # rows stay in the stacked chunk during dispatch; they are
                # regenerated from the cached plans on a fallback
                self._defer_rows = True
                for lo in range(0, tg.n_templates, n_chunk):
                    tids_chunk = tg.tids[lo : lo + n_chunk]
                    self.compute_cc_time_series(tids=tids_chunk)
                    white_noise = self._batch_extract(white_noise,
                                                      fetch=False)
                    ctx = {
                        "tids_chunk": list(tids_chunk),
                        "tids_subset": self.tids_subset,
                        "weights": self._weights_arr,
                        "pending": self._cand_pending,
                    }
                    if self._cand_pending is None:
                        # fewer than 2 device rows: no batch was queued
                        ctx["cc_full"] = self.cc
                    else:
                        ctx["host_cc"] = {
                            tid: cc for tid, cc in self.cc.items()
                            if isinstance(cc, np.ndarray)
                        }
                    contexts.append(ctx)
                    self._cand_pending = None
                    self.cc = {}
                    self._cc_stack = (None, None)
                self._defer_rows = False
            t_mf += span.seconds

            with GLOBAL_TIMER.stage("mf_detect") as span:
                placeholder = torch.zeros((2,), dtype=torch.float32,
                                          device=self.device)
                for ctx in contexts:
                    self.tids_subset = ctx["tids_subset"]
                    self._weights_arr = ctx["weights"]
                    self._cand_pending = ctx["pending"]
                    self._cand_cache = {}
                    if "cc_full" in ctx:
                        self.cc = ctx["cc_full"]
                    else:
                        needs_rerun = set(self._batch_extract_collect())
                        overflowed = [
                            tid for tid, c in self._cand_cache.items()
                            if c[3] > len(c[0])]
                        if needs_rerun or overflowed:
                            # rare: rescan this chunk (plans are cached)
                            # for the exact re-extraction / host fallback
                            cache = self._cand_cache
                            with GLOBAL_TIMER.stage("mf_rescan"):
                                self.compute_cc_time_series(
                                    tids=ctx["tids_chunk"])
                            self._cand_cache = cache
                            for tid in needs_rerun:
                                self._cand_cache.pop(tid, None)
                        else:
                            self.cc = {
                                tid: (ctx["host_cc"][tid]
                                      if tid in ctx["host_cc"]
                                      else placeholder)
                                for tid in ctx["tids_subset"]
                            }
                    for tid in list(self.cc.keys()):
                        detections[tid] = self._find_detections_t(
                            tid, white_noise=white_noise)
                        if verbose > 0:
                            print(f"Template {tid} detected "
                                  f"{len(detections[tid])} events.")
            t_det += span.seconds
        GLOBAL_TIMER.add("mf_detections",
                         sum(len(v) for v in detections.values()))
        if verbose > -1:
            print(f"Total time computing CCs: {t_mf:.2f}s")
            print(f"Total time finding detections: {t_det:.2f}s")
        return detections
