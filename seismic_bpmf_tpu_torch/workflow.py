"""High-level workflow API: the staged pipeline from a day of data to a
catalog, and the multi-day campaign.

Counterpart of `seismic_bpmf_tpu.workflow` (the reference tutorial's
notebooks), with the same JSON resume contract and the same HDF5 outputs:

  backproject_day(...)    notebooks 5-6: features -> beamform -> detections
  build_templates(...)    notebook 7: detections -> template bank
  matched_filter_day(...) notebook 8: template scan -> new detections
  assemble_catalog(...)   notebook 9: per-template detections -> catalog
  compute_magnitudes(...) notebook 10: per-event Mw (Mw* fallback)
  scan_days(...)          either day scan over many days, with resume
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ._device import resolve_device
from .config import Config, DEFAULT_CONFIG
from .data import (
    Catalog, Data, Network, Template, TemplateGroup, TravelTimes,
)
from .detection import Beamformer, MatchedFilter
from .ops.cf import saturated_envelopes
from .utils.observe import GLOBAL_TIMER, logger


def default_weights_phases(n_stations: int, n_components: int = 3,
                           n_phases: int = 2) -> np.ndarray:
    """P on the vertical, S on the horizontals (tutorial convention,
    5_backprojection.ipynb)."""
    w = np.zeros((n_stations, n_components, n_phases), np.float32)
    w[:, 2, 0] = 1.0
    w[:, :2, 1] = 1.0
    return w


def backproject_day(
    data: Data,
    network: Network,
    travel_times: TravelTimes,
    cfg: Config = DEFAULT_CONFIG,
    feature_fn: Optional[Callable] = None,
    phases: Sequence[str] = ("P", "S"),
    num_closest_stations: int = 10,
    minimum_interevent_time: float = 10.0,
    threshold_window_sec: float = 3600.0,
    n_max_stations: Optional[int] = None,
    mesh=None,
    precision: str = "high",
    output_file: Optional[str] = None,
    bf: Optional[Beamformer] = None,
    device=None,
):
    """One-day backprojection scan -> (Beamformer, list of Events).

    feature_fn(data_arr) -> features (host array or device tensor);
    defaults to MAD-standardized envelopes on the device.  Pass a
    `Beamformer` via `bf` to reuse it across days: its content-keyed plan
    cache (device-resident moveouts and weights) then persists, so only
    the day's features move.  `output_file` ("w" mode) holds exactly this
    run's detections."""
    if bf is None:
        bf = Beamformer(
            data=data, network=network, phases=list(phases),
            travel_times=travel_times, cfg=cfg, mesh=mesh,
            precision=precision, device=device,
        )
    else:
        bf.set_data(data)
    with GLOBAL_TIMER.stage("bp_features"):
        with GLOBAL_TIMER.stage("bp_stack"):
            arr = data.get_np_array(network.stations)
        if feature_fn is None:
            features, _ = saturated_envelopes(arr, device=bf.device)
        else:
            features = feature_fn(arr)
        if isinstance(features, torch.Tensor) and features.is_cuda:
            torch.cuda.synchronize(features.device)  # the stage's own time
    n_feat_comp = int(features.shape[1])
    if n_feat_comp == network.n_components:
        # waveform-derived features (e.g. envelopes): P on vertical,
        # S on horizontals
        w_ph = default_weights_phases(
            network.n_stations, network.n_components, len(phases)
        )
    else:
        # picker probability features: one channel per phase (P, S, ...)
        w_ph = np.zeros(
            (network.n_stations, n_feat_comp, len(phases)), np.float32
        )
        for p in range(min(n_feat_comp, len(phases))):
            w_ph[:, p, p] = 1.0
    with GLOBAL_TIMER.stage("bp_weights"):
        bf.set_weights(weights_phases=w_ph)
        bf.set_weights_sources(
            method="closest_stations",
            num_closest_stations=num_closest_stations,
            normalize=True,
        )
    with GLOBAL_TIMER.stage("bp_backproject"):
        bf.backproject(features, reduce="max")
        GLOBAL_TIMER.add("beam_points",
                         float(bf.n_sources) * features.shape[-1])
    with GLOBAL_TIMER.stage("bp_detect"):
        thr = bf.compute_detection_threshold(window_sec=threshold_window_sec)
        detections, _, _ = bf.find_detections(
            thr, minimum_interevent_time, n_max_stations=n_max_stations
        )
    logger.info("backprojection: %d detections", len(detections))
    if output_file is not None:
        import h5py

        # "w": the file holds exactly this run's detections (resume reruns
        # whole days, so append mode would keep a partial run's groups)
        with h5py.File(output_file, "w") as f:
            for i, ev in enumerate(detections):
                ev.write(os.path.basename(output_file), gid=str(i),
                         hdf5_file=f)
    return bf, detections


def phasenet_feature_fn(model=None, whole_day: bool = True, device=None,
                        **kwargs):
    """Build a feature_fn that runs PhaseNet over the day and returns the
    (n_sta, 2, n_samp) P/S probabilities as beamforming features.

    `model` is a `models.PhaseNet` or `models.SeisBenchPhaseNet` (its
    weights inside); None makes `init_phasenet(device=device)`, seeded
    random weights on `device` (CUDA unless 'cpu' is asked for).  With
    `whole_day=True` (the JAX package's `device=True`) the whole day is
    normalized and windowed on the model's device
    (`phasenet_probas_device`) and the probabilities stay there for the
    beamformer; with False the host-normalized picker (`make_picker`,
    forwards on the model's device in small chunks) returns host arrays.
    `kwargs` go to either."""
    from .models.phasenet import (
        init_phasenet, make_picker, phasenet_probas_device, ps_channels,
    )

    if model is None:
        model = init_phasenet(device=device)
    if not whole_day:
        return make_picker(model, **kwargs)
    p_idx, s_idx = ps_channels(model)

    def feature_fn(data_arr):
        probas = phasenet_probas_device(model, data_arr, **kwargs)
        return probas[:, [p_idx, s_idx], :]  # drop the noise class

    return feature_fn


def build_templates(
    detections,
    network: Network,
    cfg: Config = DEFAULT_CONFIG,
    data_reader: Optional[Callable] = None,
    offset_phase: Dict[str, float] = None,
    dedup_distance_km: float = 1.0,
    dedup_similarity: float = 0.9,
    db_path: Optional[str] = None,
    device=None,
) -> TemplateGroup:
    """Detections -> template bank with redundancy removal (notebook 7 /
    BPMF/dataset.py:4690-4932): each detection's windows are read, the
    bank's inter-template CC is computed on `device`, and of two templates
    at CC >= `dedup_similarity` the later one goes.  With `db_path` the
    kept templates are written there (h5py is imported then)."""
    offset_phase = offset_phase or {"P": 1.0, "S": 4.0}
    templates = []
    for i, ev in enumerate(detections):
        if not hasattr(ev, "traces"):
            ev.read_waveforms(
                cfg.template_len_sec,
                offset_phase=offset_phase,
                time_shifted=True,
                data_reader=data_reader,
            )
        tp = Template.init_from_event(ev)
        tp.set_aux_data({"tid": i})
        tp.id = str(i)
        templates.append(tp)
    tg = TemplateGroup(templates, network)
    if len(templates) > 1:
        cc = tg.compute_intertemplate_cc(
            distance_threshold=max(dedup_distance_km * 5, 5.0),
            device=device,
        )
        keep = np.ones(len(templates), bool)
        for i in range(len(templates)):
            if not keep[i]:
                continue
            for j in range(i + 1, len(templates)):
                if keep[j] and cc[i, j] >= dedup_similarity:
                    keep[j] = False
        tg = TemplateGroup(
            [t for t, k in zip(templates, keep) if k], network
        )
        logger.info(
            "template dedup: %d -> %d", len(templates), tg.n_templates
        )
    if db_path is not None:
        os.makedirs(db_path, exist_ok=True)
        for tp in tg.templates:
            tp.write(f"template{tp.tid}.h5", db_path=db_path)
    return tg


def matched_filter_day(
    template_group: TemplateGroup,
    data: Data,
    cfg: Config = DEFAULT_CONFIG,
    minimum_interevent_time: float = 5.0,
    threshold_window_dur: float = 1800.0,
    weights_method: str = "simple",
    weights_kwargs: Optional[Dict] = None,
    mesh=None,
    db_path: Optional[str] = None,
    mf: Optional[MatchedFilter] = None,
    white_noise=None,
    **mf_kwargs,
) -> Dict:
    """One-day matched-filter scan -> {tid: [Events]}.

    Pass a `MatchedFilter` via `mf` to reuse it across days: its
    device-resident template plans then persist and only the day's
    waveforms move.  The campaign default precision is 'screen' (the
    bf16-rounded day scanned, candidates widened by a margin, every
    candidate's CC recomputed exactly before the detection decision).
    `white_noise` pins the threshold's zero-fill table."""
    if mf is None:
        mf_kwargs.setdefault("precision", "screen")
        mf = MatchedFilter(template_group, cfg=cfg, mesh=mesh, **mf_kwargs)
    mf.set_data(data)
    mf.set_weights_channels(method=weights_method, normalize=True,
                            **(weights_kwargs or {}))
    with GLOBAL_TIMER.stage("mf_scan"):
        detections = mf.run_matched_filter_search(
            minimum_interevent_time,
            threshold_window_dur=threshold_window_dur,
            white_noise=white_noise,
        )
        GLOBAL_TIMER.add(
            "cc_samples",
            float(template_group.n_templates)
            * template_group.waveforms_arr.shape[-1]
            * data.n_samples,
        )
    if db_path is not None:
        os.makedirs(db_path, exist_ok=True)
        for tid, evs in detections.items():
            if evs:
                tp = template_group.templates[
                    int(template_group.tindexes[tid])]
                tp.write_detections(evs, db_path=db_path)
    return detections


def assemble_catalog(
    detections: Dict,
    template_group: TemplateGroup,
    dt_criterion: float = 3.0,
    distance_criterion: float = 5.0,
    similarity_criterion: float = 0.33,
    device=None,
) -> Catalog:
    """Merge per-template detections, flag multiples, return the catalog
    (notebook 9 / BPMF/dataset.py:5065-5295).  The bank's inter-template
    CC, unless the group already holds it, is computed on `device`."""
    all_events = [ev for evs in detections.values() for ev in evs]
    if not all_events:
        return Catalog([], [], [], [])
    cat = Catalog.read_from_events(
        all_events, extra_attributes=["cc", "tid"]
    )
    flagged = template_group.remove_multiples(
        {
            "origin_time": cat.origin_times_epoch,
            "tid": cat["tid"].astype(str),
            "cc": cat["cc"],
        },
        dt_criterion=dt_criterion,
        distance_criterion=distance_criterion,
        similarity_criterion=similarity_criterion,
        device=device,
    )
    # both are stably sorted by origin time: the rows line up
    columns = dict(cat.catalog)
    columns["unique_event"] = flagged["unique_event"]
    return Catalog.from_columns(columns)


def compute_magnitudes(events, network: Network, fallback_mw_star=True,
                       device=None, **kwargs):
    """Per-event Mw with Mw* fallback when the fit fails (notebook 10);
    None for an event whose computation raised (logged), as the JAX
    package does.  Windows and FFT spectra run on `device` (CUDA unless
    'cpu' is asked for)."""
    from .source import approximate_moment_magnitude, compute_moment_magnitude

    device = resolve_device(device)   # no card: raise here, not per event
    out = []
    for ev in events:
        try:
            spec = compute_moment_magnitude(ev, network, device=device,
                                            **kwargs)
            mw = getattr(spec, "Mw", None)
            if mw is None and fallback_mw_star:
                mw = approximate_moment_magnitude(ev, network, device=device)
            out.append(mw)
        except Exception as e:
            # the JAX package's boundary: one event's failure is logged
            # and leaves None, the others go on
            logger.warning("Mw failed for %s: %s", ev.id, e)
            out.append(None)
    return out


def scan_days(
    dates: Sequence,
    make_data: Callable,
    template_group: Optional[TemplateGroup] = None,
    cfg: Config = DEFAULT_CONFIG,
    state_file: Optional[str] = None,
    db_path: Optional[str] = None,
    stage: str = "mf",
    network: Optional[Network] = None,
    travel_times: Optional[TravelTimes] = None,
    **stage_kwargs,
) -> Dict:
    """Multi-day detection campaign with checkpoint/resume.

    stage='mf' (requires `template_group`) runs `matched_filter_day` and
    returns {date: {tid: [events]}}; stage='bp' (requires `network` and
    `travel_times`) runs `backproject_day` and returns {date: [events]},
    writing per-day ``raw_bp_<date>.h5`` files under `db_path`.  Both keep
    ONE campaign-persistent engine: plans move to the device once, only
    each day's data moves.  make_data(date) -> a `Data` with waveforms
    read; the next day is fetched on a background thread while the
    current day computes (for 'mf' it is also normalized and uploaded
    there).  `utils.observe.GLOBAL_TIMER` files each day's stages under
    `str(date)`: `scan_wait` (waiting for the fetched day), `scan_day`
    (the day's scan) and, from the background thread, `day_read`
    (`make_data`) and the upload.

    Resume contract: the state file records only ``{date:
    {"n_detections": N}}``.  Completed days are skipped on resume and
    their events are NOT re-returned; set `db_path` to persist detections
    (per-template detection files, or the per-day raw BP files) for a
    lossless resume."""
    if stage not in ("mf", "bp"):
        raise ValueError(f"stage must be 'mf' or 'bp', got {stage!r}")
    if stage == "mf" and template_group is None:
        raise ValueError("stage='mf' requires template_group")
    if stage == "bp" and (network is None or travel_times is None):
        raise ValueError("stage='bp' requires network and travel_times")
    if state_file is not None and db_path is None:
        logger.warning(
            "scan_days(stage=%r): state_file without db_path — the "
            "state keeps per-day detection counts only; a resumed "
            "campaign skips completed days WITHOUT re-returning their "
            "events.  Set db_path to persist detections for a lossless "
            "resume.", stage,
        )
    done = {}
    if state_file is not None and os.path.isfile(state_file):
        with open(state_file) as f:
            done = json.load(f)
        logger.info("resuming campaign: %d days already done", len(done))
    results: Dict = {}
    todo = [d for d in dates if str(d) not in done]

    if stage == "mf":
        day_kwargs = {
            k: stage_kwargs.pop(k)
            for k in ("minimum_interevent_time", "threshold_window_dur",
                      "weights_method", "weights_kwargs", "white_noise")
            if k in stage_kwargs
        }
        stage_kwargs.setdefault("precision", "screen")
        engine = MatchedFilter(template_group, cfg=cfg, **stage_kwargs)

        prepare = engine.preupload_day

        def run_day(date, data):
            dets = matched_filter_day(
                template_group, data, cfg=cfg, db_path=db_path, mf=engine,
                **day_kwargs,
            )
            return dets, sum(len(v) for v in dets.values())
    else:
        prepare = None
        bf_holder = {"bf": None}

        def run_day(date, data):
            out = None
            if db_path is not None:
                os.makedirs(db_path, exist_ok=True)
                out = os.path.join(db_path, f"raw_bp_{date}.h5")
            bf, dets = backproject_day(
                data, network, travel_times, cfg=cfg, output_file=out,
                bf=bf_holder["bf"], **stage_kwargs,
            )
            bf_holder["bf"] = bf
            return dets, len(dets)

    def fetch(date):
        # on the prefetch thread, filed under the day it fetches; a day
        # scanned again in the process is filed afresh
        with GLOBAL_TIMER.day(str(date), fresh=True):
            with GLOBAL_TIMER.stage("day_read"):
                data = make_data(date)
            return data if prepare is None else prepare(data)

    pool = ThreadPoolExecutor(max_workers=1)
    try:
        pending = pool.submit(fetch, todo[0]) if todo else None
        for i, date in enumerate(todo):
            key = str(date)
            with GLOBAL_TIMER.day(key):
                with GLOBAL_TIMER.stage("scan_wait"):
                    data = pending.result()
                pending = (pool.submit(fetch, todo[i + 1])
                           if i + 1 < len(todo) else None)
                with GLOBAL_TIMER.stage("scan_day"):
                    detections, n = run_day(date, data)
            results[key] = detections
            done[key] = {"n_detections": n}
            if state_file is not None:
                with open(state_file, "w") as f:
                    json.dump(done, f)
            logger.info("day %s: %d detections", key, n)
    finally:
        pool.shutdown(wait=True)
    return results
