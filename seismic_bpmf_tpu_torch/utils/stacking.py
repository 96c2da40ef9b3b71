"""Waveform stacking: the SVD-Wiener-filtered stack of a family of events.

Counterpart of `seismic_bpmf_tpu.utils.stacking` (reference:
BPMF/utils.py:667-772, after Moreau et al 2017): keep the first
`expl_var`-explaining singular components of an (events x samples)
matrix, Wiener-filter each reconstructed component, average it over the
events and sum.

`svdwf_panels` does this for many (station, component) panels at once on
`device` (CUDA unless 'cpu' is asked for): one batched float64
`torch.linalg.svd`, `n_keep` from each panel's cumulative explained
variance in float64 on the host (as `np.searchsorted` picks it), scipy's
`wiener` in torch (the local mean and variance over a
(min(colsize, n_events), 5) window with zero padding, centred as scipy's
'same' correlation centres it; the noise power the mean local variance),
then the host `filters.bandpass_filter`.  `svdwf_panels_host` is its plain
float64 version, the scipy route panel by panel as the JAX package
computes it.  A panel that is not finite, or whose SVD does not converge,
stacks to noise drawn from an explicit `torch.Generator` (the JAX package
draws it from numpy's global state); any other error propagates.

The detection-file readers (`fetch_detection_waveforms`,
`svdwf_multiplets`, `fetch_detection_waveforms_refilter`) import h5py when
they run.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device

WIENER_COLS = 5


def _n_keep(S: np.ndarray, expl_var: float, max_singular_values: int) -> int:
    var_frac = np.cumsum(S**2) / np.sum(S**2)
    n_keep = int(min(max(1, np.searchsorted(var_frac, expl_var) + 1),
                     max_singular_values))
    return min(n_keep, len(S))


def _noise(n_samp: int, generator: Optional[torch.Generator]) -> np.ndarray:
    return torch.randn(n_samp, generator=generator,
                       dtype=torch.float64).numpy()


def _bandpass(rows: np.ndarray, freqmin, freqmax, sampling_rate):
    """`filters.bandpass_filter` of each row on its own, as the JAX
    package filters each stack."""
    if freqmin is not None and freqmax is not None and sampling_rate:
        from .filters import bandpass_filter

        return np.concatenate([
            bandpass_filter(row[None], freqmin=freqmin, freqmax=freqmax,
                            f_Nyq=sampling_rate / 2.0) for row in rows
        ]) if len(rows) else rows
    return rows


def _wiener(x: torch.Tensor, rows: int) -> torch.Tensor:
    """scipy.signal.wiener(x[b], mysize=(rows, 5)) for each matrix of the
    batch x (B, n, m): box sums of ones over zero-padded input, the window
    reaching rows // 2 before and (rows - 1) // 2 after (and 2 / 2 along
    time), as scipy's 'same' correlation centres it."""
    size = float(rows * WIENER_COLS)
    pad = (WIENER_COLS // 2, (WIENER_COLS - 1) // 2, rows // 2,
           (rows - 1) // 2)
    ones = torch.ones((1, 1, rows, WIENER_COLS), dtype=x.dtype,
                      device=x.device)

    def box(y):
        return F.conv2d(F.pad(y[:, None], pad), ones)[:, 0]

    l_mean = box(x) / size
    l_var = box(x * x) / size - l_mean**2
    noise = l_var.mean(dim=(1, 2), keepdim=True)
    res = (x - l_mean) * (1 - noise / l_var) + l_mean
    return torch.where(l_var < noise, l_mean, res)


def svdwf_panels(
    panels: np.ndarray,
    expl_var: float = 0.4,
    max_singular_values: int = 5,
    freqmin: float = None,
    freqmax: float = None,
    sampling_rate: float = None,
    wiener_filter_colsize: int = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> np.ndarray:
    """SVD-Wiener-filtered stacks of (n_panels, n_events, n_samples)
    panels -> (n_panels, n_samples) float64, the SVDs batched on
    `device`."""
    dev = resolve_device(device)
    panels = np.asarray(panels, np.float64)
    n_p, n_ev, n_samp = panels.shape
    out = np.zeros((n_p, n_samp), np.float64)
    finite = np.isfinite(panels).all(axis=(1, 2))
    ok = np.flatnonzero(finite)
    failed = [int(p) for p in np.flatnonzero(~finite)]
    if len(ok):
        x = torch.from_numpy(panels[ok]).to(dev)
        try:
            U, S, Vh = torch.linalg.svd(x, full_matrices=False)
        except torch.linalg.LinAlgError:
            # one panel did not converge: find which, one at a time
            U = S = Vh = None
        if dev.type == "cuda":
            svdwf_panels.launches += 1
        if U is None:
            keep = []
            for j, p in enumerate(ok):
                try:
                    torch.linalg.svd(x[j], full_matrices=False)
                    keep.append(j)
                except torch.linalg.LinAlgError:
                    failed.append(int(p))
            ok, x = ok[keep], x[keep]
            U, S, Vh = (torch.linalg.svd(x, full_matrices=False)
                        if len(keep) else (None, None, None))
    if len(ok):
        S_host = S.cpu().numpy()
        n_keep = np.array([_n_keep(s, expl_var, max_singular_values)
                           for s in S_host])
        colsize = n_ev if wiener_filter_colsize is None else int(
            wiener_filter_colsize)
        rows = min(colsize, n_ev)
        stack = torch.zeros((len(ok), n_samp), dtype=torch.float64,
                            device=dev)
        for k in range(int(n_keep.max())):
            comp = S[:, k, None, None] * U[:, :, k, None] * Vh[:, k, None, :]
            if n_ev >= 2:
                comp = _wiener(comp, rows)
            use = torch.from_numpy(n_keep > k).to(dev)
            stack = stack + torch.where(use[:, None], comp.mean(dim=1),
                                        torch.zeros((), dtype=comp.dtype,
                                                    device=dev))
        out[ok] = _bandpass(stack.cpu().numpy(), freqmin, freqmax,
                            sampling_rate)
    for p in sorted(failed):
        out[p] = _noise(n_samp, generator)
    return out


svdwf_panels.launches = 0


def svdwf_panels_host(
    panels: np.ndarray,
    expl_var: float = 0.4,
    max_singular_values: int = 5,
    freqmin: float = None,
    freqmax: float = None,
    sampling_rate: float = None,
    wiener_filter_colsize: int = None,
    generator: Optional[torch.Generator] = None,
) -> np.ndarray:
    """The plain float64 version of `svdwf_panels`: scipy's SVD and
    `wiener` panel by panel on the host, as the JAX package's `svdwf`
    computes them (before its float32 cast)."""
    from scipy.linalg import LinAlgError, svd
    from scipy.signal import wiener

    panels = np.asarray(panels, np.float64)
    n_p, n_ev, n_samp = panels.shape
    out = np.zeros((n_p, n_samp), np.float64)
    failed = []
    for p in range(n_p):
        matrix = panels[p]
        try:
            U, S, Vt = svd(matrix, full_matrices=False)
        except (ValueError, LinAlgError):
            failed.append(p)
            continue
        colsize = (U.shape[0] if wiener_filter_colsize is None
                   else wiener_filter_colsize)
        for k in range(_n_keep(S, expl_var, max_singular_values)):
            component = S[k] * np.outer(U[:, k], Vt[k])
            if component.shape[0] >= 2:
                component = wiener(component, mysize=(
                    min(colsize, component.shape[0]), WIENER_COLS))
            out[p] += component.mean(axis=0)
    done = [p for p in range(n_p) if p not in failed]
    out[done] = _bandpass(out[done], freqmin, freqmax, sampling_rate)
    for p in failed:
        out[p] = _noise(n_samp, generator)
    return out


def svdwf(
    matrix: np.ndarray,
    expl_var: float = 0.4,
    max_singular_values: int = 5,
    freqmin: float = None,
    freqmax: float = None,
    sampling_rate: float = None,
    wiener_filter_colsize: int = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> np.ndarray:
    """SVD-Wiener-filtered stack of an (n_events, n_samples) matrix ->
    (n_samples,) float32 (reference parity: BPMF/utils.py:667-772), on
    `device`."""
    return svdwf_panels(
        np.asarray(matrix)[None], expl_var=expl_var,
        max_singular_values=max_singular_values, freqmin=freqmin,
        freqmax=freqmax, sampling_rate=sampling_rate,
        wiener_filter_colsize=wiener_filter_colsize, generator=generator,
        device=device)[0].astype(np.float32)


def stack_panels(waveforms: np.ndarray, device=None, **svdwf_kwargs):
    """(n_sta, n_comp, n_samp) float32 SVDWF stack of (n_ev, n_sta,
    n_comp, n_samp) waveforms: every (station, component) panel that is
    not all zeros in one `svdwf_panels` call; the others stay zero."""
    n_ev, n_sta, n_comp, n_samp = waveforms.shape
    stacked = np.zeros((n_sta, n_comp, n_samp), np.float32)
    panels = np.moveaxis(waveforms, 0, 2).reshape(n_sta * n_comp, n_ev,
                                                  n_samp)
    live = [p for p in range(len(panels))
            if not np.allclose(panels[p], 0.0)]
    if live:
        flat = stacked.reshape(n_sta * n_comp, n_samp)
        flat[live] = svdwf_panels(panels[live], device=device,
                                  **svdwf_kwargs)
    return stacked


def fractional_stack(traces: np.ndarray, order: float = 1.0) -> np.ndarray:
    """Linear (order=1) or N-th-root stack along the first axis."""
    if order == 1.0:
        return traces.mean(axis=0)
    signs = np.sign(traces)
    rooted = signs * np.abs(traces) ** (1.0 / order)
    stacked = rooted.mean(axis=0)
    return np.sign(stacked) * np.abs(stacked) ** order


def fetch_detection_waveforms(
    template,
    filename: str = None,
    db_path: str = "",
    best_cc: bool = False,
    max_n_events: int = 0,
    norm_rms: bool = True,
    ordering: str = "cc",
    flip_order: bool = True,
    unique_events: bool = False,
    duration: float = None,
    offset_phase: dict = None,
    data_reader=None,
    return_event_ids: bool = False,
):
    """A template's detection waveforms, selected and ordered by CC
    (reference: BPMF/utils.py:775-866): reads the detection file written by
    `Template.write_detections`, applies the reference's CC-threshold
    ladder (`max_n_events` top events, or `best_cc`'s size-dependent
    percentiles) and returns a dense (n_det, n_sta, n_comp, n_samp) float32
    array with the CCs.  Waveforms come from groups saved with waveforms,
    or are read again when `duration` (and optionally `data_reader`) is
    given."""
    import os

    import h5py

    from ..data.events import Event

    filename = filename or f"detections_tp{template.tid}.h5"
    with h5py.File(os.path.join(db_path, filename), "r") as f:
        events = [
            Event.read_from_file(hdf5_file=f[g]) for g in sorted(f.keys())
        ]
    ccs = np.array(
        [float(ev.aux_data.get("cc", np.nan)) for ev in events], np.float64
    )
    order_ids = np.arange(len(events))

    cc_sorted = np.sort(ccs[np.isfinite(ccs)])
    if max_n_events > 0 and len(cc_sorted):
        cc_thres = cc_sorted[-min(max_n_events, len(cc_sorted))]
    elif best_cc and len(cc_sorted):
        n = len(cc_sorted)
        if n > 300:
            cc_thres = cc_sorted[-100]
        elif n > 70:
            cc_thres = cc_sorted[int(0.7 * n)]
        elif n > 30:
            cc_thres = float(np.median(cc_sorted))
        elif n > 10:
            cc_thres = float(np.percentile(cc_sorted, 33.0))
        else:
            cc_thres = 0.0
    else:
        cc_thres = -np.inf
    if np.isneginf(cc_thres):
        # no CC selection: keep events whose file carries no 'cc' too
        keep = np.ones(len(events), dtype=bool)
    else:
        keep = ccs >= cc_thres
    if unique_events:
        uniq = np.array(
            [bool(ev.aux_data.get("unique_event", True)) for ev in events]
        )
        keep &= uniq
    events = [ev for ev, k in zip(events, keep) if k]
    ccs, order_ids = ccs[keep], order_ids[keep]
    if not events:
        empty = np.empty((0,))
        return ((empty, empty, empty) if return_event_ids
                else (empty, empty))

    arrs = []
    for ev in events:
        if duration is not None:
            if data_reader is not None:
                ev.data_reader = data_reader
            kw = {} if offset_phase is None else {
                "offset_phase": offset_phase
            }
            ev.read_waveforms(duration, time_shifted=True, **kw)
        elif not hasattr(ev, "duration") and getattr(ev, "traces", None):
            # stored-waveform events carry no window duration attribute
            tr = ev.traces[0]
            ev.duration = len(tr.data) / float(tr.stats.sampling_rate)
        arrs.append(ev.waveforms_arr)
    wf = np.stack(arrs, axis=0).astype(np.float32)
    if norm_rms:
        norm = wf.std(axis=(2, 3))[..., None, None]
        norm[norm == 0.0] = 1.0
        wf = wf / norm
    if ordering is not None:
        order = np.argsort(ccs)
        if flip_order:
            order = order[::-1]
        wf, ccs, order_ids = wf[order], ccs[order], order_ids[order]
    if return_event_ids:
        return wf, ccs, order_ids
    return wf, ccs


def svdwf_multiplets(
    template,
    filename: str = None,
    db_path: str = "",
    best_cc: bool = False,
    norm_rms: bool = True,
    max_singular_values: int = 5,
    expl_var: float = 0.4,
    freqmin: float = None,
    freqmax: float = None,
    sampling_rate: float = None,
    wiener_filter_colsize: int = None,
    detection_waveforms: np.ndarray = None,
    generator: Optional[torch.Generator] = None,
    device=None,
    **fetch_kwargs,
):
    """SVD-Wiener-filtered stack of a template's detections -> `Stack`
    (reference: BPMF/utils.py:986-1110): the detection waveforms (fetched,
    or given as `detection_waveforms`), each (station, component) panel
    stacked by `svdwf_panels` on `device` in one call, wrapped in a
    `data.groups.Stack` with the template's moveouts."""
    from ..data.groups import Stack

    if detection_waveforms is None:
        detection_waveforms, _ = fetch_detection_waveforms(
            template, filename=filename, db_path=db_path, best_cc=best_cc,
            norm_rms=norm_rms, **fetch_kwargs,
        )
    if detection_waveforms.size == 0:
        raise ValueError("no detections to stack")
    sr = sampling_rate or template.sampling_rate
    stacked = stack_panels(
        detection_waveforms, device=device, expl_var=expl_var,
        max_singular_values=max_singular_values, freqmin=freqmin,
        freqmax=freqmax, sampling_rate=sr,
        wiener_filter_colsize=wiener_filter_colsize, generator=generator)
    return Stack(
        stacked,
        list(template.stations),
        list(template.components),
        sampling_rate=sr,
        phases=list(template.phases),
        moveouts=template.moveouts_table(),
    )


def fetch_detection_waveforms_refilter(
    template,
    freqmin: float,
    freqmax: float,
    duration: float,
    filename: str = None,
    db_path: str = "",
    data_reader=None,
    target_sr: float = None,
    integrate: bool = False,
    **fetch_kwargs,
):
    """`fetch_detection_waveforms` reading the raw data again and filtering
    it into a new band (reference: BPMF/utils.py:867-983): `duration`
    seconds time-shifted, bandpassed to [freqmin, freqmax], optionally
    integrated and decimated to `target_sr`."""
    from scipy.signal import decimate, detrend

    from .filters import bandpass_filter

    norm_rms = fetch_kwargs.pop("norm_rms", True)
    wf, ccs = fetch_detection_waveforms(
        template, filename=filename, db_path=db_path, duration=duration,
        data_reader=data_reader, norm_rms=False, **fetch_kwargs,
    )
    if wf.size == 0:
        return wf, ccs
    sr = float(template.sampling_rate)
    shp = wf.shape
    flat = detrend(wf.reshape(-1, shp[-1]).astype(np.float64), axis=-1)
    if integrate:
        flat = np.cumsum(flat, axis=-1) / sr
        flat = detrend(flat, axis=-1)
    flat = bandpass_filter(
        flat, freqmin=freqmin, freqmax=freqmax, f_Nyq=sr / 2.0
    )
    if target_sr is not None and target_sr < sr:
        q = int(round(sr / target_sr))
        flat = decimate(flat, q, axis=-1, zero_phase=True)
    out = flat.reshape(shp[:-1] + (flat.shape[-1],)).astype(np.float32)
    if norm_rms:
        norm = out.std(axis=(2, 3))[..., None, None]
        norm[norm == 0.0] = 1.0
        out = out / norm
    return out, ccs
