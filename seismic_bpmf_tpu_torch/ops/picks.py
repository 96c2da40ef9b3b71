"""Phase picking: the sliding Z-score in front of the picker, and peak and
pick selection on the picker's probabilities.

Counterpart of `seismic_bpmf_tpu.ops.picks` (reference parity:
BPMF/utils.py:1966-2355).  That module imports jax and pandas, so the port
keeps its own copies:

  - `normalize_batch_np` (numpy) and `normalize_batch` (torch, on the
    device): the sliding Z-score normalization;
  - `find_picks`, `get_picks` (host, scipy): peaks and one P and one S pick
    per station, held in a pandas-free `PickTable`;
  - `detect_peaks`: the beamformer's peak finder (`peak_candidates`, then
    `suppress_peaks`, whose scan is native).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import find_peaks

from . import host_ops
from .signal import _float_tensor

PICK_COLUMNS = ("picks", "probas", "unc")


class PickTable:
    """Pick (or arrival-time) columns per station, without pandas.

    `stations` is (n_sta,) str; `columns` maps a column name to an
    (n_sta,) array: float32 selected picks ({P,S}_{picks,probas,unc}),
    datetime64[ns] absolute times ({P,S}_abs_picks, NaT where none), or an
    object array of per-station candidate arrays (the input of
    `get_picks`).  `to_frame()` builds the JAX package's DataFrame
    (pandas imported there)."""

    def __init__(self, stations, columns: Mapping[str, np.ndarray]):
        self.stations = np.asarray(stations).astype("U")
        self.columns: Dict[str, np.ndarray] = dict(columns)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __len__(self) -> int:
        return len(self.stations)

    def to_frame(self):
        import pandas as pd

        return pd.DataFrame(self.columns,
                            index=pd.Index(self.stations, name="stations"))

    @classmethod
    def from_frame(cls, df) -> "PickTable":
        return cls(np.asarray(df.index),
                   {c: df[c].to_numpy() for c in df.columns})


def is_null(v) -> bool:
    """A cell with no value: None, NaN or NaT (numpy's or pandas')."""
    return v is None or v != v


def candidates(rows: Mapping[str, Mapping[str, np.ndarray]]) -> PickTable:
    """{station: {column: candidate array}} -> a PickTable of object
    columns, one candidate array a cell."""
    stations = list(rows)
    names = list(rows[stations[0]]) if stations else []
    columns = {}
    for name in names:
        col = np.empty(len(stations), object)
        for i, sta in enumerate(stations):
            col[i] = rows[sta][name]
        columns[name] = col
    return PickTable(stations, columns)


def normalize_batch_np(
    seismogram: np.ndarray,
    normalization_window_sample: int = 3000,
    overlap: float = 0.50,
) -> np.ndarray:
    """Sliding Z-score normalization (Zhu et al. 2019 convention).

    Reference parity: BPMF/utils.py:1966-2036 (including the reflect
    padding, the endpoint window copies and the linear interpolation of the
    window statistics).
    """
    shift = int((1.0 - overlap) * normalization_window_sample)
    num_stations, num_channels, num_time_samples = seismogram.shape
    seis_pad = np.pad(
        seismogram, ((0, 0), (0, 0), (shift, shift)), mode="reflect"
    )
    view = np.lib.stride_tricks.sliding_window_view(
        seis_pad, normalization_window_sample, axis=-1
    )[:, :, ::shift, :]
    sliding_std = np.std(view, axis=-1)
    sliding_mean = np.mean(view, axis=-1)
    num_windows = view.shape[2]
    time = np.linspace(shift, num_time_samples - shift, num_windows)
    sliding_std[:, :, -1] = sliding_std[:, :, -2]
    sliding_mean[:, :, -1] = sliding_mean[:, :, -2]
    sliding_std[:, :, 0] = sliding_std[:, :, 1]
    sliding_mean[:, :, 0] = sliding_mean[:, :, 1]
    sliding_std[sliding_std == 0] = 1
    t_interp = np.arange(num_time_samples)
    std_i = np.stack(
        [np.interp(t_interp, time, s) for s in
         sliding_std.reshape(-1, num_windows)], axis=0
    ).reshape(num_stations, num_channels, num_time_samples)
    mean_i = np.stack(
        [np.interp(t_interp, time, m) for m in
         sliding_mean.reshape(-1, num_windows)], axis=0
    ).reshape(num_stations, num_channels, num_time_samples)
    return (seismogram - mean_i) / std_i


def _interp_rows(t: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
    """`np.interp(t, xp, row)` for every row of fp (R, len(xp)): linear
    between the bracketing knots, clamped to the end values outside."""
    j = torch.searchsorted(xp, t, right=True) - 1
    j = j.clamp(0, xp.numel() - 2)
    frac = ((t - xp[j]) / (xp[j + 1] - xp[j])).clamp(0.0, 1.0)
    lo = fp[:, j]
    return lo + frac * (fp[:, j + 1] - lo)


def normalize_batch(
    seismogram,
    normalization_window_sample: int = 3000,
    overlap: float = 0.50,
    device=None,
) -> torch.Tensor:
    """Device version of `normalize_batch_np`, in front of the PhaseNet
    forward: (n_sta, n_cha, n) -> the same shape and float dtype.

    The window statistics are sums over each window (the JAX package's
    strided convolution), taken in float64: a float32 running sum over a
    day of 2.16 M samples would lose digits."""
    x = _float_tensor(seismogram, device)
    window = int(normalization_window_sample)
    shift = int((1.0 - overlap) * window)
    n_sta, n_cha, n = x.shape
    rows = x.reshape(1, n_sta * n_cha, n).to(torch.float64)
    xp = F.pad(rows, (shift, shift), mode="reflect")[0]
    s1 = xp.unfold(-1, window, shift).sum(dim=-1) / window
    s2 = (xp * xp).unfold(-1, window, shift).sum(dim=-1) / window
    del xp
    mean = s1
    std = torch.sqrt(torch.clamp(s2 - s1 * s1, min=0.0))
    n_w = mean.shape[-1]
    for a in (mean, std):
        a[:, 0] = a[:, 1]
        a[:, -1] = a[:, -2]
    std = torch.where(std == 0.0, torch.ones_like(std), std)
    knots = torch.linspace(shift, n - shift, n_w, dtype=torch.float64,
                           device=x.device)
    t = torch.arange(n, dtype=torch.float64, device=x.device)
    out = (rows[0] - _interp_rows(t, knots, mean)) / _interp_rows(
        t, knots, std)
    return out.to(x.dtype).reshape(n_sta, n_cha, n)


def find_picks(phase_probability, threshold, **kwargs):
    """Peaks above threshold -> (probability, mean sample, std samples).

    Behavioral parity with BPMF/utils.py:2039-2094: each pick's timing is
    the probability-weighted mean over the peak's width interval
    [left_ips, right_ips], and its uncertainty is the square root of the
    *unweighted* squared index deviations normalized by the interval's
    probability mass (the reference's formula).  Vectorized over peaks:
    prefix sums turn every interval statistic into an O(1) lookup, so no
    per-peak Python loop.
    """
    kwargs.setdefault("width", 1)
    kwargs.setdefault("prominence", 0.9 * threshold)
    prob = np.asarray(phase_probability, np.float64)
    peaks, props = find_peaks(prob, height=threshold, **kwargs)
    if len(peaks) == 0:
        empty = np.zeros(0)
        return empty, empty.copy(), empty.copy()
    lo = props["left_ips"].astype(np.int64)
    hi = props["right_ips"].astype(np.int64)  # inclusive

    cum_p = np.concatenate([[0.0], np.cumsum(prob)])
    cum_tp = np.concatenate([[0.0], np.cumsum(np.arange(len(prob)) * prob)])
    mass = cum_p[hi + 1] - cum_p[lo]
    mean = (cum_tp[hi + 1] - cum_tp[lo]) / mass

    # closed forms for sum(m) and sum(m^2) over the peak's SHIFTED indexes
    # m = k - lo in [0, n-1]: all terms stay O(width^3), so no
    # catastrophic cancellation at day-scale absolute sample indexes
    # (computing sum(k^2) ~ (8.6e6)^3 directly loses the O(100) deviation
    # entirely in float64)
    n = (hi - lo + 1).astype(np.float64)
    mu = mean - lo
    sum_m = n * (n - 1.0) / 2.0
    sum_m2 = n * (n - 1.0) * (2.0 * n - 1.0) / 6.0
    dev2 = np.maximum(sum_m2 - 2.0 * mu * sum_m + n * mu**2, 0.0)
    std = np.sqrt(dev2 / mass)
    return prob[peaks], mean, std


def _select_trigger(times, probas, uncs, prior, search_win_samp,
                    before=None):
    """One (time, proba, unc) from candidate triggers: the highest
    probability, optionally Gaussian-reweighted toward `prior` and
    restricted to triggers strictly before `before`.  Returns NaNs (and
    the surviving candidate mask) when nothing qualifies."""
    keep = np.ones(len(times), bool) if before is None else times < before
    if not keep.any():
        return (np.nan, np.nan, np.nan), keep
    t, pr, un = times[keep], probas[keep], uncs[keep]
    score = pr
    if prior is not None:
        score = pr * np.exp(
            -((t - prior) ** 2) / (2.0 * search_win_samp**2)
        )
    j = int(np.argmax(score))
    return (float(t[j]), float(pr[j]), float(un[j])), keep


def get_picks(
    picks,
    buffer_length: int = 50,
    prior_knowledge=None,
    search_win_samp: int = 100,
) -> PickTable:
    """Select one P and one S pick per station.

    Behavioral parity with BPMF/utils.py:2097-2200: triggers inside the
    initial `buffer_length` samples are dropped, the best S trigger is
    chosen first (highest probability, optionally Gaussian-reweighted
    toward a prior), then the best P trigger among those strictly before
    the chosen S.  `picks` holds candidate arrays ({P,S}_{picks,probas,unc})
    per station: a `PickTable` (see `candidates`) or the JAX package's
    DataFrame.  `prior_knowledge` maps a station to its (P, S) prior
    samples, or is a DataFrame with columns P and S.  The result holds one
    float32 scalar per cell (NaN where no pick survives).
    """
    if not isinstance(picks, PickTable):
        picks = PickTable.from_frame(picks)
    phases = ("P", "S")
    cand = []
    for i in range(len(picks)):
        by_phase = {}
        for ph in phases:
            t, pr, un = (
                np.atleast_1d(picks[f"{ph}_{c}"][i]).astype(float)
                for c in PICK_COLUMNS
            )
            keep = t > int(buffer_length)
            by_phase[ph] = (t[keep], pr[keep], un[keep])
        cand.append(by_phase)

    prior = {}
    if prior_knowledge is not None:
        if hasattr(prior_knowledge, "loc"):
            prior_knowledge = {
                sta: (prior_knowledge.loc[sta, "P"],
                      prior_knowledge.loc[sta, "S"])
                for sta in prior_knowledge.index}
        prior = {str(sta): tuple(v) for sta, v in prior_knowledge.items()}

    out = {f"{ph}_{c}": np.empty(len(picks), np.float32)
           for ph in phases for c in PICK_COLUMNS}
    for i, sta in enumerate(picks.stations):
        prior_p, prior_s = prior.get(sta, (None, None))
        s_pick, _ = _select_trigger(
            *cand[i]["S"], prior_s, search_win_samp
        )
        p_pick, _ = _select_trigger(
            *cand[i]["P"], prior_p, search_win_samp,
            before=None if np.isnan(s_pick[0]) else s_pick[0],
        )
        for ph, sel in (("P", p_pick), ("S", s_pick)):
            for c, v in zip(PICK_COLUMNS, sel):
                out[f"{ph}_{c}"][i] = v
    return PickTable(picks.stations, out)


def peak_candidates(
    x,
    mph=None,
    threshold: float = 0,
    edge: str = "rising",
    valley: bool = False,
):
    """The local maxima that `detect_peaks` hands to its `mpd`
    suppression: (the series in float64 as the suppression reads it,
    negated for `valley` and NaN made inf; the maxima's indexes,
    ascending)."""
    x = np.atleast_1d(x).astype("float64")
    if x.size < 3:
        return x, np.array([], dtype=int)
    if valley:
        x = -x
    dx = x[1:] - x[:-1]
    indnan = np.where(np.isnan(x))[0]
    if indnan.size:
        x[indnan] = np.inf
        dx[np.where(np.isnan(dx))[0]] = np.inf
    ine, ire, ife = np.array([[], [], []], dtype=int)
    if not edge:
        ine = np.where((np.hstack((dx, 0)) < 0) & (np.hstack((0, dx)) > 0))[0]
    else:
        if edge.lower() in ["rising", "both"]:
            ire = np.where(
                (np.hstack((dx, 0)) <= 0) & (np.hstack((0, dx)) > 0)
            )[0]
        if edge.lower() in ["falling", "both"]:
            ife = np.where(
                (np.hstack((dx, 0)) < 0) & (np.hstack((0, dx)) >= 0)
            )[0]
    # np.unique by a sort and a mask: numpy 2.3's unique goes through a
    # hash table, 0.27-0.30 s for a day's 720,000 maxima on an H100
    # machine's host, where the sort and the mask take 0.01 s
    ind = np.sort(np.hstack((ine, ire, ife)))
    ind = ind[np.hstack((True, ind[1:] != ind[:-1]))] if ind.size else ind
    if ind.size and indnan.size:
        ind = ind[
            np.isin(
                ind,
                np.unique(np.hstack((indnan, indnan - 1, indnan + 1))),
                invert=True,
            )
        ]
    if ind.size and ind[0] == 0:
        ind = ind[1:]
    if ind.size and ind[-1] == x.size - 1:
        ind = ind[:-1]
    if ind.size and mph is not None:
        ind = ind[x[ind] >= mph]
    if ind.size and threshold > 0:
        dx2 = np.min(
            np.vstack([x[ind] - x[ind - 1], x[ind] - x[ind + 1]]), axis=0
        )
        ind = np.delete(ind, np.where(dx2 < threshold)[0])
    return x, ind


def suppress_peaks(x, ind, mpd: int, kpsh: bool = False) -> np.ndarray:
    """`detect_peaks`' greedy suppression of the candidates `ind`
    (ascending) of the float64 series `x`, tallest first: a kept peak
    deletes the peaks within `mpd` of it (with `kpsh`, only the lower
    ones).  The visiting order is numpy's argsort of the heights,
    reversed, whose ties are the reference's; the scan itself is native
    (`ops.host_ops.peak_suppression`)."""
    if not (ind.size and mpd > 1):
        return ind
    xpos = x[ind]
    order = np.argsort(xpos)[::-1]
    return ind[host_ops.peak_suppression(ind, xpos, order, mpd, kpsh)]


def detect_peaks(
    x,
    mph=None,
    mpd: int = 1,
    threshold: float = 0,
    edge: str = "rising",
    kpsh: bool = False,
    valley: bool = False,
):
    """Amplitude/distance-constrained peak detection.

    Reference parity: BPMF/utils.py:2203-2355 (Duarte's detect_peaks as
    vendored by the reference; used by the beamformer's detection stage):
    the same indices, with an `mpd` suppression that visits only each kept
    peak's neighbours (`peak_candidates`, then `suppress_peaks`).
    """
    x, ind = peak_candidates(x, mph=mph, threshold=threshold, edge=edge,
                             valley=valley)
    return suppress_peaks(x, ind, mpd, kpsh)
