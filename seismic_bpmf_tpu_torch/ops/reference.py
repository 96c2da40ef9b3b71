"""Pure-NumPy reference implementations ("oracles") used by the port.

The port's own copy of the oracles of `seismic_bpmf_tpu.ops.reference`
that its day scans need: `beamform` (the BP kernel's specification),
`bp_detection_threshold`, `envelope`, `saturated_envelopes` and `kurtosis`
(the backprojection features and threshold), `matched_filter` (the MF
kernel's specification), `matched_filter_at` (the float64 refine of the
`screen` rung), `time_dependent_threshold`, `select_cc_indexes`,
`dedup_detection_indexes`, `find_similar_sources` (redundant grid
sources) and `peak_suppression` (the beamformer's peak finder).

Behavioral parity targets (reference file:line cited per function):
  - beamform .................. external `beampower` package as consumed at
                                BPMF/template_search.py:549-569
  - matched_filter ............ external `fast_matched_filter` as consumed at
                                BPMF/similarity_search.py:526-533
  - time_dependent_threshold .. BPMF/libc.c:516-673 ('rms'),
                                BPMF/similarity_search.py:1079-1113 ('mad')
  - bp_detection_threshold .... BPMF/template_search.py:1418-1487
  - select_cc_indexes ......... BPMF/libc.c:441-485
  - kurtosis .................. BPMF/libc.c:11-53
  - envelope / saturation ..... BPMF/template_search.py:1525-1617
  - find_similar_sources ...... BPMF/libc.c:55-387
  - peak_suppression .......... BPMF/utils.py:2203-2355 (`mpd` branch)
"""

from __future__ import annotations

import numpy as np

GAUSSIAN_SAMPLE_LEN = 500


# ---------------------------------------------------------------------------
# Beamforming (backprojection)
# ---------------------------------------------------------------------------

def beamform(
    features: np.ndarray,
    moveouts: np.ndarray,
    weights_phases: np.ndarray,
    weights_sources: np.ndarray,
    reduce: str = "max",
    out_of_bounds: str = "strict",
):
    """Shift-and-stack beamforming over a source grid.

    beam[i, t] = sum_{s,c,p} w_src[i,s] * w_ph[s,c,p] * feat[s,c,t + mv[i,s,p]]

    Parameters
    ----------
    features : (n_sta, n_comp, n_samp) float array
    moveouts : (n_src, n_sta, n_ph) int array, in samples
    weights_phases : (n_sta, n_comp, n_ph) float array
    weights_sources : (n_src, n_sta) float array
    reduce : 'max' returns (maxbeam (n_samp,), maxbeam_sources (n_samp,));
             'none' returns beam (n_src, n_samp).
    out_of_bounds : 'strict' zeroes beam values at times where any channel
        with non-zero weight points outside the data; 'flexible' only drops
        the invalid channels' contributions.
    """
    features = np.asarray(features, dtype=np.float32)
    moveouts = np.asarray(moveouts)
    n_sta, n_comp, n_samp = features.shape
    n_src, _, n_ph = moveouts.shape

    # fold the component axis first:  g[s, p, t] = sum_c w_ph[s,c,p] f[s,c,t]
    g = np.einsum("scp,sct->spt", weights_phases.astype(np.float64), features)

    t = np.arange(n_samp)
    beam = np.zeros((n_src, n_samp), dtype=np.float64)
    # a channel (s, p) is "used" for source i iff w_src[i, s] != 0 and
    # the phase weight row for (s, :, p) is not all-zero
    phase_used = np.any(weights_phases != 0.0, axis=1)  # (n_sta, n_ph)
    for i in range(n_src):
        invalid_any = np.zeros(n_samp, dtype=bool)
        for s in range(n_sta):
            w_is = weights_sources[i, s]
            if w_is == 0.0:
                continue
            for p in range(n_ph):
                if not phase_used[s, p]:
                    continue
                idx = t + int(moveouts[i, s, p])
                valid = (idx >= 0) & (idx < n_samp)
                contrib = np.zeros(n_samp, dtype=np.float64)
                contrib[valid] = g[s, p, idx[valid]]
                beam[i] += w_is * contrib
                invalid_any |= ~valid
        if out_of_bounds == "strict":
            beam[i, invalid_any] = 0.0

    beam = beam.astype(np.float32)
    if reduce == "max":
        maxbeam_sources = np.argmax(beam, axis=0).astype(np.int32)
        maxbeam = beam[maxbeam_sources, np.arange(n_samp)]
        return maxbeam, maxbeam_sources
    elif reduce == "none":
        return beam
    raise ValueError(f"reduce must be 'max' or 'none', got {reduce!r}")


# ---------------------------------------------------------------------------
# Normalized cross-correlation (matched filter)
# ---------------------------------------------------------------------------

def matched_filter(
    templates: np.ndarray,
    moveouts: np.ndarray,
    weights: np.ndarray,
    data: np.ndarray,
    step: int = 1,
    network_sum: bool = True,
):
    """Normalized sliding cross-correlation of a template bank.

    For each template, channel (station, component) and lag t (in units of
    `step` samples), computes the Pearson correlation coefficient between the
    template waveform and the data window starting at ``t*step + moveout``.
    Zero-variance windows (either side) give CC = 0; windows extending
    outside the data give CC = 0.

    Parameters
    ----------
    templates : (n_tp, n_sta, n_comp, n_samp_tp) float array
    moveouts : (n_tp, n_sta, n_comp) int array, samples
    weights : (n_tp, n_sta, n_comp) float array
    data : (n_sta, n_comp, n_samp) float array
    step : int
    network_sum : if True, returns (n_tp, n_corr) weighted channel sum;
        if False, returns per-channel CCs (n_tp, n_corr, n_sta, n_comp).
    """
    templates = np.asarray(templates, dtype=np.float32)
    data = np.asarray(data, dtype=np.float32)
    n_tp, n_sta, n_comp, n_samp_tp = templates.shape
    n_samp = data.shape[-1]
    n_corr = (n_samp - n_samp_tp) // step + 1

    cc = np.zeros((n_tp, n_corr, n_sta, n_comp), dtype=np.float64)
    lags = np.arange(n_corr) * step
    for tp in range(n_tp):
        for s in range(n_sta):
            for c in range(n_comp):
                x = templates[tp, s, c].astype(np.float64)
                x = x - x.mean()
                x_norm = np.sqrt(np.sum(x * x))
                if x_norm == 0.0:
                    continue
                mv = int(moveouts[tp, s, c])
                starts = lags + mv
                d = data[s, c].astype(np.float64)
                for k, st in enumerate(starts):
                    if st < 0 or st + n_samp_tp > n_samp:
                        continue
                    y = d[st : st + n_samp_tp]
                    y = y - y.mean()
                    y_norm = np.sqrt(np.sum(y * y))
                    if y_norm == 0.0:
                        continue
                    cc[tp, k, s, c] = np.dot(x, y) / (x_norm * y_norm)

    if network_sum:
        out = np.einsum("tksc,tsc->tk", cc, weights.astype(np.float64))
        return out.astype(np.float32)
    return cc.astype(np.float32)


def matched_filter_at(
    template: np.ndarray,
    moveouts: np.ndarray,
    weights: np.ndarray,
    data: np.ndarray,
    cc_idx: np.ndarray,
    step: int = 1,
) -> np.ndarray:
    """Exact network CC of ONE template at the given CC indexes.

    Vectorized float64 evaluation of `matched_filter(network_sum=True)`
    restricted to sparse lags (~L*n_ch MACs per lag) — the refine step of
    the screen-precision engine.  Guards match the TPU kernels
    (window variance <= 1e-10 -> 0; out-of-bounds windows -> 0).

    template : (n_sta, n_comp, L); moveouts/weights : (n_sta, n_comp);
    data : (n_sta, n_comp, n_samp); cc_idx : (n,) CC indexes (step units).
    """
    tpl = np.asarray(template, np.float64)
    mv = np.asarray(moveouts)
    w = np.asarray(weights, np.float64)
    L = tpl.shape[-1]
    n_samp = data.shape[-1]
    tpl_dm = tpl - tpl.mean(axis=-1, keepdims=True)
    x_norm = np.sqrt((tpl_dm**2).sum(-1))
    scale = np.where(x_norm > 0, w / np.maximum(x_norm, 1e-30), 0.0)

    det = np.asarray(cc_idx, np.int64) * int(step)       # (n,)
    starts = det[:, None, None] + mv[None]               # (n, n_sta, n_comp)
    valid = (starts >= 0) & (starts + L <= n_samp)
    s_cl = np.clip(starts, 0, max(n_samp - L, 0))
    n_sta, n_comp = mv.shape
    sta_i = np.arange(n_sta)[None, :, None, None]
    cmp_i = np.arange(n_comp)[None, None, :, None]
    win = data[sta_i, cmp_i, s_cl[..., None] + np.arange(L)].astype(
        np.float64
    )                                                    # (n, sta, comp, L)
    r1 = win.sum(-1)
    r2 = (win * win).sum(-1)
    var = r2 - r1 * r1 / L
    y = np.where(var > 1e-10, 1.0 / np.sqrt(np.maximum(var, 1e-30)), 0.0)
    corr = np.einsum("nscl,scl->nsc", win, tpl_dm * scale[..., None])
    return ((corr * y) * valid).sum(axis=(-1, -2)).astype(np.float32)


# ---------------------------------------------------------------------------
# Time-dependent detection thresholds
# ---------------------------------------------------------------------------

def time_dependent_threshold(
    time_series: np.ndarray,
    sliding_window_samp: int,
    num_dev: float,
    overlap: float = 0.66,
    threshold_type: str = "rms",
    white_noise: np.ndarray | None = None,
):
    """Time-dependent detection threshold on a CC time series.

    'rms' reproduces BPMF/libc.c:516-673 exactly (including the quirky
    "delay-the-jump" smoothing and the zero-filling with a cyclic 500-sample
    Gaussian table); 'mad' reproduces BPMF/similarity_search.py:1079-1113.
    """
    ts = np.asarray(time_series, dtype=np.float32).copy()
    n = len(ts)
    threshold_type = threshold_type.lower()

    if threshold_type == "rms":
        if white_noise is None:
            white_noise = np.random.normal(size=GAUSSIAN_SAMPLE_LEN).astype(
                np.float32
            )
        white_noise = np.asarray(white_noise, dtype=np.float32)
        half_win = sliding_window_samp // 2
        shift = int((1.0 - overlap) * sliding_window_samp)
        win = 2 * half_win
        n_win = (n - (win - shift)) // shift

        # global stats over non-zero samples of the first n//win windows
        n_glob = (n // win) * win
        head = ts[:n_glob]
        nz = head != 0.0
        n_nz = int(nz.sum())
        if n_nz > 0:
            center = np.float32(head[nz].astype(np.float64).sum() / n_nz)
            dev = np.float32(
                np.sqrt(
                    ((head[nz].astype(np.float64) - center) ** 2).sum() / n_nz
                )
            )
        else:
            center, dev = np.float32(0.0), np.float32(0.0)

        # replace zeros with scaled cyclic Gaussian noise
        zeros_idx = np.flatnonzero(ts == 0.0)
        ts[zeros_idx] = (
            center + white_noise[zeros_idx % GAUSSIAN_SAMPLE_LEN] * dev
        )

        # sliding mean + num_dev * std (population)
        starts = np.arange(n_win) * shift
        thr_win = np.empty(n_win, dtype=np.float64)
        for i, st in enumerate(starts):
            w = ts[st : st + win].astype(np.float64)
            m = w.mean()
            sd = np.sqrt(((w - m) ** 2).mean())
            thr_win[i] = m + num_dev * sd

        # "delay the jump" conservative smoothing (libc.c:631-651)
        diff = np.diff(thr_win)
        for i in range(1, n_win):
            if diff[i - 1] < 0.0:
                thr_win[i] -= diff[i - 1]
            diff[i - 1] = thr_win[i] - thr_win[i - 1]
        for i in range(n_win - 1):
            if diff[i] > 0.0:
                thr_win[i] += diff[i]

        # step-wise expansion to full length
        out = np.empty(n, dtype=np.float32)
        idx = np.arange(n)
        j = np.clip(idx // shift, 0, n_win - 1)
        out[:] = thr_win[j]
        out[idx < shift] = thr_win[0]
        out[idx >= n - shift] = thr_win[-1]
        return out

    elif threshold_type == "mad":
        half_window = sliding_window_samp // 2
        shift = int((1.0 - overlap) * sliding_window_samp)
        zeros = ts == 0.0
        n_zeros = int(zeros.sum())
        if white_noise is None:
            white_noise = np.random.normal(size=n_zeros).astype(np.float32)
        default_center = np.median(ts[~zeros])
        default_dev = np.median(np.abs(ts[~zeros] - default_center))
        ts[zeros] = white_noise[:n_zeros] * default_dev + default_center
        ts_win = np.lib.stride_tricks.sliding_window_view(
            ts, sliding_window_samp
        )[::shift, :]
        center = np.median(ts_win, axis=-1)
        dev = np.median(np.abs(ts_win - center[:, None]), axis=-1)
        thr = center + num_dev * dev
        thr[1:] = np.maximum(thr[:-1], thr[1:])
        thr[:-1] = np.maximum(thr[:-1], thr[1:])
        time = np.arange(half_window, n - (sliding_window_samp - half_window))
        idx_l = np.minimum(time // shift, len(thr) - 1)
        mid = thr[idx_l]
        out = np.hstack(
            (
                mid[0] * np.ones(half_window, dtype=np.float32),
                mid,
                mid[-1]
                * np.ones(sliding_window_samp - half_window, dtype=np.float32),
            )
        )
        return out.astype(np.float32)

    raise ValueError(f"threshold_type must be 'rms' or 'mad', got {threshold_type!r}")


def bp_detection_threshold(
    maxbeam: np.ndarray,
    window: int,
    overlap: float = 0.75,
    num_dev: float = 15.0,
):
    """Running median + num_dev * MAD, linearly interpolated to full length.

    Reference: BPMF/template_search.py:1418-1487.
    """
    from scipy.stats import median_abs_deviation as scimad
    from scipy.interpolate import interp1d

    x = np.asarray(maxbeam)
    shift = int((1.0 - overlap) * window)
    n_windows = int((len(x) - window) // shift) + 1
    mad_ = np.zeros(n_windows + 2, dtype=np.float32)
    med_ = np.zeros(n_windows + 2, dtype=np.float32)
    time = np.zeros(n_windows + 2, dtype=np.float32)
    for i in range(1, n_windows + 1):
        i1 = i * shift
        i2 = min(x.size, i1 + window)
        w = x[i1:i2]
        med_[i] = np.median(w)
        mad_[i] = scimad(w)
        time[i] = (i1 + i2) / 2.0
    time[0] = 0.0
    mad_[0], med_[0] = mad_[1], med_[1]
    time[-1] = len(x)
    mad_[-1], med_[-1] = mad_[-2], med_[-2]
    thr = med_ + num_dev * mad_
    interpolator = interp1d(
        time, thr, kind="slinear", fill_value=(thr[0], thr[-1]),
        bounds_error=False,
    )
    return interpolator(np.arange(len(x))).astype(np.float32)


# ---------------------------------------------------------------------------
# CC-index selection (detection triggering)
# ---------------------------------------------------------------------------

def select_cc_indexes(
    cc: np.ndarray, threshold: np.ndarray, search_win: int
) -> np.ndarray:
    """Order-dependent trigger scan: above threshold AND local max within a
    trailing `search_win` window; weaker earlier triggers are cleared.

    Reference: BPMF/libc.c:441-485.  Returns a boolean selection mask.
    """
    cc = np.asarray(cc)
    n = len(cc)
    if np.isscalar(threshold) or np.ndim(threshold) == 0:
        threshold = np.full(n, float(threshold), dtype=np.float32)
    selection = np.zeros(n, dtype=bool)
    for i in range(n):
        selection[i] = cc[i] > threshold[i]
        i_start = 0 if i <= search_win else i - search_win
        for j in range(i_start, i):
            if cc[j] > cc[i]:
                selection[i] = False
                break
            else:
                selection[j] = False
    return selection


def dedup_detection_indexes(
    cc_idx: np.ndarray, cc: np.ndarray, search_win: int
) -> np.ndarray:
    """Sequential dedup of above-threshold indexes keeping the larger CC.

    Reference: BPMF/similarity_search.py:240-251 (the pure-Python variant used
    by `MatchedFilter.select_cc_indexes`).
    """
    cc_idx = list(np.asarray(cc_idx))
    n_rm = 0
    n0 = len(cc_idx)
    for i in range(1, n0):
        a = cc_idx[i - n_rm - 1]
        b = cc_idx[i - n_rm]
        if (b - a) < search_win:
            if cc[b] > cc[a]:
                cc_idx.remove(a)
            else:
                cc_idx.remove(b)
            n_rm += 1
    return np.asarray(cc_idx, dtype=np.int64)


# ---------------------------------------------------------------------------
# Minimum-distance peak suppression (the beamformer's peak finder)
# ---------------------------------------------------------------------------

def peak_suppression(
    pos: np.ndarray, xpos: np.ndarray, order: np.ndarray, mpd: int,
    kpsh: bool = False,
) -> np.ndarray:
    """Greedy minimum-distance suppression of `detect_peaks`: the peaks at
    ascending positions `pos`, of heights `xpos`, visited in `order`
    (indexes into `pos`, tallest first); a visited peak still kept deletes
    the peaks within `mpd` samples of it (with `kpsh`, only the lower
    ones).  Returns the keep mask in position order.

    Reference: detect_peaks' `mpd` branch (BPMF/utils.py:2203-2355), which
    rescans every peak for each kept one; here a kept peak visits only its
    neighbours, the run [lo, hi) of `pos` within `mpd` of it.
    """
    pos = np.asarray(pos)
    lo = np.searchsorted(pos, pos - mpd, side="left")
    hi = np.searchsorted(pos, pos + mpd, side="right")
    idel = np.zeros(len(pos), dtype=bool)
    for r in np.asarray(order).tolist():
        if not idel[r]:
            a, b = lo[r], hi[r]
            if kpsh:
                idel[a:b] |= xpos[a:b] < xpos[r]
            else:
                idel[a:b] = True
            idel[r] = False
    return ~idel


# ---------------------------------------------------------------------------
# Running kurtosis characteristic function
# ---------------------------------------------------------------------------

def kurtosis(signal: np.ndarray, w: int) -> np.ndarray:
    """Running kurtosis over a trailing window of `w` samples.

    kurto[n] uses samples [n-w, n).  Output is 0 for n < w and wherever the
    window variance is <= 1e-6.  Reference: BPMF/libc.c:11-53.
    """
    signal = np.asarray(signal, dtype=np.float32)
    orig_shape = signal.shape
    x = signal.reshape(-1, orig_shape[-1]).astype(np.float64)
    n_tr, n = x.shape
    out = np.zeros_like(x, dtype=np.float64)
    wf = float(w)
    coeff = 1.0 / ((wf - 2.0) * (wf - 3.0))
    for i in range(n_tr):
        windows = np.lib.stride_tricks.sliding_window_view(x[i], w)[: n - w]
        mean = windows.mean(axis=-1, keepdims=True)
        d = windows - mean
        m2 = (d**2).mean(axis=-1)
        m4 = (d**4).mean(axis=-1)
        valid = m2 > 1e-6
        k = np.zeros(len(windows))
        k[valid] = coeff * (
            (wf**2 - 1.0) * m4[valid] / m2[valid] ** 2 - 3.0 * (wf - 1.0) ** 2
        )
        out[i, w:] = k
    return out.reshape(orig_shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Redundant source-grid detection
# ---------------------------------------------------------------------------

def find_similar_sources(
    moveouts: np.ndarray,
    source_longitude: np.ndarray,
    source_latitude: np.ndarray,
    cell_longitude: np.ndarray,
    cell_latitude: np.ndarray,
    threshold: float,
    num_stations_for_diff: int | None = None,
    method: str = "closest",
) -> np.ndarray:
    """Mark grid sources whose moveouts are redundant with an earlier source.

    Two passes: cell-local, then global.  Sequential in the first source index
    (a source already marked redundant cannot absorb others).  `method`:
      - 'closest': sum squared moveout differences at the `k` stations closest
        (smallest moveout) to source 1 (BPMF/libc.c:225-387).
      - 'smallest': sum the `k` smallest squared differences
        (BPMF/libc.c:55-223).
    Returns a boolean (n_sources,) array.
    """
    mv = np.asarray(moveouts, dtype=np.float32)
    n_src, n_sta = mv.shape
    k = n_sta if num_stations_for_diff is None else int(num_stations_for_diff)
    thr2 = np.float32(k * threshold**2)
    lon = np.asarray(source_longitude, dtype=np.float32)
    lat = np.asarray(source_latitude, dtype=np.float32)
    cl = np.asarray(cell_longitude, dtype=np.float32)
    ca = np.asarray(cell_latitude, dtype=np.float32)
    redundant = np.zeros(n_src, dtype=bool)

    def _sweep(candidate_mask: np.ndarray):
        order = np.flatnonzero(candidate_mask)
        for n1 in order:
            if redundant[n1]:
                continue
            later = order[order > n1]
            later = later[~redundant[later]]
            if later.size == 0:
                continue
            d = mv[later] - mv[n1][None, :]
            if method == "closest":
                sel = np.argsort(mv[n1], kind="stable")[:k]
                dt2 = (d[:, sel] ** 2).sum(axis=1)
            else:  # 'smallest'
                d2 = np.sort(d**2, axis=1)[:, :k]
                dt2 = d2.sum(axis=1)
            redundant[later[dt2 < thr2]] = True

    # pass 1: cell-local
    for i in range(len(cl) - 1):
        for j in range(len(ca) - 1):
            in_cell = (
                (lon >= cl[i]) & (lon < cl[i + 1])
                & (lat >= ca[j]) & (lat < ca[j + 1])
            )
            if in_cell.sum() > 1:
                _sweep(in_cell)
    # pass 2: global
    _sweep(np.ones(n_src, dtype=bool))
    return redundant


# ---------------------------------------------------------------------------
# Envelope characteristic functions
# ---------------------------------------------------------------------------

def envelope(traces: np.ndarray) -> np.ndarray:
    """Modulus of the analytic signal along the last axis.

    Reference: BPMF/template_search.py:1598-1617.
    """
    from scipy.signal import hilbert

    return np.abs(hilbert(np.asarray(traces), axis=-1)).astype(np.float32)


def saturated_envelopes(
    traces: np.ndarray,
    anomaly_threshold: float = 1.0e-11,
    max_dynamic_range: float = 1.0e5,
):
    """MAD-standardized, clipped envelopes + per-station availability count.

    Reference: BPMF/template_search.py:1525-1570.
    """
    from scipy.stats import median_abs_deviation as scimad

    env = envelope(traces)
    n_sta, n_comp, n_samp = env.shape
    availability = np.zeros(n_sta, dtype=np.int32)
    for s in range(n_sta):
        for c in range(n_comp):
            missing = env[s, c] == 0.0
            if missing.sum() > n_samp / 2:
                env[s, c] = 0.0
                continue
            med = np.median(env[s, c, ~missing])
            mad = scimad(env[s, c, ~missing])
            if mad < anomaly_threshold:
                env[s, c] = 0.0
                continue
            env[s, c] = (env[s, c] - med) / mad
            env[s, c, missing] = 0.0
            env[s, c] = np.minimum(env[s, c], max_dynamic_range)
            availability[s] += 1
    return env, availability
