"""Statistical helpers: weighted regression, running MAD, seismicity-rate
counting, location-uncertainty ellipse intersection, spectrogram.

Copy of `seismic_bpmf_tpu.utils.stats` (reference parity:
BPMF/utils.py:1334-1372 weighted_linear_regression, :1374-1417
cov_mat_intersection, :1501-1588 event_count, :1671-1714 running_mad,
:1715-1777 spectrogram), numpy and scipy on the host.  `event_count`
returns a pandas Series, as the JAX package's does, and imports pandas
there; `data.Catalog.event_count` keeps its own pandas-free series of
fixed-duration bins.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "weighted_linear_regression",
    "cov_mat_intersection",
    "event_count",
    "running_mad",
    "spectrogram",
]


def weighted_linear_regression(x, y, w=None):
    """Weighted least-squares line fit.

    Returns (slope, intercept, slope_err) like the reference
    (BPMF/utils.py:1334-1366).

    Intentional divergence: the reference computes the residual variance as
    ``sum(resid)**2`` (BPMF/utils.py:1363), which is ~0 by construction for
    a least-squares fit with intercept, making its ``slope_err`` always
    ~0.  This implementation uses the standard ``sum(resid**2)`` so the
    returned error estimate is meaningful.
    """
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    w = np.ones_like(x) if w is None else np.asarray(w, float)
    w_sum = w.sum()
    x_mean = (w * x).sum() / w_sum
    y_mean = (w * y).sum() / w_sum
    x_var = (w * (x - x_mean) ** 2).sum()
    xy_cov = (w * (x - x_mean) * (y - y_mean)).sum()
    slope = xy_cov / x_var
    intercept = y_mean - slope * x_mean
    resid = intercept + slope * x - y
    n = x.size
    s2 = (resid**2).sum() / max(n - 2, 1)
    s2_slope = s2 / ((n - 1) * x_var)
    return slope, intercept, float(np.sqrt(s2_slope))


def cov_mat_intersection(cov_mat, axis1: int = 0, axis2: int = 1):
    """Intersect a 3x3 location covariance with a coordinate plane.

    Eigendecomposition of the (axis1, axis2) restriction, scaled to the
    68 %-confidence ellipse (2 dof).  Coordinate convention (X west,
    Y south, Z up) and return values (max_unc, min_unc, az_max, az_min)
    match BPMF/utils.py:1374-1417; azimuths in degrees from `axis2`.
    """
    s_68_2df = 2.28
    idx = np.array([axis1, axis2])
    w, v = np.linalg.eigh(np.asarray(cov_mat)[idx, :][:, idx])
    semi = np.sqrt(s_68_2df * np.abs(w))
    max_dir = v[:, w.argmax()]
    az_max = float(np.degrees(np.arctan2(max_dir[0], max_dir[1])))
    az_min = (az_max + 90.0) % 360.0
    return float(semi.max()), float(semi.min()), az_max, az_min


def event_count(
    event_timings,
    start_date,
    end_date,
    freq: str = "1D",
    offset: float = 0.0,
    trim_start: bool = True,
    trim_end: bool = False,
    mode: str = "end",
):
    """Binned seismicity-rate series over [start_date, end_date].

    Returns a pandas Series indexed by bin time with event counts, with
    the reference's conventions (BPMF/utils.py:1501-1588): `mode='end'`
    labels each bin by its right edge, `offset` shifts bin edges by a
    fraction of `freq`, and the series is zero-padded to span the
    requested range.

    `offset` (a fraction of `freq`) is implemented by shifting the event
    times before binning and shifting the bin labels back, so it works for
    any fixed-duration frequency (D/W/h/min/s/...).  Calendar-dependent
    frequencies (M/Y) have no fixed duration and raise with a nonzero
    offset (pandas silently ignores the offset there, which the reference
    inherits).
    """
    import pandas as pd

    if mode not in ("end", "beginning"):
        raise ValueError("mode should be 'end' or 'beginning'")

    def _freq_timedelta(f):
        # fixed-duration frequencies only; bare units ('D', 'W', 'min')
        # are valid Grouper freqs but not Timedelta strings, so classify
        # via the offset object (pd.Timedelta('1MS') would silently parse
        # month-start as milliseconds)
        from pandas.tseries.frequencies import to_offset
        from pandas.tseries.offsets import Day, Tick, Week

        o = to_offset(f)
        if isinstance(o, Tick):
            return pd.Timedelta(o.nanos, unit="ns")
        if isinstance(o, Day):
            return pd.Timedelta(days=o.n)
        if isinstance(o, Week):
            # anchored or not, a week is a fixed 7-day duration
            return pd.Timedelta(days=7 * o.n)
        raise ValueError(
            f"offset={offset} cannot be applied to calendar-dependent "
            f"frequency {f!r} (no fixed duration)"
        )
    start_date = pd.to_datetime(str(start_date).replace(",", "-"))
    end_date = pd.to_datetime(str(end_date).replace(",", "-"))
    times = pd.to_datetime(np.asarray(event_timings).astype("U"))
    occurrence = pd.Series(
        np.ones(len(times), np.int32), index=times.astype("datetime64[ns]")
    )
    # zero sentinels pin the grouper to the requested range
    occurrence[start_date] = 0
    occurrence[end_date] = 0
    label = "right" if mode == "end" else "left"
    shift = None
    if offset != 0.0:
        shift = _freq_timedelta(freq) * float(offset)
        occurrence.index = occurrence.index - shift
    counts = occurrence.groupby(
        pd.Grouper(freq=freq, label=label)
    ).agg("sum")
    if shift is not None:
        counts.index = counts.index + shift
    from pandas.tseries.frequencies import to_offset

    step = to_offset(freq)  # DateOffset arithmetic: calendar freqs too
    first, last = counts.index[0], counts.index[-1]
    if first > start_date:
        counts[first - step] = 0
    if last < end_date:
        counts[last + step] = 0
    if trim_start or offset == 0.0:
        counts = counts[counts.index >= start_date]
    if trim_end or offset == 0.0:
        stop = end_date + step if offset > 0.0 else end_date
        counts = counts[counts.index <= stop]
    return counts.sort_index()


def running_mad(
    time_series,
    window: int,
    n_mad: float = 10.0,
    overlap: float = 0.75,
):
    """Sliding median + n_mad * MAD, linearly interpolated to every sample.

    Vectorized windowing (stride tricks) instead of the reference's
    Python loop (BPMF/utils.py:1671-1714); same window/overlap/boundary
    conventions.
    """
    x = np.asarray(time_series, np.float32)
    shift = max(int((1.0 - overlap) * window), 1)
    n_windows = int((len(x) - window) // shift) + 1
    if n_windows < 1:
        med = np.median(x)
        mad = np.median(np.abs(x - med))  # unscaled MAD, like the reference
        return np.full(len(x), med + n_mad * mad, np.float32)
    starts = shift * np.arange(1, n_windows + 1)
    # clip the last windows to the series end like the reference
    ends = np.minimum(starts + window, len(x))
    full = starts + window <= len(x)
    idx = starts[full, None] + np.arange(window)[None, :]
    wins = x[idx]
    med = np.median(wins, axis=1)
    mad = np.median(np.abs(wins - med[:, None]), axis=1)
    stats = np.empty(n_windows, np.float32)
    centers = (starts + ends) / 2.0
    stats[: len(med)] = med + n_mad * mad
    for j in np.flatnonzero(~full):  # ragged tail windows (at most a few)
        seg = x[starts[j] : ends[j]]
        m = np.median(seg)
        stats[j] = m + n_mad * np.median(np.abs(seg - m))
    t = np.concatenate([[0.0], centers, [float(len(x))]])
    s = np.concatenate([[stats[0]], stats, [stats[-1]]])
    return np.interp(np.arange(len(x), dtype=np.float64), t, s).astype(
        np.float32
    )


def spectrogram(x, window_duration_sec, overlap, sampling_rate,
                detrend=False, window="hann", nfft=None, boundary=None,
                padded=False, scaling="spectrum"):
    """Short-time spectral amplitude |STFT| of a 1-D trace.

    Signature and conventions of BPMF/utils.py:1715-1777.  Returns
    (frequencies_hz, times_s, |stft|).
    """
    from scipy.signal import stft

    nperseg = int(window_duration_sec * sampling_rate)
    f, t, spec = stft(
        np.asarray(x), sampling_rate, nperseg=nperseg,
        noverlap=int(overlap * nperseg), detrend=detrend, window=window,
        nfft=nfft, boundary=boundary, padded=padded, scaling=scaling,
    )
    return f, t, np.abs(spec)
