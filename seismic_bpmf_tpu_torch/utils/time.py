"""Time/sample conversion helpers.

Semantics mirror BPMF/utils.py:1234-1304 (``sec_to_samp`` epsilon rounding,
``round_time``, ``time_range``) so detection timings are bit-identical to the
reference pipeline, but the implementation is vectorized and obspy-free.
"""

from __future__ import annotations

import numpy as np


def sec_to_samp(t, sr: float, epsilon: float = 0.2):
    """Convert seconds to integer samples with epsilon-guarded rounding.

    The epsilon absorbs float imprecision so that e.g. 7.9999999 s at 25 Hz
    maps to sample 200, not 199 (reference: BPMF/utils.py:1258-1271).
    Works on scalars and arrays; preserves sign.
    """
    t = np.asarray(t)
    sign = np.sign(t)
    t_samp_float = np.abs(t * sr) + epsilon
    t_samp = (sign * np.floor(t_samp_float)).astype(np.int64)
    if t_samp.ndim == 0:
        return np.int64(t_samp)
    return t_samp


def samp_to_sec(n, sr: float):
    """Convert samples to seconds."""
    return np.asarray(n, dtype=np.float64) / sr


def round_time(t, sr: float):
    """Round a time in seconds to the resolution of the sampling rate.

    Reference: BPMF/utils.py:1234-1255 (truncation toward zero in samples).
    """
    t = np.asarray(t, dtype=np.float64)
    t_samp = (t * sr).astype(np.int64)
    out = t_samp.astype(np.float64) / sr
    if out.ndim == 0:
        return float(out)
    return out


def time_range(start_time, end_time, dt_sec: float, unit: str = "ms"):
    """Range of numpy.datetime64 from start to end with step dt_sec.

    Reference: BPMF/utils.py:1274-1304.
    """
    unit_value = {"ms": 1.0e3, "us": 1.0e6, "ns": 1.0e9}
    start_time = np.datetime64(start_time)
    end_time = np.datetime64(end_time)
    dt = np.timedelta64(int(dt_sec * unit_value[unit]), unit)
    return np.arange(start_time, end_time, dt)


def utc_from_epoch(epoch_sec: float) -> np.datetime64:
    """Epoch seconds -> datetime64[ns]."""
    return np.datetime64(int(round(epoch_sec * 1e9)), "ns")


def epoch_from_utc(t) -> float:
    """datetime64 (or ISO string) -> epoch seconds as float."""
    t = np.datetime64(t, "ns")
    return float(t.astype("int64")) / 1e9


def timedelta_sec(sec: float) -> np.timedelta64:
    """Seconds -> timedelta64[ns] as `pandas.Timedelta(seconds=sec)` makes
    it: the nanoseconds truncated toward zero."""
    return np.timedelta64(int(float(sec) * 1_000_000_000), "ns")
