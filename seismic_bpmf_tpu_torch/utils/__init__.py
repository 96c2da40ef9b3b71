"""Host-side utilities: time conversion, geodesy, clustering, stacking,
statistics, filters, logging and timing (the exports of
`seismic_bpmf_tpu.utils`, and `linear_regression`)."""

from .clustering import build_families, cluster_events, cluster_templates
from .geo import (
    compute_distances,
    geodesic_distance_km,
    two_point_distance,
    two_point_epicentral_distance,
)
from .stacking import (
    fetch_detection_waveforms,
    fetch_detection_waveforms_refilter,
    svdwf,
    svdwf_multiplets,
)
from .stats import (
    cov_mat_intersection,
    event_count,
    running_mad,
    spectrogram,
    weighted_linear_regression,
)
from .time import (
    epoch_from_utc,
    round_time,
    samp_to_sec,
    sec_to_samp,
    time_range,
    utc_from_epoch,
)

__all__ = [
    "sec_to_samp",
    "samp_to_sec",
    "round_time",
    "time_range",
    "utc_from_epoch",
    "epoch_from_utc",
    "weighted_linear_regression",
    "cov_mat_intersection",
    "event_count",
    "running_mad",
    "spectrogram",
    "compute_distances",
    "geodesic_distance_km",
    "two_point_distance",
    "two_point_epicentral_distance",
    "cluster_events",
    "cluster_templates",
    "build_families",
    "svdwf",
    "svdwf_multiplets",
    "fetch_detection_waveforms",
    "fetch_detection_waveforms_refilter",
    "linear_regression",
]


def linear_regression(x, y):
    """Ordinary least-squares slope and intercept with their errors:
    (slope, intercept, slope_err, intercept_err), the errors NaN with two
    points or fewer (reference parity: BPMF/utils.py:1312-1360)."""
    import numpy as np

    x = np.asarray(x, float)
    y = np.asarray(y, float)
    n = len(x)
    A = np.vstack([x, np.ones(n)]).T
    coef, res, *_ = np.linalg.lstsq(A, y, rcond=None)
    slope, intercept = coef
    if n > 2 and len(res):
        s2 = res[0] / (n - 2)
        cov = s2 * np.linalg.inv(A.T @ A)
        return slope, intercept, np.sqrt(cov[0, 0]), np.sqrt(cov[1, 1])
    return slope, intercept, np.nan, np.nan
