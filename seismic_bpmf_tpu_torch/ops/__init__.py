"""Operators of the PyTorch port: the CUDA kernels' wrappers and plain
versions (`mf`, `bp`), the torch operators and their NumPy oracles
(`reference`).

Exports the names of `seismic_bpmf_tpu.ops` that have a counterpart, each
the object of its own module; the four Pallas names have none (their
counterparts are `ops.mf.MatchedFilterPlan` and `ops.bp.BeamformPlan`).
"""

from . import reference
from .beamform import fold_components
from .bp import beamform
from .cf import envelope, kurtosis, saturated_envelopes, scalar_kurtosis
from .matched_filter import matched_filter
from .response import (cosine_sac_taper, remove_response_arr,
                       remove_response_stream)
from .signal import bandpass_zerophase, preprocess_batch, resample_fourier
from .thresholds import (bp_detection_threshold,
                         time_dependent_threshold,
                         time_dependent_threshold_pd)

__all__ = [
    "reference",
    "beamform",
    "bandpass_zerophase",
    "preprocess_batch",
    "resample_fourier",
    "fold_components",
    "matched_filter",
    "envelope",
    "kurtosis",
    "saturated_envelopes",
    "scalar_kurtosis",
    "time_dependent_threshold",
    "bp_detection_threshold",
    "time_dependent_threshold_pd",
    "cosine_sac_taper",
    "remove_response_arr",
    "remove_response_stream",
]
