"""Source parameters: displacement spectra and moment magnitudes."""

from .spectrum import (
    Spectrum,
    approximate_moment_magnitude,
    snr_based_weights,
    boatwright,
    brune,
    compute_moment_magnitude,
    extract_windows,
    fc_circular_crack,
    magnitude_to_moment,
    moment_to_magnitude,
    stress_drop_circular_crack,
)

__all__ = [
    "Spectrum",
    "approximate_moment_magnitude",
    "snr_based_weights",
    "boatwright",
    "brune",
    "compute_moment_magnitude",
    "extract_windows",
    "fc_circular_crack",
    "magnitude_to_moment",
    "moment_to_magnitude",
    "stress_drop_circular_crack",
]
