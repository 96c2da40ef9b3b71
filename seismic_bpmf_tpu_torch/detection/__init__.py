"""Detection engines."""

from .beamformer import Beamformer
from .matched_filter import MatchedFilter

__all__ = ["Beamformer", "MatchedFilter"]
