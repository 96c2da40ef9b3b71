"""Mesh construction and sharded detection kernels."""

from .mesh import Mesh, make_mesh
from .sharded import (
    beamform_sharded,
    beamform_sharded_pallas,
    matched_filter_sharded,
    matched_filter_sharded_pallas,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "beamform_sharded",
    "beamform_sharded_pallas",
    "matched_filter_sharded",
    "matched_filter_sharded_pallas",
]
