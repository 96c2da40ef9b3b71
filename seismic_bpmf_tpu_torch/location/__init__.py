"""Earthquake location: NLLoc glue, eikonal travel times (beam relocation
is `Event.relocate_beam`).  Counterpart of `seismic_bpmf_tpu.location`."""

from .eikonal import (
    build_travel_time_tables,
    layered_velocity_grid,
    travel_time_grid,
)
from .nlloc import (
    read_nlloc_outputs,
    relocate_nlloc,
    write_nlloc_control,
    write_nlloc_grids,
    write_nlloc_obs,
)

__all__ = [
    "build_travel_time_tables",
    "layered_velocity_grid",
    "travel_time_grid",
    "read_nlloc_outputs",
    "relocate_nlloc",
    "write_nlloc_control",
    "write_nlloc_grids",
    "write_nlloc_obs",
]
