"""Visualization (matplotlib and cartopy imported on use): the functions
of `seismic_bpmf_tpu.viz`."""

from .plots import (
    add_scale_bar,
    initialize_map,
    load_topography,
    plot_catalog,
    plot_detection,
    plot_detection_matrix,
    plot_event,
    plot_maxbeam,
    plot_recurrence_times,
    plot_space_time,
    plot_template,
    plot_time_of_day,
    plot_time_statistics,
    uncertainty_ellipse,
    vertical_uncertainty_ellipse,
)

__all__ = [
    "add_scale_bar",
    "initialize_map",
    "load_topography",
    "plot_catalog",
    "plot_detection",
    "plot_detection_matrix",
    "plot_event",
    "plot_maxbeam",
    "plot_recurrence_times",
    "plot_space_time",
    "plot_template",
    "plot_time_of_day",
    "plot_time_statistics",
    "uncertainty_ellipse",
    "vertical_uncertainty_ellipse",
]
