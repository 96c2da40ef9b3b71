"""Visualization (matplotlib; cartopy optional).

Counterpart of `seismic_bpmf_tpu.viz.plots` (reference parity:
BPMF/plotting_utils.py + the plot_* methods on the data classes): the
same functions and figures, on the port's numpy tables (`Catalog.catalog`
is a dict of columns, picks a `PickTable`) and on host copies of device
tensors.  matplotlib (with the Agg backend) and cartopy are imported
inside the functions; without matplotlib a call raises ImportError.  Maps
use cartopy when available and plain lon/lat axes otherwise.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

_WEEKDAYS = ["Mon", "Tues", "Wed", "Thurs", "Fri", "Sat", "Sun"]


def _plt():
    """matplotlib.pyplot on the Agg backend."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting requires matplotlib") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _ccrs():
    """cartopy.crs, or None without cartopy."""
    try:
        import cartopy.crs as ccrs
    except Exception:
        return None
    return ccrs


def _host(x) -> Optional[np.ndarray]:
    """A numpy copy of a tensor (or array-like) on the host."""
    if x is None:
        return None
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _origin_times(catalog) -> np.ndarray:
    return np.asarray(catalog.catalog["origin_time"], "datetime64[ns]")


def initialize_map(
    map_longitudes,
    map_latitudes,
    figsize=(12, 8),
    map_axis=None,
    seismic_stations: Optional[dict] = None,
    **kwargs,
):
    """Map axes with optional station markers.

    Reference parity: BPMF/plotting_utils.py:126-260 (cartopy path) with a
    plain-axes fallback when cartopy is unavailable.
    """
    plt = _plt()
    if map_axis is None:
        fig = plt.figure(figsize=figsize)
        ccrs = _ccrs()
        if ccrs is not None:
            map_axis = fig.add_subplot(111, projection=ccrs.PlateCarree())
            map_axis.coastlines()
        else:
            map_axis = fig.add_subplot(111)
            map_axis.set_xlabel("Longitude")
            map_axis.set_ylabel("Latitude")
    map_axis.set_xlim(map_longitudes)
    map_axis.set_ylim(map_latitudes)
    if seismic_stations is not None:
        map_axis.scatter(
            seismic_stations["longitude"],
            seismic_stations["latitude"],
            marker="^", c="k", s=60, zorder=5,
        )
        for lon, lat, name in zip(
            seismic_stations["longitude"],
            seismic_stations["latitude"],
            seismic_stations.get("stations", []),
        ):
            map_axis.annotate(str(name), (lon, lat), fontsize=7,
                              xytext=(2, 2), textcoords="offset points")
    return map_axis


def plot_template(template, figsize=(12, 8), **kwargs):
    """Waveform gallery of a template (reference:
    BPMF/plotting_utils.py:23-124 / dataset plot methods)."""
    plt = _plt()
    arr = _host(template.waveforms_arr)
    n_sta, n_comp, _ = arr.shape
    fig, axes = plt.subplots(
        n_sta, n_comp, figsize=figsize, sharex=True, squeeze=False
    )
    t = np.arange(arr.shape[-1]) / template.sr
    for s in range(n_sta):
        for c in range(n_comp):
            axes[s, c].plot(t, arr[s, c], lw=0.6, color="k")
            axes[s, c].set_ylabel(
                f"{template.stations[s]}.{template.components[c]}",
                fontsize=7,
            )
    axes[-1, 0].set_xlabel("Time (s)")
    fig.suptitle(f"Template {getattr(template, 'tid', template.id)}")
    return fig


def plot_detection_matrix(
    detections_arr,
    stations: Sequence[str],
    sr: float,
    figsize=(10, 8),
    **kwargs,
):
    """Stacked single-channel waveforms of a set of detections (reference:
    BPMF/plotting_utils.py:261-332)."""
    plt = _plt()
    detections_arr = _host(detections_arr)
    fig, ax = plt.subplots(figsize=figsize)
    t = np.arange(detections_arr.shape[-1]) / sr
    for i, row in enumerate(detections_arr):
        denom = np.abs(row).max() or 1.0
        ax.plot(t, i + row / (2.0 * denom), lw=0.5, color="k")
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Detection #")
    return fig


def plot_catalog(catalog, figsize=(12, 10), network=None, **kwargs):
    """Map + time series of a catalog (reference:
    BPMF/plotting_utils.py:333-512 / Catalog plot methods)."""
    plt = _plt()
    cols = catalog.catalog
    n = catalog.n_events
    fig = plt.figure(figsize=figsize)
    ax_map = fig.add_subplot(211)
    sc = ax_map.scatter(
        cols["longitude"], cols["latitude"],
        c=np.arange(n), s=12, cmap="viridis",
    )
    if network is not None:
        ax_map.scatter(network.longitude, network.latitude, marker="^",
                       c="k", s=50)
    ax_map.set_xlabel("Longitude")
    ax_map.set_ylabel("Latitude")
    fig.colorbar(sc, ax=ax_map, label="event #")
    ax_t = fig.add_subplot(212)
    ax_t.plot(_origin_times(catalog), np.arange(n), drawstyle="steps-post")
    ax_t.set_xlabel("Origin time")
    ax_t.set_ylabel("Cumulative events")
    fig.autofmt_xdate()
    return fig


def plot_maxbeam(beamformer, detection_indices=None, figsize=(14, 5)):
    """Max beam + detection threshold (reference:
    BPMF/template_search.py:974-1017)."""
    plt = _plt()
    maxbeam = _host(beamformer.maxbeam)
    fig, ax = plt.subplots(figsize=figsize)
    ax.plot(maxbeam, lw=0.5, label="max beam")
    if hasattr(beamformer, "detection_threshold"):
        ax.plot(_host(beamformer.detection_threshold), "--", color="C3",
                label="detection threshold")
    if detection_indices is not None:
        ax.plot(detection_indices, maxbeam[detection_indices],
                "o", color="C3", ms=4, label="detections")
    ax.set_xlabel("Sample")
    ax.set_ylabel("Beam")
    ax.legend(loc="upper right")
    return fig


def uncertainty_ellipse(event, ax=None, n_points: int = 100, **kwargs):
    """Horizontal uncertainty ellipse from the event covariance (reference:
    BPMF/plotting_utils.py:607-734)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    hmax = event.hmax_unc
    hmin = event.hmin_unc
    az = np.radians(event.az_hmax_unc)
    theta = np.linspace(0, 2 * np.pi, n_points)
    # ellipse in km, converted to degrees (rough local scaling)
    km_per_deg_lat = 111.19
    km_per_deg_lon = 111.19 * np.cos(np.radians(event.latitude or 0.0))
    ex = hmax * np.sin(az) * np.cos(theta) + hmin * np.cos(az) * np.sin(theta)
    ey = hmax * np.cos(az) * np.cos(theta) - hmin * np.sin(az) * np.sin(theta)
    ax.plot(
        event.longitude + ex / km_per_deg_lon,
        event.latitude + ey / km_per_deg_lat,
        **{"color": "C3", "lw": 1.0, **kwargs},
    )
    return ax


def load_topography(path: str, map_longitudes, map_latitudes):
    """Load a topography grid for map backgrounds.

    Reference parity: BPMF/plotting_utils.py `load_topography` (netCDF
    grids).  Requires the optional `netCDF4` package; returns
    (longitudes, latitudes, elevation 2-D array) cropped to the map extent.
    """
    try:
        import netCDF4
    except ImportError as e:
        raise ImportError(
            "load_topography requires the optional netCDF4 package"
        ) from e

    with netCDF4.Dataset(path) as ds:
        names = list(ds.variables)
        lon_name = next(n for n in ("lon", "longitude", "x") if n in names)
        lat_name = next(n for n in ("lat", "latitude", "y") if n in names)
        z_name = next(
            n for n in ("z", "elevation", "Band1") if n in names
        )
        lon = ds.variables[lon_name][:]
        lat = ds.variables[lat_name][:]
        sel_lon = (lon >= map_longitudes[0]) & (lon <= map_longitudes[1])
        sel_lat = (lat >= map_latitudes[0]) & (lat <= map_latitudes[1])
        z = ds.variables[z_name][sel_lat, :][:, sel_lon]
        return lon[sel_lon], lat[sel_lat], np.asarray(z)


def vertical_uncertainty_ellipse(event, ax=None, n_points: int = 100,
                                 **kwargs):
    """Vertical (horizontal-distance vs depth) uncertainty ellipse
    (reference: BPMF/plotting_utils.py `vertical_uncertainty_ellipse`)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    hmax = event.hmax_unc
    vmax = event.vmax_unc
    theta = np.linspace(0, 2 * np.pi, n_points)
    ax.plot(
        hmax * np.cos(theta),
        event.depth + vmax * np.sin(theta),
        **{"color": "C3", "lw": 1.0, **kwargs},
    )
    ax.set_xlabel("Horizontal distance (km)")
    ax.set_ylabel("Depth (km)")
    if not ax.yaxis_inverted():
        ax.invert_yaxis()
    return ax


def add_scale_bar(ax, length_km: float = 10.0, location=(0.1, 0.05),
                  **kwargs):
    """Add a horizontal scale bar in km to a lon/lat map axis (reference:
    BPMF/plotting_utils.py `add_scale_bar`)."""
    x0, x1 = ax.get_xlim()
    y0, y1 = ax.get_ylim()
    lat_mid = 0.5 * (y0 + y1)
    km_per_deg_lon = 111.19 * np.cos(np.radians(lat_mid))
    dx = length_km / km_per_deg_lon
    bx = x0 + location[0] * (x1 - x0)
    by = y0 + location[1] * (y1 - y0)
    ax.plot([bx, bx + dx], [by, by],
            **{"color": "k", "lw": 2.0, **kwargs})
    ax.annotate(f"{length_km:g} km", (bx + dx / 2.0, by), ha="center",
                va="bottom", fontsize=8)
    return ax


def plot_recurrence_times(catalog, tid=None, figsize=(10, 4), **kwargs):
    """Inter-event (recurrence) times of a detection catalog (reference:
    BPMF/dataset.py:4003-4079 `Template.plot_recurrence_times`)."""
    plt = _plt()
    t = _origin_times(catalog)
    if tid is not None and "tid" in catalog.catalog:
        t = t[np.asarray(catalog.catalog["tid"]).astype(str) == str(tid)]
    t = np.sort(t)
    if len(t) < 2:
        fig, ax = plt.subplots(figsize=figsize)
        ax.set_title("fewer than 2 events")
        return fig
    rec = np.diff(t).astype("timedelta64[s]").astype(float)
    fig, ax = plt.subplots(figsize=figsize)
    ax.semilogy(t[1:], rec, "o", ms=3, **kwargs)
    ax.set_xlabel("Origin time")
    ax.set_ylabel("Recurrence time (s)")
    fig.autofmt_xdate()
    return fig


def plot_time_of_day(catalog, figsize=(8, 4), n_bins: int = 24, **kwargs):
    """Histogram of event origin times by hour of day (reference: Catalog
    plot methods, BPMF/dataset.py:298-854)."""
    plt = _plt()
    hours = _origin_times(catalog).astype("datetime64[h]").astype(int) % 24
    fig, ax = plt.subplots(figsize=figsize)
    ax.hist(hours, bins=np.arange(n_bins + 1) - 0.5, **kwargs)
    ax.set_xlabel("Hour of day (UTC)")
    ax.set_ylabel("Events")
    ax.set_xlim(-0.5, n_bins - 0.5)
    return fig


def plot_time_statistics(catalog, UTC_local_corr: float = 0.0,
                         figsize=(16, 7), **kwargs):
    """Side-by-side day-of-week and hour-of-day histograms
    (reference parity: BPMF/dataset.py:585-617)."""
    plt = _plt()
    t = _origin_times(catalog)
    # 1970-01-01 was a Thursday: Monday is 0, as pandas' dayofweek
    day_of_week = (t.astype("datetime64[D]").astype(np.int64) + 3) % 7
    fig, axes = plt.subplots(ncols=2, nrows=1, figsize=figsize)
    axes[0].hist(day_of_week, bins=np.arange(8) - 0.5, **kwargs)
    axes[0].set_xticks(np.arange(7))
    axes[0].set_xticklabels(_WEEKDAYS)
    axes[0].set_xlabel("Day of the Week")
    axes[0].set_ylabel("Event Count")
    hours = (t.astype("datetime64[h]").astype(np.int64) % 24
             + UTC_local_corr) % 24
    axes[1].hist(hours, bins=np.arange(25) - 0.5, **kwargs)
    axes[1].set_xlabel("Hour of the Day")
    axes[1].set_ylabel("Event Count")
    return fig


def plot_space_time(catalog, axis: str = "longitude", figsize=(10, 5),
                    **kwargs):
    """Space-time scatter of the catalog along one geographic axis
    (reference: Catalog plot methods, BPMF/dataset.py:298-854)."""
    plt = _plt()
    cols = catalog.catalog
    fig, ax = plt.subplots(figsize=figsize)
    sc = ax.scatter(_origin_times(catalog), cols[axis],
                    c=cols["depth"], s=10, cmap="viridis", **kwargs)
    fig.colorbar(sc, ax=ax, label="depth (km)")
    ax.set_xlabel("Origin time")
    ax.set_ylabel(axis)
    fig.autofmt_xdate()
    return fig


def plot_detection(detection, context=None, context_sr=None,
                   context_label="", figsize=(14, 12), **kwargs):
    """Waveform gallery of a detection with an optional context panel
    below — the max beam for backprojection detections or the CC series
    for matched-filter detections (reference:
    BPMF/template_search.py:1040-1133, similarity_search.py:922-1020).

    `context`: 1-D series over the scanned day (an array or a tensor);
    the detection time is marked.  Returns the Figure.
    """
    plt = _plt()
    arr = _host(detection.waveforms_arr)
    n_sta, n_comp, _ = arr.shape
    extra = 1 if context is not None else 0
    fig, axes = plt.subplots(
        n_sta + extra, n_comp, figsize=figsize, squeeze=False,
        gridspec_kw={"height_ratios": [1] * n_sta + [2] * extra},
    )
    t = np.arange(arr.shape[-1]) / detection.sr
    for s in range(n_sta):
        for c in range(n_comp):
            ax = axes[s, c]
            ax.plot(t, arr[s, c], lw=0.6, color="k")
            ax.set_ylabel(
                f"{detection.stations[s]}.{detection.components[c]}",
                fontsize=7,
            )
            if s < n_sta - 1:
                ax.set_xticklabels([])
    axes[n_sta - 1, 0].set_xlabel("Time (s)")
    if context is not None:
        gs = axes[0, 0].get_gridspec()
        for ax in axes[n_sta]:
            ax.remove()
        ctx_ax = fig.add_subplot(gs[n_sta, :])
        context = _host(context)
        sr = context_sr or detection.sr
        tc = np.arange(len(context)) / sr
        ctx_ax.plot(tc, context, lw=0.4, color="C0",
                    label=context_label or "context")
        t_det = getattr(detection, "_context_time", None)
        if t_det is not None and 0 <= t_det < tc[-1]:
            ctx_ax.axvline(t_det, color="C3", lw=1.0, label="detection")
        ctx_ax.set_xlabel("Time in scanned data (s)")
        ctx_ax.legend(loc="upper right", fontsize=8)
    fig.suptitle(f"Detection {detection.id}")
    return fig


def plot_event(event, figsize=(12, 8), component_aliases=None, **kwargs):
    """Waveform gallery of an event with pick markers (reference:
    BPMF/dataset.py:3076-3240 `Event.plot`)."""
    plt = _plt()
    arr = _host(event.waveforms_arr)
    n_sta, n_comp, _ = arr.shape
    fig, axes = plt.subplots(n_sta, n_comp, figsize=figsize, sharex=True,
                             squeeze=False)
    t = np.arange(arr.shape[-1]) / event.sr
    picks = getattr(event, "picks_table", None)
    rows = ({} if picks is None
            else {s: i for i, s in enumerate(picks.stations)})
    for s in range(n_sta):
        sta = event.stations[s]
        for c in range(n_comp):
            ax = axes[s, c]
            ax.plot(t, arr[s, c], lw=0.6, color="k")
            ax.set_ylabel(f"{sta}.{event.components[c]}", fontsize=7)
            if sta not in rows:
                continue
            for ph, color in (("P", "C0"), ("S", "C3")):
                col = f"{ph}_picks"
                if col in picks.columns:
                    for pi in np.atleast_1d(picks.columns[col][rows[sta]]):
                        if np.isfinite(pi):
                            ax.axvline(float(pi) / event.sr,
                                       color=color, lw=0.8)
    axes[-1, 0].set_xlabel("Time (s)")
    fig.suptitle(f"Event {event.id}")
    return fig
