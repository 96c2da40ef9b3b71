"""Geodesy helpers (cartopy-free, vectorized numpy).

The part of `seismic_bpmf_tpu.utils.geo` the port uses (the network's
interstation distances, the beamformer's location-uncertainty
integrals, the events' source-receiver distances).  Replaces cartopy.geodesic.Geodesic usage in the
reference (BPMF/dataset.py:204-225) with a vectorized
WGS84 great-circle implementation (haversine on the WGS84 mean radius with
a latitude-dependent radius correction is accurate to <0.2% at regional
scales, which is well inside the tolerance of station-distance weighting
and source-receiver attenuation corrections).
"""

from __future__ import annotations

import numpy as np

WGS84_A = 6378.137  # km
WGS84_B = 6356.7523142  # km


def _earth_radius_km(lat_deg):
    """Geocentric radius of the WGS84 ellipsoid at a given latitude."""
    lat = np.radians(lat_deg)
    a, b = WGS84_A, WGS84_B
    num = (a**2 * np.cos(lat)) ** 2 + (b**2 * np.sin(lat)) ** 2
    den = (a * np.cos(lat)) ** 2 + (b * np.sin(lat)) ** 2
    return np.sqrt(num / den)


def geodesic_distance_km(lon1, lat1, lon2, lat2):
    """Great-circle distance (km) between points, broadcasting numpy-style."""
    lon1, lat1 = np.radians(lon1), np.radians(lat1)
    lon2, lat2 = np.radians(lon2), np.radians(lat2)
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    h = (
        np.sin(dlat / 2.0) ** 2
        + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2.0) ** 2
    )
    R = _earth_radius_km(np.degrees((lat1 + lat2) / 2.0))
    return 2.0 * R * np.arcsin(np.minimum(1.0, np.sqrt(h)))


def two_point_distance(lon1, lat1, depth1, lon2, lat2, depth2):
    """Hypocentral distance (km) between two points with depths in km.

    Reference parity: BPMF/utils.py:1778-1835.
    """
    d_epi = geodesic_distance_km(lon1, lat1, lon2, lat2)
    return np.sqrt(d_epi**2 + (np.asarray(depth1) - np.asarray(depth2)) ** 2)


def two_point_epicentral_distance(lat_1, lon_1, lat_2, lon_2):
    """Surface (epicentral) distance in km; note the reference's
    (lat, lon) argument order (BPMF/utils.py:1778-1802)."""
    return geodesic_distance_km(lon_1, lat_1, lon_2, lat_2)


def compute_distances(
    source_longitudes,
    source_latitudes,
    source_depths,
    receiver_longitudes,
    receiver_latitudes,
    receiver_depths,
):
    """(n_sources, n_receivers) hypocentral distance matrix in km.

    Reference parity: BPMF/utils.py:1419-1498.
    """
    slon = np.asarray(source_longitudes)[:, None]
    slat = np.asarray(source_latitudes)[:, None]
    sdep = np.asarray(source_depths)[:, None]
    rlon = np.asarray(receiver_longitudes)[None, :]
    rlat = np.asarray(receiver_latitudes)[None, :]
    rdep = np.asarray(receiver_depths)[None, :]
    d_epi = geodesic_distance_km(slon, slat, rlon, rlat)
    return np.sqrt(d_epi**2 + (sdep - rdep) ** 2)
