"""Order-dependent host scans of the detection and catalog paths.

Counterpart of `seismic_bpmf_tpu.ops.host_ops`: ctypes bindings, with its
signatures, to the package's own copy of the JAX package's native host
runtime, ``csrc/host_ops.cpp``, which `_build.load_host` compiles with the
C++ compiler at first use; and to the port's own ``csrc/peaks.cpp``, the
`mpd` suppression of `ops.picks.detect_peaks` (`peak_suppression`).  Where
the JAX module drops silently to NumPy when its library is missing, a scan
here raises (naming the compiler): `available()` says whether the
libraries build and load.  The NumPy versions (`*_plain`: the oracles of
`ops.reference`, and for `flag_multiples` the same sequential scan) are
what the tests hold the native scans to.
"""

from __future__ import annotations

import ctypes as C
import math

import numpy as np

from . import reference

_BOUND: set = set()


def _lib():
    from .. import _build

    lib = _build.load_host("host_ops")
    if "host_ops" not in _BOUND:
        f32, i32 = C.POINTER(C.c_float), C.POINTER(C.c_int32)
        lib.select_cc_indexes.argtypes = [f32, f32, C.c_int64, C.c_int64,
                                          i32]
        lib.dedup_detections.argtypes = [C.POINTER(C.c_int64), f32,
                                         C.c_int64, C.c_int64, i32]
        lib.flag_multiples.argtypes = [
            C.POINTER(C.c_double), C.POINTER(C.c_int64), f32, C.c_int64,
            f32, f32, C.c_int64, C.c_double, C.c_float, C.c_float, i32,
        ]
        lib.find_similar_moveouts.argtypes = [
            f32, f32, f32, f32, f32, C.c_float, C.c_int64, C.c_int64,
            C.c_int64, C.c_int64, C.c_int64, C.c_int32, i32,
        ]
        for fn in (lib.select_cc_indexes, lib.dedup_detections,
                   lib.flag_multiples, lib.find_similar_moveouts):
            fn.restype = None
        _BOUND.add("host_ops")
    return lib


def _peaks_lib():
    from .. import _build

    lib = _build.load_host("peaks")
    if "peaks" not in _BOUND:
        lib.peak_suppression.argtypes = [
            C.POINTER(C.c_int64), C.POINTER(C.c_double),
            C.POINTER(C.c_int64), C.c_int64, C.c_int64, C.c_int32,
            C.POINTER(C.c_uint8),
        ]
        lib.peak_suppression.restype = None
        _BOUND.add("peaks")
    return lib


def available() -> bool:
    """True when the native libraries build (or are built) and load."""
    try:
        _lib()
        _peaks_lib()
    except (RuntimeError, OSError):
        return False
    return True


def _fptr(x):
    return x.ctypes.data_as(C.POINTER(C.c_float))


def _iptr(x):
    return x.ctypes.data_as(C.POINTER(C.c_int32))


def select_cc_indexes(cc, threshold, search_win: int) -> np.ndarray:
    """Boolean trigger mask; see `ops.reference.select_cc_indexes`."""
    cc = np.ascontiguousarray(cc, np.float32)
    n = len(cc)
    if np.ndim(threshold) == 0:
        threshold = np.full(n, float(threshold), np.float32)
    threshold = np.ascontiguousarray(threshold, np.float32)
    if threshold.shape != cc.shape:
        raise ValueError(f"threshold of shape {threshold.shape} for a CC "
                         f"series of {n}")
    sel = np.zeros(n, np.int32)
    _lib().select_cc_indexes(_fptr(cc), _fptr(threshold), int(search_win),
                             n, _iptr(sel))
    return sel.astype(bool)


def select_cc_indexes_plain(cc, threshold, search_win: int) -> np.ndarray:
    """`select_cc_indexes` in NumPy (`ops.reference`)."""
    cc = np.ascontiguousarray(cc, np.float32)
    if np.ndim(threshold) == 0:
        threshold = np.full(len(cc), float(threshold), np.float32)
    threshold = np.ascontiguousarray(threshold, np.float32)
    return reference.select_cc_indexes(cc, threshold, search_win)


def dedup_detection_indexes(cc_idx, cc, search_win: float) -> np.ndarray:
    """Kept candidate indexes; see `ops.reference.dedup_detection_indexes`.

    `search_win` may be fractional (`MatchedFilter._search_win` divides
    by the step): two indexes closer than it are closer than its ceiling,
    the whole window the C scan compares with, so the mask is the
    reference's (the JAX module truncates the window instead)."""
    cc_idx = np.ascontiguousarray(cc_idx, np.int64)
    cc = np.ascontiguousarray(cc, np.float32)
    if len(cc_idx) and (cc_idx.min() < 0 or cc_idx.max() >= len(cc)):
        raise ValueError("candidate indexes outside the CC series")
    win = math.ceil(min(max(search_win, 0), 2**62))
    keep = np.zeros(len(cc_idx), np.int32)
    _lib().dedup_detections(cc_idx.ctypes.data_as(C.POINTER(C.c_int64)),
                            _fptr(cc), len(cc_idx), win, _iptr(keep))
    return cc_idx[keep.astype(bool)]


def dedup_detection_indexes_plain(cc_idx, cc, search_win: float) -> np.ndarray:
    """`dedup_detection_indexes` in NumPy (`ops.reference`)."""
    cc_idx = np.ascontiguousarray(cc_idx, np.int64)
    cc = np.ascontiguousarray(cc, np.float32)
    return reference.dedup_detection_indexes(cc_idx, cc, search_win)


def _catalog_arrays(times, tid_idx, metric, dist, ccm):
    """The scan's inputs as the native scan reads them: times float64,
    template indexes int64, the metric and the (n_tid, n_tid) tables
    float32; n_tid from the tables (the CC table's where both are
    given), 0 without."""
    times = np.ascontiguousarray(times, np.float64)
    tid_idx = np.ascontiguousarray(tid_idx, np.int64)
    metric = np.ascontiguousarray(metric, np.float32)
    if not len(times) == len(tid_idx) == len(metric):
        raise ValueError("times, tid_idx and metric differ in length")
    dist = None if dist is None else np.ascontiguousarray(dist, np.float32)
    ccm = None if ccm is None else np.ascontiguousarray(ccm, np.float32)
    tables = [t for t in (dist, ccm) if t is not None]
    n_tid = tables[-1].shape[0] if tables else 0
    if any(t.shape != (n_tid, n_tid) for t in tables):
        raise ValueError("dist and ccm must be square and of one size")
    return times, tid_idx, metric, dist, ccm, n_tid


def flag_multiples(
    times, tid_idx, metric, dist=None, ccm=None,
    dt_criterion=3.0, dist_criterion=5.0, cc_criterion=0.33,
) -> np.ndarray:
    """Unique-event mask over a time-sorted catalog (see
    `flag_multiples_plain`, and `data.groups.TemplateGroup.remove_multiples`
    for the table lookup by template id)."""
    times, tid_idx, metric, dist, ccm, n_tid = _catalog_arrays(
        times, tid_idx, metric, dist, ccm)
    out = np.zeros(len(times), np.int32)
    _lib().flag_multiples(
        times.ctypes.data_as(C.POINTER(C.c_double)),
        tid_idx.ctypes.data_as(C.POINTER(C.c_int64)), _fptr(metric),
        len(times), None if dist is None else _fptr(dist),
        None if ccm is None else _fptr(ccm), n_tid, float(dt_criterion),
        float(dist_criterion), float(cc_criterion), _iptr(out))
    return out.astype(bool)


def flag_multiples_plain(
    times, tid_idx, metric, dist=None, ccm=None,
    dt_criterion=3.0, dist_criterion=5.0, cc_criterion=0.33,
) -> np.ndarray:
    """Unique-event mask over a time-sorted catalog: each run of
    detections within `dt_criterion` s of the last one joined, joined when
    of the first one's template, or its template within `dist_criterion`
    (`dist`, (n_tid, n_tid) by template index) or above `cc_criterion`
    (`ccm`), keeps only its best `metric` (the first of equals).  The
    tables are read in float32, the times in float64, as the native scan
    reads them."""
    times, tid_idx, metric, dist, ccm, n_tid = _catalog_arrays(
        times, tid_idx, metric, dist, ccm)
    dist_c, cc_c = np.float32(dist_criterion), np.float32(cc_criterion)
    n = len(times)
    unique = np.ones(n, bool)
    i = 0
    while i < n:
        group = [i]
        j = i + 1
        while j < n and times[j] - times[group[-1]] <= dt_criterion:
            a, b = tid_idx[group[0]], tid_idx[j]
            close = a == b
            if not close and 0 <= a < n_tid and 0 <= b < n_tid:
                close = ((dist is not None and dist[a, b] <= dist_c)
                         or (ccm is not None and ccm[a, b] >= cc_c))
            if close:
                group.append(j)
            j += 1
        if len(group) > 1:
            best = group[0]
            for g in group:
                if metric[g] > metric[best]:
                    best = g
            unique[[g for g in group if g != best]] = False
        i = group[-1] + 1
    return unique


def find_similar_sources(
    moveouts, source_longitude, source_latitude, cell_longitude,
    cell_latitude, threshold, num_stations_for_diff=None, method="closest",
) -> np.ndarray:
    """Redundant-source mask; see `ops.reference.find_similar_sources`.
    The native scan takes `threshold` in float32 and forms k * threshold^2
    in float32, and its 'closest' stations come from a partial sort: at an
    exact tie (of a sum with that bound, or of moveouts at the k-th
    station) it may decide otherwise than the NumPy version."""
    if method not in ("closest", "smallest"):
        raise ValueError(f"method must be 'closest' or 'smallest', got "
                         f"{method!r}")
    mv = np.ascontiguousarray(moveouts, np.float32)
    n_src, n_sta = mv.shape
    k = n_sta if num_stations_for_diff is None else int(num_stations_for_diff)
    if not 1 <= k <= n_sta:
        raise ValueError(f"num_stations_for_diff {k} outside [1, {n_sta}]")
    lon, lat, cl, ca = (np.ascontiguousarray(a, np.float32) for a in (
        source_longitude, source_latitude, cell_longitude, cell_latitude))
    if lon.shape != (n_src,) or lat.shape != (n_src,):
        raise ValueError("one longitude and latitude a source")
    out = np.zeros(n_src, np.int32)
    _lib().find_similar_moveouts(
        _fptr(mv), _fptr(lon), _fptr(lat), _fptr(cl), _fptr(ca),
        float(threshold), n_src, n_sta, len(cl) - 1, len(ca) - 1, k,
        1 if method == "closest" else 0, _iptr(out))
    return out.astype(bool)


def find_similar_sources_plain(
    moveouts, source_longitude, source_latitude, cell_longitude,
    cell_latitude, threshold, num_stations_for_diff=None, method="closest",
) -> np.ndarray:
    """`find_similar_sources` in NumPy (`ops.reference`)."""
    mv = np.ascontiguousarray(moveouts, np.float32)
    k = (mv.shape[1] if num_stations_for_diff is None
         else int(num_stations_for_diff))
    return reference.find_similar_sources(
        mv, source_longitude, source_latitude, cell_longitude,
        cell_latitude, threshold, num_stations_for_diff=k, method=method,
    )


def _peak_arrays(pos, xpos, order):
    pos = np.ascontiguousarray(pos, np.int64)
    xpos = np.ascontiguousarray(xpos, np.float64)
    order = np.ascontiguousarray(order, np.int64)
    if not len(pos) == len(xpos) == len(order):
        raise ValueError("pos, xpos and order differ in length")
    if len(order) and (order.min() < 0 or order.max() >= len(pos)):
        raise ValueError("visiting order outside the peaks")
    return pos, xpos, order


def peak_suppression(pos, xpos, order, mpd: int,
                     kpsh: bool = False) -> np.ndarray:
    """Keep mask, in position order, of the peaks at ascending `pos`
    visited in `order`; see `ops.reference.peak_suppression`."""
    pos, xpos, order = _peak_arrays(pos, xpos, order)
    keep = np.zeros(len(pos), np.uint8)
    _peaks_lib().peak_suppression(
        pos.ctypes.data_as(C.POINTER(C.c_int64)),
        xpos.ctypes.data_as(C.POINTER(C.c_double)),
        order.ctypes.data_as(C.POINTER(C.c_int64)), len(pos),
        int(min(mpd, 2**62)), 1 if kpsh else 0,
        keep.ctypes.data_as(C.POINTER(C.c_uint8)))
    return keep.view(bool)


def peak_suppression_plain(pos, xpos, order, mpd: int,
                           kpsh: bool = False) -> np.ndarray:
    """`peak_suppression` in NumPy (`ops.reference`)."""
    return reference.peak_suppression(*_peak_arrays(pos, xpos, order),
                                      mpd, kpsh)
