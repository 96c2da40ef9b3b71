"""Order-dependent host scans of the detection and catalog paths.

`select_cc_indexes`, `dedup_detection_indexes`, `flag_multiples` and
`find_similar_sources` with the semantics of `seismic_bpmf_tpu.ops.host_ops`
(whose native library, csrc/host_ops.cpp, the JAX package calls), in
NumPy: the oracles of `ops.reference`, and for `flag_multiples` the same
sequential scan.  A native build of these scans for the port is a ROADMAP
item.
"""

from __future__ import annotations

import numpy as np

from . import reference


def select_cc_indexes(cc, threshold, search_win: int) -> np.ndarray:
    """Boolean trigger mask; see `ops.reference.select_cc_indexes`."""
    cc = np.ascontiguousarray(cc, np.float32)
    if np.ndim(threshold) == 0:
        threshold = np.full(len(cc), float(threshold), np.float32)
    threshold = np.ascontiguousarray(threshold, np.float32)
    return reference.select_cc_indexes(cc, threshold, search_win)


def dedup_detection_indexes(cc_idx, cc, search_win: int) -> np.ndarray:
    """Kept candidate indexes; see `ops.reference.dedup_detection_indexes`."""
    cc_idx = np.ascontiguousarray(cc_idx, np.int64)
    cc = np.ascontiguousarray(cc, np.float32)
    return reference.dedup_detection_indexes(cc_idx, cc, search_win)


def flag_multiples(
    times, tid_idx, metric, dist=None, ccm=None,
    dt_criterion=3.0, dist_criterion=5.0, cc_criterion=0.33,
) -> np.ndarray:
    """Unique-event mask over a time-sorted catalog: each run of
    detections within `dt_criterion` s of the last one joined, joined when
    of the first one's template, or its template within `dist_criterion`
    (`dist`, (n_tid, n_tid) by template index) or above `cc_criterion`
    (`ccm`), keeps only its best `metric` (the first of equals).  The
    tables are read in float32, the times in float64, as the native scan
    reads them (see `data.groups.TemplateGroup.remove_multiples`)."""
    times = np.ascontiguousarray(times, np.float64)
    tid_idx = np.ascontiguousarray(tid_idx, np.int64)
    metric = np.ascontiguousarray(metric, np.float32)
    dist = None if dist is None else np.asarray(dist, np.float32)
    ccm = None if ccm is None else np.asarray(ccm, np.float32)
    tables = [t for t in (dist, ccm) if t is not None]
    n_tid = tables[-1].shape[0] if tables else 0
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
    """Redundant-source mask; see `ops.reference.find_similar_sources`."""
    mv = np.ascontiguousarray(moveouts, np.float32)
    k = (mv.shape[1] if num_stations_for_diff is None
         else int(num_stations_for_diff))
    return reference.find_similar_sources(
        mv, source_longitude, source_latitude, cell_longitude,
        cell_latitude, threshold, num_stations_for_diff=k, method=method,
    )
