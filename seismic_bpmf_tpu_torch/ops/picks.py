"""Peak picking on the host.

Only `detect_peaks` so far: the port's copy of
`seismic_bpmf_tpu.ops.picks.detect_peaks`, the peak finder of the
beamformer's detection stage (that module imports jax and pandas, so the
port keeps its own copy).  The phase pickers come with slice 3.
"""

from __future__ import annotations

import numpy as np


def detect_peaks(
    x,
    mph=None,
    mpd: int = 1,
    threshold: float = 0,
    edge: str = "rising",
    kpsh: bool = False,
    valley: bool = False,
):
    """Amplitude/distance-constrained peak detection.

    Reference parity: BPMF/utils.py:2203-2355 (Duarte's detect_peaks as
    vendored by the reference; used by the beamformer's detection stage):
    the same indices, with an `mpd` suppression that visits only each kept
    peak's neighbours.
    """
    x = np.atleast_1d(x).astype("float64")
    if x.size < 3:
        return np.array([], dtype=int)
    if valley:
        x = -x
    dx = x[1:] - x[:-1]
    indnan = np.where(np.isnan(x))[0]
    if indnan.size:
        x[indnan] = np.inf
        dx[np.where(np.isnan(dx))[0]] = np.inf
    ine, ire, ife = np.array([[], [], []], dtype=int)
    if not edge:
        ine = np.where((np.hstack((dx, 0)) < 0) & (np.hstack((0, dx)) > 0))[0]
    else:
        if edge.lower() in ["rising", "both"]:
            ire = np.where(
                (np.hstack((dx, 0)) <= 0) & (np.hstack((0, dx)) > 0)
            )[0]
        if edge.lower() in ["falling", "both"]:
            ife = np.where(
                (np.hstack((dx, 0)) < 0) & (np.hstack((0, dx)) >= 0)
            )[0]
    ind = np.unique(np.hstack((ine, ire, ife)))
    if ind.size and indnan.size:
        ind = ind[
            np.isin(
                ind,
                np.unique(np.hstack((indnan, indnan - 1, indnan + 1))),
                invert=True,
            )
        ]
    if ind.size and ind[0] == 0:
        ind = ind[1:]
    if ind.size and ind[-1] == x.size - 1:
        ind = ind[:-1]
    if ind.size and mph is not None:
        ind = ind[x[ind] >= mph]
    if ind.size and threshold > 0:
        dx2 = np.min(
            np.vstack([x[ind] - x[ind - 1], x[ind] - x[ind + 1]]), axis=0
        )
        ind = np.delete(ind, np.where(dx2 < threshold)[0])
    if ind.size and mpd > 1:
        # Greedy suppression, tallest peak first: a kept peak deletes the
        # peaks within mpd of it (with kpsh, only the lower ones).  The
        # reference rescans every peak for each kept one, O(kept x peaks):
        # ~13 s for a day of 2.16 M samples.  Here a kept peak visits only
        # its neighbours, found by binary search in position order; the
        # visiting order and so the result are the reference's.
        ind = ind[np.argsort(x[ind])][::-1]
        pos = np.sort(ind)
        rank = np.searchsorted(pos, ind).tolist()
        lo = np.searchsorted(pos, ind - mpd, side="left").tolist()
        hi = np.searchsorted(pos, ind + mpd, side="right").tolist()
        idel = np.zeros(ind.size, dtype=bool)     # in position order
        for i, r in enumerate(rank):
            if not idel[r]:
                if kpsh:
                    idel[lo[i]:hi[i]] |= x[pos[lo[i]:hi[i]]] < x[ind[i]]
                else:
                    idel[lo[i]:hi[i]] = True
                idel[r] = False
        ind = pos[~idel]
    return ind
