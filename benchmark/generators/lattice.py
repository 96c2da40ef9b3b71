"""Frozen copy of `seismic_bpmf_tpu_torch/tools/lattice.py` at commit
8978ca3, kept with the benchmark so that a later change to the tool cannot
move the benchmark's grid; only this docstring differs.

The backprojection configuration of the JAX package's benchmark
(`bench.py:378-430`, `smooth_grid_moveouts` and `bench_bp`): a ~100 km
lattice of sources (lon x lat x depth, depth fastest), stations scattered
on the surface from a seed, straight-ray P/S travel times at 6.0/3.4 km/s,
closest-10-station source weights.
"""

from __future__ import annotations

import numpy as np

VP_KM_S, VS_KM_S = 6.0, 3.4
KM_PER_DEG = 111.19  # degrees of the synthetic map, at 0 deg latitude


def lattice(n_src: int, n_sta: int = 32, seed: int = 1, rng=None):
    """Sources (n_src, 3) and stations (n_sta, 3) as x, y, depth in km,
    and the lattice's (nx, ny, nz) spacings in km.  The stations are two
    uniform draws of `rng` (a numpy Generator, default_rng(seed) unless
    given), which a caller may go on drawing from."""
    rng = np.random.default_rng(seed) if rng is None else rng
    nz = max(2, int(round((n_src / 64) ** (1.0 / 3.0))))
    nxy = int(np.ceil(np.sqrt(n_src / nz)))
    xs = np.linspace(0.0, 100.0, nxy)
    zs = np.linspace(2.0, 30.0, nz)
    gx, gy, gz = np.meshgrid(xs, xs, zs, indexing="ij")
    src = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)[:n_src]
    sta = np.column_stack([
        rng.uniform(0, 100, n_sta), rng.uniform(0, 100, n_sta),
        np.zeros(n_sta),
    ])
    spacing = np.array([xs[1] - xs[0], xs[1] - xs[0], zs[1] - zs[0]])
    return src, sta, spacing


def travel_times(src: np.ndarray, sta: np.ndarray) -> np.ndarray:
    """(n_src, n_sta, 2) straight-ray P and S times in seconds."""
    d = np.linalg.norm(src[:, None, :] - sta[None, :, :], axis=2)
    return np.stack([d / VP_KM_S, d / VS_KM_S], axis=2)


def smooth_grid_moveouts(n_src: int, n_sta: int = 32, sr_hz: float = 25.0,
                         seed: int = 1) -> np.ndarray:
    """(n_src, n_sta, 2) int32 moveouts in samples, relative to each
    source's first arrival (the BPMF convention)."""
    src, sta, _ = lattice(n_src, n_sta, seed)
    mv = np.round(travel_times(src, sta) * sr_hz).astype(np.int32)
    mv -= mv.min(axis=(1, 2), keepdims=True)
    return mv


def closest_weights(mv: np.ndarray, k: int = 10) -> np.ndarray:
    """(n_src, n_sta) source weights 1/k on the k stations of smallest P
    moveout, 0 elsewhere."""
    closest = np.argsort(mv[:, :, 0], axis=1)[:, :k]
    w = np.zeros(mv.shape[:2], np.float32)
    np.put_along_axis(w, closest, 1.0 / k, axis=1)
    return w
