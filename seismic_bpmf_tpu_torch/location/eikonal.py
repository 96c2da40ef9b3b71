"""Eikonal solver for travel-time tables, in PyTorch.

Counterpart of `seismic_bpmf_tpu/location/eikonal.py` (the reference
computes its tables offline with pykonal, 4_travel_times.ipynb).  The same
parallel fast-sweeping scheme: every grid node relaxes at once,

    T[i] = min(T[i], godunov_update(T_neighbors, h / v))

for `n_iters` sweeps, with one-sided second-order upwind differences where
the two upwind neighbours are causally ordered.  The JAX package runs it in
XLA; here it is plain torch ops on the device (CUDA unless the caller asks
for the CPU), with no kernel of its own.  IEEE operations throughout: XLA
fuses multiply-adds, approximates sqrt and rsqrt on the CPU, and turns the
stencil's division by 3 into a multiply by the rounded reciprocal, whose
upward bias adds up along a ray (1.3e-3 s over 100 km of a layered f32
grid, against 5e-4 s for a true division, both held to float64).  So the
two packages agree to about 1e-6 of the times, not bit for bit.

`travel_time_grids` solves several grids at once along a leading batch
axis: every op is elementwise, so each grid gets the one-grid solve's
values, element for element.  `travel_time_grid` and
`build_travel_time_tables` keep the JAX package's per-station API; the
tables feed `TravelTimes.write_table` (the reference's HDF5 contract).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device

BIG = 1e6  # the initial time of every node outside the source ball
# `build_travel_time_tables` solves its (station, phase) grids in batches:
# a solve holds about SOLVE_WORDS grid-sized tensors at once during the
# sweeps, and a batch is cut to hold at most BATCH_BYTES of them.
SOLVE_WORDS = 40
BATCH_BYTES = 8 << 30


def solves_per_batch(n_nodes: int, itemsize: int = 4) -> int:
    """Solves of an n_nodes grid that one batch holds within BATCH_BYTES."""
    return max(1, BATCH_BYTES // (SOLVE_WORDS * itemsize * n_nodes))


def _shift(t: torch.Tensor, ax: int, d: int) -> torch.Tensor:
    """t shifted by d along ax with edge replication (values only used
    under upwind masks that exclude the replicated cells)."""
    n = t.shape[ax]
    if d > 0:
        pad = t.narrow(ax, n - 1, 1)
        return torch.cat([t.narrow(ax, d, n - d)] + [pad] * d, dim=ax)
    d = -d
    pad = t.narrow(ax, 0, 1)
    return torch.cat([pad] * d + [t.narrow(ax, 0, n - d)], dim=ax)


def _axis_operands(t: torch.Tensor, order: int):
    """Per spatial axis of t (batch, nx, ny, nz): (a, alpha), a the
    effective upwind value and alpha the scheme weight (1 first-order,
    9/4 second-order)."""
    one = torch.ones((), dtype=t.dtype, device=t.device)
    nine_quarters = torch.full((), 2.25, dtype=t.dtype, device=t.device)
    # a divisor on the device: torch's CUDA division by a Python number
    # multiplies by its rounded reciprocal, biased as XLA's (see above)
    three = torch.full((), 3.0, dtype=t.dtype, device=t.device)
    ops = []
    for ax in (1, 2, 3):
        n = t.shape[ax]
        t1m, t1p = _shift(t, ax, -1), _shift(t, ax, 1)
        t1 = torch.minimum(t1m, t1p)
        if order == 2 and n >= 5:
            t2m, t2p = _shift(t, ax, -2), _shift(t, ax, 2)
            # the upwind direction's 2nd neighbour; no second-order
            # stencil within 2 cells of the upwind edge (the shifted
            # arrays replicate edge cells there)
            shape = [1, 1, 1, 1]
            shape[ax] = n
            idx = torch.arange(n, device=t.device).view(shape)
            minus = t1m <= t1p
            t2 = torch.where(minus, t2m, t2p)
            in_grid = torch.where(minus, idx >= 2, idx <= n - 3)
            use2 = (t2 <= t1) & (t1 < BIG) & in_grid
            a2 = (4.0 * t1 - t2) / three
            ops.append((torch.where(use2, a2, t1),
                        torch.where(use2, nine_quarters, one)))
        else:
            ops.append((t1, torch.ones_like(t1)))
    return ops


def _cswap(av, aw, bv, bw):
    lo = av <= bv
    return (torch.where(lo, av, bv), torch.where(lo, aw, bw),
            torch.where(lo, bv, av), torch.where(lo, bw, aw))


def _eikonal_sweeps(slowness: torch.Tensor, t0: torch.Tensor, h: float,
                    n_iters: int = 300, order: int = 2) -> torch.Tensor:
    """Iterative Godunov upwind relaxation of |grad T| = s on regular
    grids.

    slowness, t0 : (batch, nx, ny, nz) s/km and initial times (BIG except
    near the sources), in one dtype on one device; h : the grid spacing in
    km.  `order=2` uses one-sided second-order upwind differences where the
    two upwind neighbours are causally ordered (t2 <= t1), first order
    elsewhere: O(h^2) error away from the source instead of O(h)."""
    f = slowness * torch.tensor(h, dtype=slowness.dtype,
                                device=slowness.device)
    f2 = f * f
    t = t0
    for _ in range(n_iters):
        (a1, w1), (a2, w2), (a3, w3) = _axis_operands(t, order)
        # sort the three (a, w) pairs by a with compare-swaps
        a1, w1, a2, w2 = _cswap(a1, w1, a2, w2)
        a2, w2, a3, w3 = _cswap(a2, w2, a3, w3)
        a1, w1, a2, w2 = _cswap(a1, w1, a2, w2)
        # cascade: include operands in increasing a while t > a_next
        t1c = a1 + f * torch.rsqrt(w1)
        # 2 operands: solve w1 (t-a1)^2 + w2 (t-a2)^2 = f^2, the constant
        # term expanded around a1 (no cancellation against BIG)
        A2 = w1 + w2
        B2 = w1 * a1 + w2 * a2
        d21 = a2 - a1
        disc2 = A2 * f2 - w1 * w2 * d21 * d21
        t2c = torch.where((t1c > a2) & (disc2 > 0),
                          (B2 + torch.sqrt(torch.clamp_min(disc2, 0.0)))
                          / A2, t1c)
        # 3 operands
        A3 = A2 + w3
        B3 = B2 + w3 * a3
        d31 = a3 - a1
        d32 = a3 - a2
        disc3 = (A3 * f2 - w1 * w2 * d21 * d21 - w1 * w3 * d31 * d31
                 - w2 * w3 * d32 * d32)
        t3c = torch.where((t2c > a3) & (disc3 > 0),
                          (B3 + torch.sqrt(torch.clamp_min(disc3, 0.0)))
                          / A3, t2c)
        t = torch.minimum(t, t3c)
    return t


def _initial_times(velocity_km_s: np.ndarray, source_index, spacing_km,
                   source_ball_nodes: float, dtype) -> np.ndarray:
    """BIG everywhere, and the analytic homogeneous time
    dist * slowness(source) within `source_ball_nodes` grid steps of the
    source (the JAX package's arithmetic: float64 distances, then the
    solve's dtype)."""
    nx, ny, nz = velocity_km_s.shape
    ix, iy, iz = source_index
    dist_nodes = np.sqrt(
        ((np.arange(nx) - ix) ** 2.0)[:, None, None]
        + ((np.arange(ny) - iy) ** 2.0)[None, :, None]
        + ((np.arange(nz) - iz) ** 2.0)[None, None, :]
    )
    s_src = float(1.0 / np.asarray(velocity_km_s)[tuple(source_index)])
    ball = dist_nodes <= source_ball_nodes
    t0 = np.full(velocity_km_s.shape, BIG, dtype)
    t0[ball] = dist_nodes[ball] * spacing_km * s_src
    return t0


def travel_time_grids(
    velocities: Sequence[np.ndarray],
    source_indexes: Sequence[Tuple[int, int, int]],
    spacing_km: float,
    n_iters: int = 300,
    source_ball_nodes: float = 4.0,
    order: int = 2,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """First-arrival travel times (s) of several sources at once, each on
    its own velocity grid (all of one shape): a (batch, nx, ny, nz) tensor
    on `device` (CUDA unless 'cpu' is asked for), grid b that of
    `travel_time_grid(velocities[b], source_indexes[b], ...)`."""
    dev = resolve_device(device)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    vel = [np.asarray(v) for v in velocities]
    slowness = torch.stack([
        1.0 / torch.from_numpy(np.asarray(v, np_dtype)).to(dev)
        for v in vel])
    t0 = torch.stack([
        torch.from_numpy(_initial_times(v, tuple(s), spacing_km,
                                        source_ball_nodes, np_dtype))
        for v, s in zip(vel, source_indexes)]).to(dev)
    return _eikonal_sweeps(slowness, t0, float(spacing_km),
                           n_iters=n_iters, order=order)


def travel_time_grid(
    velocity_km_s: np.ndarray,
    source_index: Tuple[int, int, int],
    spacing_km: float,
    n_iters: int = 300,
    source_ball_nodes: float = 4.0,
    order: int = 2,
    device=None,
) -> np.ndarray:
    """First-arrival travel times (s) from one source node on a regular
    grid, as a host f32 array.

    velocity_km_s : (nx, ny, nz) velocity model.

    Nodes within `source_ball_nodes` grid steps of the source start at the
    analytic homogeneous-medium time dist * slowness(source): the source
    singularity is the dominant error of upwind schemes, and the
    relaxation then only refines an already causal upper bound."""
    t = travel_time_grids([velocity_km_s], [source_index], spacing_km,
                          n_iters=n_iters,
                          source_ball_nodes=source_ball_nodes, order=order,
                          device=device)
    return t[0].cpu().numpy()


def layered_velocity_grid(
    depths_km: np.ndarray,
    vp_km_s: np.ndarray,
    vs_km_s: np.ndarray,
    grid_depths_km: np.ndarray,
    shape_xy: Tuple[int, int],
) -> Dict[str, np.ndarray]:
    """Expand a 1-D layered model (e.g. the tutorial's Karabulut 2011 CSV)
    to 3-D grids matching the eikonal solver's layout."""
    vp = np.interp(grid_depths_km, depths_km, vp_km_s)
    vs = np.interp(grid_depths_km, depths_km, vs_km_s)
    nx, ny = shape_xy
    return {
        "P": np.broadcast_to(vp, (nx, ny, len(grid_depths_km))).copy(),
        "S": np.broadcast_to(vs, (nx, ny, len(grid_depths_km))).copy(),
    }


def build_travel_time_tables(
    network,
    grid_longitudes: np.ndarray,
    grid_latitudes: np.ndarray,
    grid_depths_km: np.ndarray,
    velocity_models: Dict[str, np.ndarray],
    spacing_km: Optional[float] = None,
    output_path: Optional[str] = None,
    n_iters: int = 300,
    device=None,
):
    """Station-to-grid travel-time tables through the eikonal solver.

    For each station, solves the eikonal equation with the source at the
    nearest grid node (reciprocity) and samples all (lon, lat, depth)
    source nodes; the (station, phase) solves run in batches of
    `solves_per_batch` on `device` (CUDA unless 'cpu' is asked for).
    Writes the reference HDF5 contract if `output_path` is given (h5py
    imported then).

    Returns ({phase: {station: (n_sources,) f32}}, source coordinates)."""
    from ..data.travel_times import TravelTimes
    from ..utils.geo import geodesic_distance_km

    dev = resolve_device(device)
    nx, ny, nz = (
        len(grid_longitudes), len(grid_latitudes), len(grid_depths_km)
    )
    if spacing_km is None:
        spacing_km = geodesic_distance_km(
            grid_longitudes[0], grid_latitudes[0],
            grid_longitudes[min(1, nx - 1)], grid_latitudes[0],
        ) or 1.0
    lon_g, lat_g, dep_g = np.meshgrid(
        grid_longitudes, grid_latitudes, grid_depths_km, indexing="ij"
    )
    coords = {
        "longitude": lon_g.reshape(-1),
        "latitude": lat_g.reshape(-1),
        "depth": dep_g.reshape(-1),
    }
    items = []  # (phase, station, source node), in the JAX package's order
    for s, sta in enumerate(network.stations):
        ix = int(np.argmin(np.abs(grid_longitudes - network.longitude[s])))
        iy = int(np.argmin(np.abs(grid_latitudes - network.latitude[s])))
        iz = int(np.argmin(np.abs(grid_depths_km - network.depth[s])))
        items += [(ph, sta, (ix, iy, iz)) for ph in velocity_models]
    tts: Dict[str, Dict[str, np.ndarray]] = {ph: {} for ph in velocity_models}
    batch = solves_per_batch(nx * ny * nz)
    for b0 in range(0, len(items), batch):
        part = items[b0: b0 + batch]
        t = travel_time_grids([velocity_models[ph] for ph, _, _ in part],
                              [node for _, _, node in part], spacing_km,
                              n_iters=n_iters, device=dev)
        t = t.reshape(len(part), -1).cpu().numpy()
        for (ph, sta, _), row in zip(part, t):
            tts[ph][sta] = row.astype(np.float32)
    if output_path is not None:
        TravelTimes.write_table(output_path, tts, coords)
    return tts, coords
