"""The port's eikonal solver (`location/eikonal.py`) against the JAX
package's and against the analytic cases of tests/test_eikonal.py.

The JAX package runs the solver in XLA, whose CPU build fuses
multiply-adds and approximates sqrt and rsqrt; the port runs IEEE torch
ops.  So the two agree to about 1e-6 of the times, and are held within
1e-5 s on 17^3-25^3 grids and on tiny non-cubic ones (an axis of fewer
than 5 nodes takes the first-order branch).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seismic_bpmf_tpu.data.network import Network as JaxNetwork  # noqa: E402
from seismic_bpmf_tpu.data.travel_times import (  # noqa: E402
    TravelTimes as JaxTravelTimes,
)
from seismic_bpmf_tpu.location import eikonal as je  # noqa: E402

from seismic_bpmf_tpu_torch.data import Network  # noqa: E402
from seismic_bpmf_tpu_torch.location import eikonal as te  # noqa: E402

TOL_S = 1e-5


# ---------------------------------------------------------------------------
# the analytic cases of tests/test_eikonal.py, through the port
def test_homogeneous_matches_straight_ray():
    n = 33
    v = np.full((n, n, n), 4.0, np.float32)  # km/s
    h = 1.0  # km spacing
    src = (n // 2, n // 2, n // 2)
    t = te.travel_time_grid(v, src, h, n_iters=150, device="cpu")
    x, y, z = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    dist = h * np.sqrt(
        (x - src[0]) ** 2 + (y - src[1]) ** 2 + (z - src[2]) ** 2
    )
    want = dist / 4.0
    err = np.abs(t - want)[dist > 3.0] / want[dist > 3.0]
    assert np.median(err) < 0.01
    assert err.max() < 0.05
    assert t[src] == 0.0
    # axial rays are exact
    np.testing.assert_allclose(
        t[src[0], src[1], src[2]:], np.arange(n - src[2]) / 4.0, atol=1e-5,
    )


def test_velocity_gradient_is_faster_through_fast_layer():
    n = 25
    v = np.full((n, n, n), 3.0, np.float32)
    v[:, :, n // 2:] = 6.0  # fast half-space at depth
    t = te.travel_time_grid(v, (0, 0, 0), 1.0, n_iters=200, device="cpu")
    slow_time = np.sqrt(3) * (n - 1) / 3.0
    assert t[-1, -1, -1] < slow_time


def test_layered_model_expansion_matches_jax():
    args = (np.array([0.0, 10.0, 30.0]), np.array([5.0, 6.0, 8.0]),
            np.array([3.0, 3.5, 4.5]), np.linspace(0, 30, 16), (4, 5))
    grids = te.layered_velocity_grid(*args)
    assert grids["P"].shape == (4, 5, 16)
    assert grids["P"][0, 0, 0] == pytest.approx(5.0)
    assert grids["S"][0, 0, -1] == pytest.approx(4.5)
    want = je.layered_velocity_grid(*args)
    for ph in ("P", "S"):
        np.testing.assert_array_equal(grids[ph], want[ph])


# ---------------------------------------------------------------------------
# the port against the JAX package on the same grids
def _model(shape, kind):
    v = np.full(shape, 4.0, np.float32)
    if kind == "two_layer":
        v[:, :, shape[2] // 2:] = 6.5
    return v


@pytest.mark.parametrize("n,kind,order,src", [
    (17, "homogeneous", 2, (8, 8, 8)),
    (19, "two_layer", 1, (2, 9, 0)),
    (21, "homogeneous", 1, (0, 0, 0)),
    (25, "two_layer", 2, (5, 12, 3)),
])
def test_travel_time_grid_matches_jax(n, kind, order, src):
    v = _model((n, n, n), kind)
    want = je.travel_time_grid(v, src, 0.75, n_iters=150, order=order)
    got = te.travel_time_grid(v, src, 0.75, n_iters=150, order=order,
                              device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_S)
    assert got[src] == want[src] == 0.0


@pytest.mark.parametrize("shape,src", [
    ((4, 9, 6), (1, 4, 2)),      # x < 5 nodes: first order along x
    ((3, 5, 7), (2, 0, 6)),
    ((6, 2, 11), (3, 1, 5)),
])
def test_tiny_non_cubic_grids_match_jax(shape, src):
    v = _model(shape, "two_layer")
    want = je.travel_time_grid(v, src, 0.5, n_iters=60)
    got = te.travel_time_grid(v, src, 0.5, n_iters=60, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_S)


def test_a_batch_gives_each_grid_its_one_grid_solve():
    vs = [_model((9, 7, 8), "homogeneous"), _model((9, 7, 8), "two_layer")]
    srcs = [(4, 3, 0), (0, 6, 7)]
    batch = te.travel_time_grids(vs, srcs, 1.0, n_iters=40, device="cpu")
    for b in range(2):
        one = te.travel_time_grid(vs[b], srcs[b], 1.0, n_iters=40,
                                  device="cpu")
        np.testing.assert_array_equal(batch[b].numpy(), one)
    f64 = te.travel_time_grids(vs, srcs, 1.0, n_iters=40, device="cpu",
                               dtype=torch.float64)
    assert f64.dtype == torch.float64
    np.testing.assert_allclose(f64.numpy(), batch.numpy(), atol=1e-5)


def _networks():
    names = ["A01", "A02", "A03", "A04"]
    lat = [40.02, 40.11, 40.07, 40.15]
    lon = [30.01, 30.05, 30.16, 30.12]
    elev = [0.0, 300.0, 1200.0, 50.0]
    import pandas as pd

    jnet = JaxNetwork.from_dataframe(pd.DataFrame({
        "stations": names, "networks": ["XX"] * 4, "latitude": lat,
        "longitude": lon, "elevation_m": elev}))
    tnet = Network.from_arrays(names, networks=["XX"] * 4, latitude=lat,
                               longitude=lon, elevation_m=elev)
    return jnet, tnet


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_build_travel_time_tables_matches_jax(tmp_path, monkeypatch, batch):
    """Equal to the JAX tables however the solves fall into batches."""
    jnet, tnet = _networks()
    n_nodes = 11 * 12 * 7
    monkeypatch.setattr(te, "BATCH_BYTES",
                        batch * te.SOLVE_WORDS * 4 * n_nodes)
    assert te.solves_per_batch(n_nodes) == batch
    lons = np.linspace(30.0, 30.2, 11)
    lats = np.linspace(40.0, 40.2, 12)
    deps = np.linspace(-1.0, 8.0, 7)
    models = te.layered_velocity_grid(
        np.array([0.0, 5.0, 15.0]), np.array([4.5, 5.8, 6.3]),
        np.array([4.5, 5.8, 6.3]) / 1.75, deps, (11, 12))
    want, wcoords = je.build_travel_time_tables(jnet, lons, lats, deps,
                                                models, n_iters=80)
    path = str(tmp_path / "tts.h5")
    got, coords = te.build_travel_time_tables(
        tnet, lons, lats, deps, models, n_iters=80,
        output_path=path, device="cpu")
    for k in ("longitude", "latitude", "depth"):
        np.testing.assert_array_equal(coords[k], wcoords[k])
    assert list(got) == list(want)
    for ph in want:
        assert list(got[ph]) == list(want[ph])
        for sta in want[ph]:
            assert got[ph][sta].dtype == np.float32
            np.testing.assert_allclose(got[ph][sta], want[ph][sta], rtol=0,
                                       atol=TOL_S)
    # the file is the reference's HDF5 contract: the JAX reader takes it
    back = JaxTravelTimes("tts.h5", str(tmp_path)).read(
        ["P", "S"], read_coords=True)
    for ph in ("P", "S"):
        for sta in got[ph]:
            np.testing.assert_array_equal(back.travel_times[ph][sta],
                                          got[ph][sta])


def test_solver_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    v = np.full((5, 5, 5), 4.0, np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        te.travel_time_grid(v, (0, 0, 0), 1.0, n_iters=2)
    _, tnet = _networks()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        te.build_travel_time_tables(tnet, np.arange(3.0), np.arange(3.0),
                                    np.arange(3.0), {"P": v[:3, :3, :3]})
