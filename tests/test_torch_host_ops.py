"""The port's native host scans (`ops.host_ops`, its own copy of
csrc/host_ops.cpp built with the C++ compiler at first use) against their
NumPy versions (`*_plain`) and the JAX package's `host_ops`, bit for bit
on seeded inputs; the copy's text; `available()`; no quiet fallback.
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seismic_bpmf_tpu.ops import host_ops as jhost  # noqa: E402
from seismic_bpmf_tpu_torch import _build  # noqa: E402
from seismic_bpmf_tpu_torch.ops import host_ops  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def _same(name, *args, **kwargs):
    """The native scan's result, equal to the plain version's and to the
    JAX package's (its native library where conftest built it, else its
    NumPy oracle)."""
    got = getattr(host_ops, name)(*args, **kwargs)
    np.testing.assert_array_equal(
        got, getattr(host_ops, name + "_plain")(*args, **kwargs))
    np.testing.assert_array_equal(got, getattr(jhost, name)(*args, **kwargs))
    return got


def _sweep_pairs_cut(text):
    """(the text without `sweep_pairs`, `sweep_pairs`' own text)."""
    a = text.index("static void sweep_pairs(")
    b = text.index("\n}\n", a) + 3
    return text[:a] + text[b:], text[a:b]


def test_the_copy_is_the_jax_packages_host_runtime():
    """The three other scans and the rest of the file are the JAX
    package's text; `sweep_pairs` differs only in the comparator of the
    'closest' selection, which breaks ties by station index."""
    port = (REPO / "seismic_bpmf_tpu_torch" / "csrc" / "host_ops.cpp"
            ).read_text()
    jax_text = (REPO / "csrc" / "host_ops.cpp").read_text()
    rest, sweep = _sweep_pairs_cut(port)
    jax_rest, jax_sweep = _sweep_pairs_cut(jax_text)
    assert rest.replace(
        "moveouts at n1 (the lower\n//             station index first "
        "among equal moveouts)\n", "moveouts at n1\n") == jax_rest
    heap = "[&](int64_t x, int64_t y) { return m1[x] < m1[y]; });"
    stable = ("[&](int64_t x, int64_t y) {\n"
              "                    return m1[x] < m1[y] || (m1[x] == m1[y] "
              "&& x < y);\n                });")
    assert heap in jax_sweep and stable in sweep
    assert "\n".join(ln for ln in sweep.replace(stable, heap).splitlines()
                     if not ln.lstrip().startswith("//")) == "\n".join(
        ln for ln in jax_sweep.splitlines()
        if not ln.lstrip().startswith("//"))


def test_the_library_builds_here():
    assert host_ops.available() is True


def test_a_scan_raises_where_the_library_cannot_be_built(monkeypatch):
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    assert host_ops.available() is False
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        host_ops.select_cc_indexes(np.zeros(10, np.float32), 0.5, 3)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("search_win", [0, 1, 7, 50, 4999, 5000, 20000])
def test_select_and_dedup_match(seed, search_win):
    rng = np.random.default_rng(seed)
    cc = rng.normal(size=5000).astype(np.float32)
    thr = (1.5 + 0.3 * rng.random(5000)).astype(np.float32)
    sel = _same("select_cc_indexes", cc, thr, search_win)
    assert sel.any()
    _same("select_cc_indexes", cc, 2.0, search_win)    # a scalar threshold
    cand = np.flatnonzero(cc > 1.0)
    kept = _same("dedup_detection_indexes", cand, cc, search_win)
    assert 0 < len(kept) <= len(cand)


@pytest.mark.parametrize("search_win", [-1.0, 0.5, 2.5, 7.5, np.inf])
def test_dedup_at_fractional_windows(search_win):
    """A fractional window (`MatchedFilter._search_win` at a step above
    1) keeps the reference's float comparison."""
    rng = np.random.default_rng(3)
    cc = rng.normal(size=3000).astype(np.float32)
    cand = np.flatnonzero(cc > 0.5)
    np.testing.assert_array_equal(
        host_ops.dedup_detection_indexes(cand, cc, search_win),
        host_ops.dedup_detection_indexes_plain(cand, cc, search_win))


def test_empty_series():
    empty = np.zeros(0, np.float32)
    assert len(_same("select_cc_indexes", empty, empty, 10)) == 0
    assert len(_same("select_cc_indexes", empty, 0.5, 10)) == 0
    assert len(_same("dedup_detection_indexes", np.zeros(0, np.int64),
                     empty, 10)) == 0
    assert len(_same("flag_multiples", np.zeros(0), np.zeros(0, np.int64),
                     empty)) == 0
    with pytest.raises(ValueError, match="outside"):
        host_ops.dedup_detection_indexes([3], np.zeros(3, np.float32), 5)


@pytest.mark.parametrize("tables", ["both", "dist", "cc", "none"])
@pytest.mark.parametrize("seed", [0, 1])
def test_flag_multiples_matches(tables, seed):
    rng = np.random.default_rng(40 + seed)
    n, n_tid = 400, 9
    times = np.sort(rng.uniform(0, 900.0, n))
    tid_idx = rng.integers(-1, n_tid + 1, n)         # some outside the tables
    metric = rng.uniform(0, 1, n).astype(np.float32)
    metric[10] = metric[11]                          # a tie
    dist = rng.uniform(0, 20, (n_tid, n_tid)).astype(np.float32)
    ccm = rng.uniform(-0.2, 1, (n_tid, n_tid)).astype(np.float32)
    flags = _same("flag_multiples", times, tid_idx, metric,
                  dist=dist if tables in ("both", "dist") else None,
                  ccm=ccm if tables in ("both", "cc") else None,
                  dt_criterion=4.0)
    assert 0 < flags.sum() < n


@pytest.mark.parametrize("method", ["closest", "smallest"])
@pytest.mark.parametrize("k", [None, 1, 5])
def test_find_similar_sources_matches(method, k):
    rng = np.random.default_rng(41)
    n, n_sta = 300, 8
    lon = rng.uniform(30.0, 30.4, n).astype(np.float32)
    lat = rng.uniform(40.0, 40.4, n).astype(np.float32)
    mv = (rng.uniform(0, 2, (n, 1)) + rng.uniform(0, 0.1, (n, n_sta))
          ).astype(np.float32)
    red = _same("find_similar_sources", mv, lon, lat,
                np.linspace(30.0, 30.4, 4), np.linspace(40.0, 40.4, 4), 0.05,
                num_stations_for_diff=k, method=method)
    assert 0 < red.sum() < n
    with pytest.raises(ValueError, match="num_stations_for_diff"):
        host_ops.find_similar_sources(mv, lon, lat, [30.0, 30.4],
                                      [40.0, 40.4], 0.05,
                                      num_stations_for_diff=n_sta + 1)


def test_closest_on_the_lattice_with_its_ties_broken():
    """'closest' on the first sources of `chip_smoke.py` phase 8's
    lattice (integer-sample moveouts, many tied): bit for bit once the
    ties are broken by station index (+ station / 1024 samples, exact in
    float32, every difference unchanged), the break the NumPy version's
    stable argsort makes."""
    from seismic_bpmf_tpu_torch.tools.lattice import (
        KM_PER_DEG, lattice, smooth_grid_moveouts)

    n, k = 2000, 10
    src_km = lattice(100_000, 32)[0][:n]
    mv = smooth_grid_moveouts(100_000, 32, 25.0).reshape(100_000, -1)[:n]
    mv = mv.astype(np.float32)
    assert np.array_equal(mv, np.round(mv)) and np.abs(mv).max() < 2**14
    s = np.sort(mv, axis=1)
    assert (s[:, k - 1] == s[:, k]).any()            # ties at the k-th
    edges = np.linspace(0.0, 100.0 / KM_PER_DEG + 1e-6, 11)
    red = _same("find_similar_sources",
                mv + np.arange(mv.shape[1], dtype=np.float32) / 1024,
                *(src_km[:, :2].T / KM_PER_DEG).astype(np.float32),
                edges, edges, 2.0, num_stations_for_diff=k,
                method="closest")
    assert 0 < red.sum() < n


def test_closest_on_the_lattice_as_it_is():
    """'closest' on the first sources of `chip_smoke.py` phase 8's lattice
    as it is (integer-sample moveouts, many tied at the k-th): the port's
    native marks are the NumPy version's and the JAX package's reference
    (a stable argsort keeps the smaller station index), and differ from
    the JAX package's native scan (heap order among ties) where the ties
    decide."""
    from seismic_bpmf_tpu.ops import reference as jref
    from seismic_bpmf_tpu_torch.tools.lattice import (
        KM_PER_DEG, lattice, smooth_grid_moveouts)

    n, k = 2000, 10
    src_km = lattice(100_000, 32)[0][:n]
    mv = smooth_grid_moveouts(100_000, 32, 25.0).reshape(100_000, -1)[:n]
    mv = mv.astype(np.float32)
    s = np.sort(mv, axis=1)
    assert (s[:, k - 1] == s[:, k]).sum() > 50       # ties at the k-th
    lon, lat = (src_km[:, :2].T / KM_PER_DEG).astype(np.float32)
    edges = np.linspace(0.0, 100.0 / KM_PER_DEG + 1e-6, 11)
    args = (mv, lon, lat, edges, edges, 2.0)
    kw = dict(num_stations_for_diff=k, method="closest")
    got = host_ops.find_similar_sources(*args, **kw)
    assert 0 < got.sum() < n
    np.testing.assert_array_equal(
        got, host_ops.find_similar_sources_plain(*args, **kw))
    np.testing.assert_array_equal(
        got, np.asarray(jref.find_similar_sources(*args, **kw), bool))
    if jhost.available():
        heap = jhost.find_similar_sources(*args, **kw)
        assert (heap != got).sum() > 0
