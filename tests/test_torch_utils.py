"""The port's host utilities and catalog helpers against the JAX package's,
on the CPU, with seeded numpy inputs.

- `utils.filters`, `utils.stats`, `utils.clustering` and
  `utils.linear_regression` run the same numpy and scipy code: their
  outputs are equal (bit for bit; `event_count` as pandas Series).
- `utils.stacking.svdwf`: the host route (`svdwf_panels_host`) is the JAX
  computation, so its float32 cast equals the JAX output bit for bit; the
  torch route (`svdwf_panels`, batched SVD and Wiener filter in torch)
  lies within 1e-10 of the host route's maximum in float64.
- `ops.host_ops.flag_multiples` and `find_similar_sources` against the JAX
  package's native scans and NumPy oracle: equal masks.
- `time_dependent_threshold_pd`, `Network.datelist` / `box`,
  `Catalog.read_from_dataframe`, `grid_travel_times`,
  `load_travel_times` and `get_moveout_array`: equal values.
- `data_reader_pyasdf` raises ImportError naming pyasdf (pyasdf is not
  installed).
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import seismic_bpmf_tpu.utils as jutils  # noqa: E402
from seismic_bpmf_tpu.data import Catalog as JCatalog  # noqa: E402
from seismic_bpmf_tpu.data import Network as JNetwork  # noqa: E402
from seismic_bpmf_tpu.data import travel_times as jtt  # noqa: E402
from seismic_bpmf_tpu.data.stream import Stream as JStream  # noqa: E402
from seismic_bpmf_tpu.data.stream import Trace as JTrace  # noqa: E402
from seismic_bpmf_tpu.ops import host_ops as jhost  # noqa: E402
from seismic_bpmf_tpu.ops import reference as jref  # noqa: E402
from seismic_bpmf_tpu.ops import thresholds as jthr  # noqa: E402
from seismic_bpmf_tpu.utils import filters as jfilters  # noqa: E402
from seismic_bpmf_tpu.utils import stacking as jstacking  # noqa: E402
from seismic_bpmf_tpu.utils import stats as jstats  # noqa: E402

import seismic_bpmf_tpu_torch.utils as tutils  # noqa: E402
from seismic_bpmf_tpu_torch.data import (  # noqa: E402
    Catalog, Network, Stream, Trace, data_reader_pyasdf, get_moveout_array,
    grid_travel_times, load_travel_times,
)
from seismic_bpmf_tpu_torch.data.travel_times import TravelTimes  # noqa: E402
from seismic_bpmf_tpu_torch.ops import host_ops, reference  # noqa: E402
from seismic_bpmf_tpu_torch.ops import thresholds  # noqa: E402
from seismic_bpmf_tpu_torch.utils import filters, stacking, stats  # noqa: E402

RTOL_SVDWF = 1e-10


def _eq(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# filters, statistics, regression: the same numpy and scipy code
# ---------------------------------------------------------------------------
def _signal(seed=0, shape=(3, 1000)):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 25.0
    return (rng.normal(size=shape) + np.sin(2 * np.pi * 3.0 * t)
            + 0.01 * t)


FILTER_CASES = {
    "max_norm": lambda m: m.max_norm(_signal()),
    "max_norm_zero": lambda m: m.max_norm(np.zeros(5)),
    "bandpass": lambda m: m.bandpass_filter(_signal()),
    "bandpass_causal": lambda m: m.bandpass_filter(
        _signal(1), filter_order=2, freqmin=1.0, freqmax=6.0, f_Nyq=12.5,
        taper_alpha=0.1, zerophase=False),
    "cheby1": lambda m: m.lowpass_chebyshev_I(_signal()[0], 5.0, 25.0),
    "cheby1_zerophase": lambda m: m.lowpass_chebyshev_I(
        _signal(2)[0], 3.0, 25.0, order=4, zerophase=True),
    "cheby2": lambda m: m.lowpass_chebyshev_II(_signal()[0], 5.0, 25.0),
    "cheby2_zerophase": lambda m: m.lowpass_chebyshev_II(
        _signal(3)[0], 4.0, 25.0, zerophase=True),
}


@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_filters_match_jax(case):
    _eq(FILTER_CASES[case](filters), FILTER_CASES[case](jfilters))


@pytest.mark.parametrize("target_sr", [None, 25.0])
def test_preprocess_stream_matches_jax(target_sr):
    x = _signal(4, (2, 50 * 100)).astype(np.float32)
    out = []
    for S, T, m in ((Stream, Trace, filters), (JStream, JTrace, jfilters)):
        st = S([T(x[i], station="A", channel=f"HH{c}", sampling_rate=50.0,
                  starttime=1343260800.0) for i, c in enumerate("NZ")])
        st += T(x[0, :10], station="B", channel="HHZ", sampling_rate=50.0,
                starttime=1343260800.0)          # too short: dropped
        m.preprocess_stream(st, freqmin=1.0, freqmax=8.0,
                            target_SR=target_sr,
                            minimum_chunk_duration=60.0, verbose=False)
        out.append([(tr.stats.station, tr.stats.channel,
                     tr.stats.sampling_rate, tr.data) for tr in st])
    assert len(out[0]) == len(out[1]) == 2
    for a, b in zip(*out):
        assert a[:3] == b[:3]
        _eq(a[3], b[3])


STATS_CASES = {
    "weighted_linear_regression": lambda m: m.weighted_linear_regression(
        np.arange(20.0), 2.0 * np.arange(20.0) + _signal(5, (20,)),
        w=np.linspace(0.5, 1.5, 20)),
    "weighted_linear_regression_unweighted": (
        lambda m: m.weighted_linear_regression(
            np.arange(10.0), _signal(6, (10,)))),
    "cov_mat_intersection": lambda m: m.cov_mat_intersection(
        np.array([[4.0, 1.0, 0.3], [1.0, 2.0, 0.1], [0.3, 0.1, 9.0]])),
    "cov_mat_intersection_xz": lambda m: m.cov_mat_intersection(
        np.array([[4.0, 1.0, 0.3], [1.0, 2.0, 0.1], [0.3, 0.1, 9.0]]),
        axis1=0, axis2=2),
    "running_mad": lambda m: m.running_mad(_signal(7, (1000,)), 100),
    "running_mad_ragged": lambda m: m.running_mad(
        _signal(8, (1037,)), 128, n_mad=5.0, overlap=0.5),
    "running_mad_short": lambda m: m.running_mad(_signal(9, (50,)), 100),
    "spectrogram": lambda m: m.spectrogram(_signal(10, (2000,)), 4.0, 0.5,
                                           25.0),
}


@pytest.mark.parametrize("case", sorted(STATS_CASES))
def test_stats_match_jax(case):
    _eq(STATS_CASES[case](stats), STATS_CASES[case](jstats))


def test_linear_regression_matches_jax():
    x = np.arange(12.0)
    y = 0.5 * x + _signal(11, (12,))
    _eq(tutils.linear_regression(x, y), jutils.linear_regression(x, y))
    _eq(tutils.linear_regression(x[:2], y[:2]),
        jutils.linear_regression(x[:2], y[:2]))


def _timings(n=200, seed=12):
    rng = np.random.default_rng(seed)
    t0 = np.datetime64("2012-07-01T00:00:00", "ns")
    sec = np.sort(rng.uniform(0, 90 * 86400.0, n))
    return (t0 + (sec * 1e9).astype("timedelta64[ns]")).astype("U")


@pytest.mark.parametrize("kw", [
    dict(freq="1D"),
    dict(freq="1D", offset=0.5),
    dict(freq="7D", offset=0.25, mode="beginning"),
    dict(freq="1W", offset=0.5, trim_start=False, trim_end=True),
    dict(freq="6h"),
    dict(freq="MS"),
    dict(freq="ME", mode="beginning"),
])
def test_event_count_matches_jax(kw):
    args = (_timings(), "2012-07-01", "2012-10-01")
    pd.testing.assert_series_equal(tutils.event_count(*args, **kw),
                                   jutils.event_count(*args, **kw))


def test_event_count_raises_on_a_calendar_offset():
    for m in (stats, jstats):
        with pytest.raises(ValueError, match="calendar"):
            m.event_count(_timings(), "2012-07-01", "2012-10-01",
                          freq="MS", offset=0.5)


# ---------------------------------------------------------------------------
# clustering
# ---------------------------------------------------------------------------
class _Tables:
    """The two inter-template tables a clustering reads."""

    def __init__(self, dist, cc, frames):
        wrap = (lambda a: pd.DataFrame(a)) if frames else (lambda a: a)
        self.intertemplate_distances = wrap(dist)
        self.intertemplate_cc = wrap(cc)


def _cluster_tables(n=12, seed=13):
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.normal(c, 1.0, size=(n // 3, 3))
                          for c in (0.0, 20.0, 40.0)])
    dist = np.linalg.norm(xyz[:, None] - xyz[None], axis=-1)
    cc = np.clip(1.0 - dist / 30.0 + 0.05 * rng.normal(size=dist.shape),
                 -1, 1)
    return dist, 0.5 * (cc + cc.T)


@pytest.mark.parametrize("sim", [None, "cc"])
@pytest.mark.parametrize("method", ["single", "average"])
def test_cluster_events_matches_jax(sim, method):
    dist, cc = _cluster_tables()
    kw = dict(similarity_matrix=None if sim is None else cc,
              distance_criterion_km=6.0, similarity_criterion=0.5,
              method=method)
    _eq(tutils.cluster_events(dist, **kw), jutils.cluster_events(dist, **kw))
    _eq(tutils.cluster_events(dist[:1, :1]), jutils.cluster_events(
        dist[:1, :1]))


def test_build_families_and_cluster_templates_match_jax():
    dist, cc = _cluster_tables()
    port, ref = _Tables(dist, cc, False), _Tables(dist, cc, True)
    fam = tutils.build_families(port, distance_criterion_km=6.0)
    assert fam == jutils.build_families(ref, distance_criterion_km=6.0)
    assert len(fam) >= 3
    for thr in (0.2, 0.33, 0.6):
        _eq(tutils.cluster_templates(port, clustering_threshold=thr)[0],
            jutils.cluster_templates(ref, clustering_threshold=thr)[0])
        assert (tutils.cluster_templates(port, clustering_threshold=thr)[1]
                == jutils.cluster_templates(ref,
                                            clustering_threshold=thr)[1])


# ---------------------------------------------------------------------------
# SVD-Wiener stacking
# ---------------------------------------------------------------------------
def _panels(n_p=5, n_ev=7, n_samp=400, seed=14):
    rng = np.random.default_rng(seed)
    t = np.arange(n_samp) / 25.0
    burst = np.sin(2 * np.pi * 4.0 * t) * np.exp(-((t - 6.0) ** 2))
    amp = rng.uniform(0.5, 2.0, size=(n_p, n_ev, 1))
    return amp * burst + 0.3 * rng.normal(size=(n_p, n_ev, n_samp))


SVDWF_CASES = {
    "default": dict(),
    "bandpassed": dict(freqmin=1.0, freqmax=8.0, sampling_rate=25.0),
    "colsize_3_two_sv": dict(wiener_filter_colsize=3, max_singular_values=2,
                             expl_var=0.9),
    "all_variance": dict(expl_var=0.999, max_singular_values=4),
}


@pytest.mark.parametrize("case", sorted(SVDWF_CASES))
def test_svdwf_matches_jax(case):
    kw = SVDWF_CASES[case]
    panels = _panels()
    want = np.stack([jstacking.svdwf(p, **kw) for p in panels])
    host = stacking.svdwf_panels_host(panels, **kw)
    # the host route is the JAX computation before its float32 cast
    _eq(host.astype(np.float32), want)
    dev = stacking.svdwf_panels(panels, device="cpu", **kw)
    assert np.abs(dev - host).max() <= RTOL_SVDWF * np.abs(host).max()
    one = stacking.svdwf(panels[1], device="cpu", **kw)
    assert one.dtype == np.float32
    np.testing.assert_allclose(one, want[1], rtol=0,
                               atol=1e-6 * np.abs(want[1]).max())
    # a single event: no Wiener filter, as in the JAX package
    _eq(stacking.svdwf_panels_host(panels[:, :1], **kw).astype(np.float32),
        np.stack([jstacking.svdwf(p[:1], **kw) for p in panels]))


def test_svdwf_of_a_panel_that_is_not_finite_is_seeded_noise():
    panels = _panels(n_p=3)
    panels[1, 2, 5] = np.nan
    outs = [f(panels, generator=torch.Generator().manual_seed(5), **kw)
            for f, kw in ((stacking.svdwf_panels, dict(device="cpu")),
                          (stacking.svdwf_panels_host, {}))]
    _eq(outs[0][1], outs[1][1])
    _eq(outs[0][1], torch.randn(400, generator=torch.Generator().manual_seed(
        5), dtype=torch.float64).numpy())
    good = stacking.svdwf_panels_host(panels[[0, 2]])
    assert np.abs(outs[0][[0, 2]] - good).max() <= RTOL_SVDWF * np.abs(
        good).max()
    # the JAX package stacks it to noise as well (from numpy's state)
    assert np.isfinite(jstacking.svdwf(panels[1])).all()


def test_stack_panels_skips_zero_panels():
    panels = _panels(n_p=6).reshape(2, 3, 7, 400)
    panels[1, 1] = 0.0
    wf = np.moveaxis(panels, 2, 0).astype(np.float32)   # (ev, sta, comp, t)
    out = stacking.stack_panels(wf, device="cpu", freqmin=1.0, freqmax=8.0,
                                sampling_rate=25.0)
    assert out.shape == (2, 3, 400) and out.dtype == np.float32
    assert not out[1, 1].any()
    for s, c in ((0, 0), (1, 2)):
        np.testing.assert_allclose(
            out[s, c], jstacking.svdwf(wf[:, s, c], freqmin=1.0, freqmax=8.0,
                                       sampling_rate=25.0),
            rtol=0, atol=1e-6 * np.abs(out[s, c]).max())


@pytest.mark.parametrize("order", [1.0, 2.0, 3.5])
def test_fractional_stack_matches_jax(order):
    x = _panels(n_p=1)[0]
    _eq(stacking.fractional_stack(x, order),
        jstacking.fractional_stack(x, order))


# ---------------------------------------------------------------------------
# host scans: flag_multiples, find_similar_sources
# ---------------------------------------------------------------------------
def _catalog(n=300, n_tid=12, seed=15):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0, 600.0, n))
    tid_idx = rng.integers(-1, n_tid + 1, n)   # some outside the tables
    metric = rng.uniform(0, 1, n).astype(np.float32)
    metric[5] = metric[6]                      # a tie
    dist = rng.uniform(0, 20, (n_tid, n_tid)).astype(np.float32)
    ccm = rng.uniform(-0.2, 1, (n_tid, n_tid)).astype(np.float32)
    return times, tid_idx, metric, dist, ccm


@pytest.mark.parametrize("tables", ["both", "dist", "cc", "none"])
def test_flag_multiples_matches_jax(tables):
    times, tid_idx, metric, dist, ccm = _catalog()
    kw = dict(dist=dist if tables in ("both", "dist") else None,
              ccm=ccm if tables in ("both", "cc") else None,
              dt_criterion=4.0, dist_criterion=5.0, cc_criterion=0.33)
    got = host_ops.flag_multiples(times, tid_idx, metric, **kw)
    if jhost.available():
        _eq(got, jhost.flag_multiples(times, tid_idx, metric, **kw))
    assert 0 < got.sum() < len(got)


def test_flag_multiples_is_remove_multiples_scan():
    """The JAX package's `remove_multiples` loop (the DataFrame route) on
    the same catalog: the same unique events."""
    from seismic_bpmf_tpu.data.groups import TemplateGroup as JGroup

    times, tid_idx, metric, dist, ccm = _catalog()
    tid_idx = np.clip(tid_idx, 0, 11)
    tids = np.array([f"t{i}" for i in range(12)])
    group = JGroup.__new__(JGroup)
    group._ellips_dist = pd.DataFrame(dist, index=tids, columns=tids)
    group._intertemplate_cc = pd.DataFrame(ccm, index=tids, columns=tids)
    cat = group.remove_multiples(pd.DataFrame({
        "origin_time": times, "tid": tids[tid_idx], "cc": metric}),
        dt_criterion=4.0)
    _eq(host_ops.flag_multiples(times, tid_idx, metric, dist=dist, ccm=ccm,
                                dt_criterion=4.0),
        cat["unique_event"].to_numpy())


def _sources(n=120, n_sta=6, seed=16):
    rng = np.random.default_rng(seed)
    lon = rng.uniform(30.0, 30.4, n).astype(np.float32)
    lat = rng.uniform(40.0, 40.4, n).astype(np.float32)
    mv = (rng.uniform(0, 2, (n, 1)) + rng.uniform(0, 0.1, (n, n_sta))
          ).astype(np.float32)
    return mv, lon, lat


@pytest.mark.parametrize("method", ["closest", "smallest"])
@pytest.mark.parametrize("k", [None, 3])
def test_find_similar_sources_matches_jax(method, k):
    mv, lon, lat = _sources()
    args = (mv, lon, lat, np.linspace(30.0, 30.4, 3),
            np.linspace(40.0, 40.4, 3), 0.05)
    kw = dict(num_stations_for_diff=k, method=method)
    want = jref.find_similar_sources(*args, **kw)
    _eq(reference.find_similar_sources(*args, **kw), want)
    _eq(host_ops.find_similar_sources(*args, **kw), want)
    assert 0 < want.sum() < len(want)


# ---------------------------------------------------------------------------
# thresholds, network, catalog, travel times, readers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window, num_dev", [(50, 15.0), (200, 5.0)])
def test_time_dependent_threshold_pd_matches_jax(window, num_dev):
    x = np.abs(_signal(17, (1500,)))
    _eq(thresholds.time_dependent_threshold_pd(x, window, num_dev),
        jthr.time_dependent_threshold_pd(x, window, num_dev))


def _networks():
    md = pd.DataFrame({
        "stations": [f"S{i}" for i in range(6)], "networks": ["XX"] * 6,
        "latitude": 40.0 + 0.1 * np.arange(6),
        "longitude": 30.0 + 0.07 * np.arange(6),
        "elevation_m": np.arange(6) * 100.0})
    dates = dict(start_date=np.datetime64("2012-07-26"),
                 end_date=np.datetime64("2012-08-03"))
    return Network.from_dataframe(md, **dates), JNetwork.from_dataframe(
        md, **dates)


def test_network_datelist_and_box_match_jax():
    net, jnet = _networks()
    _eq(net.datelist(), jnet.datelist().values)
    assert len(net.datelist()) == 9
    for box in ((40.05, 40.45, 29.0, 31.0), (39.0, 41.0, 30.1, 30.3)):
        sub, jsub = net.box(*box), jnet.box(*box)
        _eq(sub.stations, jsub.stations)
        for attr in ("latitude", "longitude", "elevation", "depth"):
            _eq(getattr(sub, attr), getattr(jsub, attr))


def test_catalog_read_from_dataframe_matches_jax():
    rng = np.random.default_rng(18)
    t0 = np.datetime64("2012-07-26T00:00:00", "ns")
    df = pd.DataFrame({
        "longitude": rng.uniform(30, 31, 8),
        "latitude": rng.uniform(40, 41, 8),
        "depth": rng.uniform(0, 20, 8),
        "origin_time": t0 + (rng.uniform(0, 86400, 8) * 1e9).astype(
            "timedelta64[ns]"),
        "cc": rng.uniform(0, 1, 8), "tid": [f"t{i % 3}" for i in range(8)]})
    cat, jcat = Catalog.read_from_dataframe(df), JCatalog.read_from_dataframe(
        df)
    assert cat.columns == list(jcat.catalog.columns)
    for c in cat.columns:
        _eq(cat[c], jcat.catalog[c].to_numpy())


def test_grid_travel_times_matches_jax():
    rng = np.random.default_rng(19)
    src = [rng.uniform(30, 30.5, 20), rng.uniform(40, 40.5, 20),
           rng.uniform(2, 20, 20)]
    rec = [rng.uniform(30, 30.5, 4), rng.uniform(40, 40.5, 4), np.zeros(4)]
    _eq(grid_travel_times(*src, *rec), jtt.grid_travel_times(*src, *rec))
    _eq(grid_travel_times(*src, *rec, vp_km_s=5.0, vs_km_s=2.9),
        jtt.grid_travel_times(*src, *rec, vp_km_s=5.0, vs_km_s=2.9))


@pytest.mark.parametrize("sel", [None, [7, 2, 2, 30]])
@pytest.mark.parametrize("stations", [None, ["B", "C"]])
def test_load_travel_times_and_moveout_array_match_jax(tmp_path, sel,
                                                       stations):
    rng = np.random.default_rng(20)
    shape = (4, 5, 3)
    tts = {ph: {s: rng.uniform(0, 10, shape) for s in "ABC"}
           for ph in ("P", "S")}
    coords = {c: rng.uniform(0, 1, shape)
              for c in ("longitude", "latitude", "depth")}
    path = str(tmp_path / "tts.h5")
    TravelTimes.write_table(path, tts, coords)
    got, gc = load_travel_times(path, ["P", "S"], source_indexes=sel,
                                return_coords=True, stations=stations)
    want, wc = jtt.load_travel_times(path, ["P", "S"], source_indexes=sel,
                                     return_coords=True, stations=stations)
    assert sorted(got["P"]) == list(want.index)
    for ph in ("P", "S"):
        for sta in want.index:
            _eq(got[ph][sta], want.loc[sta, ph])
    _eq(gc.index, wc.index.to_numpy())
    for c in ("longitude", "latitude", "depth"):
        _eq(gc[c], wc[c].to_numpy())
    stas = list(want.index)
    _eq(get_moveout_array(got, stas, ["P", "S"]),
        jtt.get_moveout_array(want, stas, ["P", "S"]))
    assert load_travel_times(path, ["P"]).keys() == {"P"}


def test_data_reader_pyasdf_needs_pyasdf():
    with pytest.raises(ImportError, match="pyasdf"):
        data_reader_pyasdf("no_file.h5")


def test_profile_trace_writes_a_chrome_trace_with_op_rows(tmp_path):
    import json

    from seismic_bpmf_tpu_torch.utils.observe import profile_trace

    with profile_trace(None) as prof:
        assert prof is None
    logdir = tmp_path / "traces"
    with profile_trace(str(logdir)) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    assert any(e.key == "aten::matmul" for e in prof.key_averages())
    with profile_trace(str(logdir)):
        torch.ones(8).cumsum(0)
    files = sorted(logdir.iterdir())
    assert [f.suffix for f in files] == [".json", ".json"]
    ops = [{e.get("name") for e in json.loads(f.read_text())["traceEvents"]}
           for f in files]
    assert "aten::matmul" in ops[0] and "aten::matmul" not in ops[1]
    assert "aten::cumsum" in ops[1]
