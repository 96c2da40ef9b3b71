"""The port's `TemplateGroup` tables, inter-template CC, multiples removal
and `Catalog` against the JAX package, on a seeded bank carried across
with `TemplateGroup.from_group`.

The JAX package keeps these tables and the catalog in DataFrames; the port
keeps numpy arrays in `tids` order and a dict of numpy columns.
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from seismic_bpmf_tpu.data import (  # noqa: E402
    Catalog as JCatalog, Event as JEvent, Network as JNetwork,
    Template as JTemplate, TemplateGroup as JTemplateGroup,
)

import seismic_bpmf_tpu_torch.data as tdata  # noqa: E402

SR = 25.0
N_TP, N_STA, L = 7, 4, 60
T0 = 1343260800.0


@pytest.fixture(scope="module")
def banks():
    """(JAX group, the port's group carried across)."""
    rng = np.random.default_rng(31)
    stations = [f"S{i}" for i in range(N_STA)]
    net = JNetwork.from_dataframe(pd.DataFrame({
        "stations": stations, "networks": ["XX"] * N_STA,
        "latitude": 40.0 + 0.05 * np.arange(N_STA),
        "longitude": 30.0 + 0.05 * np.arange(N_STA),
        "elevation_m": np.zeros(N_STA)}))
    base = rng.normal(size=(N_STA, 3, L)).astype(np.float32)
    waves, templates = [], []
    for i in range(N_TP):
        # templates 0-2 share a waveform (shifted by a sample or two, with
        # some noise), the rest are unrelated
        if i < 3:
            wv = np.roll(base, -i, axis=-1) + 0.2 * rng.normal(
                size=base.shape).astype(np.float32)
        else:
            wv = rng.normal(size=base.shape).astype(np.float32)
        if i == 4:
            wv[1] = 0.0                       # a station without data
        waves.append(wv.astype(np.float32))
        if i == 0 or i >= 3:              # 0-2 share their moveouts too
            mv = rng.uniform(0.5, 4.0, size=(N_STA, 2))
            mv[:, 1] = mv[:, 0] * 1.7
        tp = JTemplate(T0 + 100.0 * i, mv, stations, ["P", "S"],
                       latitude=40.0 + 0.01 * (i % 4),
                       longitude=30.0 + 0.01 * (i // 4),
                       depth=5.0 + i, sampling_rate=SR, id=str(i))
        tp.duration = L / SR
        tp.set_aux_data({"tid": i, "offset_P": 1.0, "offset_S": 4.0,
                         "phase_on_compN": "S", "phase_on_compE": "S",
                         "phase_on_compZ": "P"})
        if i in (1, 5):
            a = rng.normal(size=(3, 3))
            tp.cov_mat = a @ a.T
        elif i in (2, 6):
            tp.set_aux_data({"hmax_unc": 2.0 + i, "vmax_unc": 1.0})
        templates.append(tp)
    jtg = JTemplateGroup(templates, net)
    jtg._waveforms_arr = np.stack(waves)
    return jtg, tdata.TemplateGroup.from_group(jtg)


def test_from_group_carries_the_bank(banks):
    jtg, ttg = banks
    np.testing.assert_array_equal(ttg.waveforms_arr, jtg.waveforms_arr)
    np.testing.assert_array_equal(ttg.moveouts_arr, jtg.moveouts_arr)
    assert [str(t) for t in ttg.tids] == [str(t) for t in jtg.tids]
    assert list(ttg.stations) == list(jtg.stations)
    for a, b in zip(ttg.templates, jtg.templates):
        assert a.origin_time == b.origin_time
        assert (a.longitude, a.latitude, a.depth) == (
            b.longitude, b.latitude, b.depth)
        np.testing.assert_array_equal(a.moveouts_table(),
                                      b.moveouts.loc[jtg.stations].values)
    assert ttg.templates[1].cov_mat.shape == (3, 3)
    assert ttg.templates[2].aux_data["hmax_unc"] == 4.0
    # and from a group of the port itself
    again = tdata.TemplateGroup.from_group(ttg)
    np.testing.assert_array_equal(again.directional_errors,
                                  ttg.directional_errors)


@pytest.mark.parametrize("table", ["intertemplate_distances",
                                   "directional_errors",
                                   "ellipsoid_distances"])
def test_tables_match_jax(banks, table):
    jtg, ttg = banks
    want = getattr(jtg, table).values.astype(np.float64)
    got = getattr(ttg, table)
    assert isinstance(got, np.ndarray) and got.shape == (N_TP, N_TP)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    alias = {"intertemplate_distances": "intertemplate_dist",
             "directional_errors": "dir_errors",
             "ellipsoid_distances": "ellipsoid_dist"}[table]
    assert getattr(ttg, alias) is got
    assert ttg.table_at(got, "2", "5") == got[2, 5]
    assert float(ttg.table_at(got, "2", "5")) == pytest.approx(
        float(getattr(jtg, table).loc["2", "5"]), rel=1e-6, abs=1e-6)


def test_table_refreshers_drop_stale_tables(banks):
    _, ttg = banks
    ttg = tdata.TemplateGroup.from_group(ttg)
    before = ttg.ellipsoid_distances.copy()
    ttg.templates[0].depth += 30.0
    assert ttg.ellipsoid_distances is ttg._ellips_dist   # still cached
    ttg.compute_intertemplate_dist()
    assert not np.allclose(ttg.ellipsoid_distances, before)
    ttg.templates[0].aux_data["hmax_unc"] = 9.0
    ttg.compute_dir_errors()
    ttg.compute_ellipsoid_dist()
    assert ttg.directional_errors[0, 1] > 0


@pytest.mark.parametrize("max_lag", [10, 3])
def test_intertemplate_cc_matches_jax(banks, max_lag, tmp_path):
    jtg, ttg = banks
    kw = dict(distance_threshold=1e4, max_lag=max_lag)
    want = jtg.compute_intertemplate_cc(**kw).values
    got = ttg.compute_intertemplate_cc(device="cpu", **kw)
    assert got.dtype == np.float32 and got.shape == (N_TP, N_TP)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got[0, 1] > 0.5 and np.all(np.diag(got) == 1.0)
    # the HDF5 cache gives the table back, keyed by the parameters
    cache = str(tmp_path / "cc.h5")
    first = ttg.compute_intertemplate_cc(cache_file=cache, device="cpu",
                                         **kw)
    ttg._waveforms_arr = np.zeros_like(ttg.waveforms_arr)
    try:
        cached = ttg.compute_intertemplate_cc(cache_file=cache,
                                              device="cpu", **kw)
    finally:
        ttg._waveforms_arr = np.array(jtg.waveforms_arr)
    np.testing.assert_array_equal(cached, first)


def _detections(rng, n=60):
    """A seeded detection table: bursts of near-simultaneous detections by
    several templates, with distinct times and CCs."""
    t = np.sort(rng.uniform(0, 400.0, size=n // 3))
    times = (t[:, None] + rng.uniform(0, 2.5, size=(len(t), 3))).ravel()
    times = np.round(times, 3) + 1e-4 * np.arange(times.size)
    return {"origin_time": T0 + times,
            "tid": rng.integers(0, N_TP, size=times.size).astype(str),
            "cc": rng.uniform(0.2, 1.0, size=times.size)}


@pytest.mark.parametrize("criteria", [
    dict(),
    dict(dt_criterion=1.0, distance_criterion=-100.0),
    dict(distance_criterion=-100.0, similarity_criterion=0.5),
    dict(dt_criterion=6.0, similarity_criterion=2.0),
])
def test_remove_multiples_matches_jax(banks, criteria):
    jtg, ttg = banks
    jtg.compute_intertemplate_cc(distance_threshold=1e4)
    ttg.compute_intertemplate_cc(distance_threshold=1e4, device="cpu")
    det = _detections(np.random.default_rng(32))
    want = jtg.remove_multiples(pd.DataFrame(det), **criteria)
    got = ttg.remove_multiples(det, **criteria)
    np.testing.assert_array_equal(got["origin_time"],
                                  want["origin_time"].values)
    np.testing.assert_array_equal(got["tid"], want["tid"].values)
    np.testing.assert_array_equal(got["unique_event"],
                                  want["unique_event"].values)
    assert 0 < got["unique_event"].sum() < len(got["unique_event"])


def _events(cls, rng, n=25):
    stations = ["A", "B"]
    out = []
    for i in range(n):
        ev = cls(T0 + float(rng.uniform(0, 3 * 86400.0)),
                 rng.uniform(0, 3, size=(2, 2)), stations, ["P", "S"],
                 latitude=40.0 + 0.001 * i, longitude=30.0 + 0.002 * i,
                 depth=5.0 + 0.1 * i, sampling_rate=SR)
        ev.set_aux_data({"cc": float(rng.uniform(0.3, 1.0)), "tid": i % 4})
        if i % 5:
            ev.set_aux_data({"n_dev": float(i)})
        out.append(ev)
    return out


def test_catalog_columns_match_jax(tmp_path):
    jev = _events(JEvent, np.random.default_rng(33))
    tev = _events(tdata.Event, np.random.default_rng(33))
    attrs = ["cc", "tid", "n_dev"]
    jcat = JCatalog.read_from_events(jev, extra_attributes=attrs)
    tcat = tdata.Catalog.read_from_events(tev, extra_attributes=attrs)
    assert tcat.n_events == len(tcat) == jcat.n_events == 25
    assert set(tcat.columns) == set(jcat.catalog.columns)
    for col in ("longitude", "latitude", "depth", "cc", "tid", "n_dev"):
        np.testing.assert_array_equal(tcat[col], jcat.catalog[col].values)
    assert list(tcat["event_id"]) == list(jcat.catalog["event_id"])
    np.testing.assert_array_equal(
        tcat.origin_time, jcat.origin_time.astype("datetime64[ns]"))
    np.testing.assert_allclose(tcat.origin_times_epoch,
                               jcat.origin_times_epoch)
    for name in ("latitude", "longitude", "depth"):
        np.testing.assert_array_equal(getattr(tcat, name),
                                      getattr(jcat, name))
    # multiples by time and distance
    np.testing.assert_array_equal(
        tcat.flag_multiples(dt_criterion=20000.0, distance_criterion=2.0),
        jcat.flag_multiples(dt_criterion=20000.0,
                            distance_criterion=2.0).values)
    assert not tcat["unique_event"].all()
    # concatenate and the CSV round trip
    both = tdata.Catalog.concatenate([tcat, tcat])
    jboth = JCatalog.concatenate([jcat, jcat])
    assert both.n_events == jboth.n_events == 50
    np.testing.assert_array_equal(both["cc"], jboth.catalog["cc"].values)
    path = str(tmp_path / "cat.csv")
    tcat.write(path)
    back = tdata.Catalog.read(path)
    np.testing.assert_array_equal(back.origin_time, tcat.origin_time)
    np.testing.assert_array_equal(back["cc"], tcat["cc"])
    np.testing.assert_array_equal(back["unique_event"], tcat["unique_event"])
    np.testing.assert_array_equal(back["n_dev"], tcat["n_dev"])
    assert list(back["event_id"]) == list(tcat["event_id"])
    # the plots are ported (tests/test_torch_viz.py): the map's scatter
    # holds the epicentres
    pytest.importorskip("matplotlib")
    offsets = tcat.plot_map().axes[0].collections[0].get_offsets()
    np.testing.assert_array_equal(
        offsets, np.stack([tcat.longitude, tcat.latitude], axis=1))
    assert tdata.Catalog([], [], [], []).n_events == 0
    with pytest.raises(ValueError, match="rows"):
        tdata.Catalog([1.0], [2.0], [3.0], ["2012-01-01"], cc=[1.0, 2.0])


@pytest.mark.parametrize("freq,mode", [("1D", "end"), ("1D", "beginning"),
                                       ("6h", "end"), ("2h", "beginning")])
def test_event_count_matches_jax(freq, mode):
    jcat = JCatalog.read_from_events(_events(JEvent,
                                             np.random.default_rng(34)))
    tcat = tdata.Catalog.read_from_events(_events(tdata.Event,
                                                  np.random.default_rng(34)))
    want = jcat.event_count(freq=freq, mode=mode)
    times, counts = tcat.event_count(freq=freq, mode=mode)
    np.testing.assert_array_equal(times,
                                  want.index.values.astype("datetime64[ns]"))
    np.testing.assert_array_equal(counts, want.values)
    assert counts.sum() == 25
    # '1M' is refused, as the JAX package's pandas refuses it; the calendar
    # months are 'MS' and 'ME'
    for cat in (jcat, tcat):
        with pytest.raises(ValueError):
            cat.event_count(freq="1M")
    want = jcat.event_count(freq="ME")
    times, counts = tcat.event_count(freq="ME")
    np.testing.assert_array_equal(times,
                                  want.index.values.astype("datetime64[ns]"))
    np.testing.assert_array_equal(counts, want.values)
    with pytest.raises(ValueError, match="calendar-dependent"):
        tcat.event_count(freq="MS", offset=0.5)


# every keyword of the JAX package's `Catalog.event_count` (its
# `utils.event_count`: pandas' resample rules) on a 40-day catalog, its
# default range and an explicit one
EVENT_COUNT_CASES = [
    dict(freq="1D"), dict(freq="1D", mode="beginning"),
    dict(freq="6h"), dict(freq="6h", offset=0.5, mode="beginning"),
    dict(freq="W"), dict(freq="W", mode="beginning"),
    dict(freq="W", offset=0.5, trim_start=False, trim_end=True),
    dict(freq="MS"), dict(freq="MS", mode="beginning"),
    dict(freq="ME"), dict(freq="ME", mode="beginning"),
    dict(freq="7D", offset=0.25, mode="beginning"),
    dict(freq="1D", offset=0.5, trim_start=False),
    dict(freq="2h", offset=0.25, trim_end=True),
]


@pytest.mark.parametrize("span", [None, ("2012-07-20", "2012-09-03")])
@pytest.mark.parametrize("kw", EVENT_COUNT_CASES,
                         ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_event_count_keywords_and_calendars_match_jax(kw, span):
    rng = np.random.default_rng(36)
    ot = T0 + np.sort(rng.uniform(0.0, 40 * 86400.0, 60))
    ot[0] = T0                                   # an event at midnight
    iso = [str(np.datetime64(int(round(t * 1e6)), "us")) for t in ot]
    cols = [np.zeros(len(ot))] * 3
    want = JCatalog(*cols, iso).event_count(*(span or ()), **kw)
    times, counts = tdata.Catalog(*cols, iso).event_count(*(span or ()),
                                                          **kw)
    np.testing.assert_array_equal(times,
                                  want.index.values.astype("datetime64[ns]"))
    np.testing.assert_array_equal(counts, want.values)


def test_detection_file_round_trip(tmp_path):
    h5py = pytest.importorskip("h5py")
    tev = _events(tdata.Event, np.random.default_rng(35), n=6)
    with h5py.File(str(tmp_path / "det.h5"), "w") as f:
        for ev in tev:
            ev.write("det.h5", gid=ev.id, hdf5_file=f)
    tcat, events = tdata.Catalog.read_from_detection_file(
        "det.h5", db_path=str(tmp_path), return_events=True)
    jcat = JCatalog.read_from_detection_file("det.h5", db_path=str(tmp_path))
    assert tcat.n_events == len(events) == 6
    for col in ("longitude", "cc", "tid"):
        np.testing.assert_array_equal(tcat[col], jcat.catalog[col].values)
    assert np.isnan(tcat["n_dev"]).sum() == np.isnan(
        jcat.catalog["n_dev"].values).sum()
