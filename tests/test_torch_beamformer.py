"""The port's backprojection engine and day scan against the JAX package.

The synthetic world of tests/test_workflow.py (the code that makes it is
copied here): both packages read the same HDF5 day and travel-time table,
and their `TravelTimes`, `Beamformer` weight policies, uncertainty
integrals, `backproject_day` and `scan_days(stage="bp")` are compared on
the CPU.  Detections must be identical (peak and source indexes) with the
max beam within 1e-4.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from seismic_bpmf_tpu import workflow as jwf  # noqa: E402
from seismic_bpmf_tpu.config import Config  # noqa: E402
from seismic_bpmf_tpu.data import (  # noqa: E402
    Data, Network, TravelTimes, data_reader_hdf5, write_hdf5_continuous,
)
from seismic_bpmf_tpu.data.stream import Stream, Trace  # noqa: E402
from seismic_bpmf_tpu.detection.beamformer import (  # noqa: E402
    Beamformer as JaxBeamformer,
)

import seismic_bpmf_tpu_torch.config as tconfig  # noqa: E402
import seismic_bpmf_tpu_torch.data as tdata  # noqa: E402
from seismic_bpmf_tpu_torch import workflow as twf  # noqa: E402
from seismic_bpmf_tpu_torch.detection import Beamformer  # noqa: E402
from seismic_bpmf_tpu_torch.ops import bp, host_ops  # noqa: E402
from seismic_bpmf_tpu_torch.utils.observe import GLOBAL_TIMER  # noqa: E402

SR = 25.0
DAY = 900.0
N_STA = 5
N_SRC = 9
EVENT_TIMES = [200.0, 600.0]
EVENT_SRC = 3
T0 = 1343260800.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_bp")
    rng = np.random.default_rng(11)
    cfg = Config(data_buffer_sec=0.0, sampling_rate_hz=SR,
                 template_len_sec=8.0, n_dev_bp_threshold=10.0,
                 n_dev_mf_threshold=8.0)
    md = pd.DataFrame({
        "stations": [f"S{i}" for i in range(N_STA)],
        "networks": ["XX"] * N_STA,
        "latitude": 40.0 + 0.05 * np.arange(N_STA),
        "longitude": 30.0 + 0.05 * np.arange(N_STA),
        "elevation_m": np.zeros(N_STA),
    })
    net = Network.from_dataframe(md)
    tt_p = {f"S{i}": rng.uniform(1.0, 5.0, N_SRC).astype(np.float32)
            for i in range(N_STA)}
    tt_s = {k: (v * 1.7).astype(np.float32) for k, v in tt_p.items()}
    coords = {"longitude": np.linspace(30, 30.2, N_SRC),
              "latitude": np.linspace(40, 40.2, N_SRC),
              "depth": np.full(N_SRC, 8.0)}
    TravelTimes.write_table(str(tmp / "tts.h5"), {"P": tt_p, "S": tt_s},
                            coords)
    n = int(DAY * SR)
    n_w = int(1.5 * SR)
    wavelet = (np.sin(2 * np.pi * 4.0 * np.arange(n_w) / SR)
               * np.hanning(n_w))
    st = Stream()
    for i in range(N_STA):
        sta = f"S{i}"
        for comp in "NEZ":
            x = 0.05 * rng.normal(size=n).astype(np.float32)
            for ev_t in EVENT_TIMES:
                tt = tt_p[sta][EVENT_SRC] if comp == "Z" else tt_s[sta][EVENT_SRC]
                k = int((ev_t + tt) * SR)
                x[k : k + len(wavelet)] += 4.0 * wavelet
            st += Trace(x, station=sta, network="XX", channel=f"HH{comp}",
                        sampling_rate=SR, starttime=T0)
    path = str(tmp / "day.h5")
    write_hdf5_continuous(path, st)
    data = Data("2012-07-26", path, data_reader_hdf5, duration=DAY,
                sampling_rate=SR).read_waveforms()
    tts = TravelTimes("tts.h5", str(tmp)).read(
        ["P", "S"], read_coords=True).convert_to_samples(SR)

    tdat = tdata.Data("2012-07-26", path, tdata.data_reader_hdf5,
                      duration=DAY, sampling_rate=SR).read_waveforms()
    tnet = tdata.Network.from_arrays(
        md["stations"], networks=md["networks"], latitude=md["latitude"],
        longitude=md["longitude"], elevation_m=md["elevation_m"])
    ttts = tdata.TravelTimes("tts.h5", str(tmp)).read(
        ["P", "S"], read_coords=True).convert_to_samples(SR)
    tcfg = tconfig.Config(**{k: getattr(cfg, k) for k in (
        "data_buffer_sec", "sampling_rate_hz", "template_len_sec",
        "n_dev_bp_threshold", "n_dev_mf_threshold")})
    return dict(cfg=cfg, net=net, data=data, tts=tts, tmp=tmp, tcfg=tcfg,
                tdata=tdat, tnet=tnet, ttts=ttts, tt_p=tt_p, tt_s=tt_s,
                coords=coords)


# --------------------------------------------------------------------------
# travel times
@pytest.mark.parametrize("units", ["seconds", "samples"])
@pytest.mark.parametrize("source", ["dicts", "hdf5"])
def test_travel_times_match_jax(world, units, source):
    w = world
    if source == "dicts":
        tts = {"P": w["tt_p"], "S": w["tt_s"]}
        jt = TravelTimes.from_arrays(tts, w["coords"])
        tt = tdata.TravelTimes.from_arrays(tts, w["coords"])
        if units == "samples":
            jt.convert_to_samples(SR)
            tt.convert_to_samples(SR)
    else:
        jt, tt = w["tts"], w["ttts"]
    stations = ["S3", "S0", "S4"]
    for rel in (False, True):
        want = jt.get_travel_times_array(units=units, stations=stations,
                                         phases=["S", "P"],
                                         relative_to_first=rel)
        got = tt.get_travel_times_array(units=units, stations=stations,
                                        phases=["S", "P"],
                                        relative_to_first=rel)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tt.moveout_to_tt, jt.moveout_to_tt)
    np.testing.assert_array_equal(tt.get_travel_times_array(units=units),
                                  jt.get_travel_times_array(units=units))
    assert tt.n_sources == jt.n_sources == N_SRC
    assert tt.phases == list(jt.tts.columns)
    for c in ("longitude", "latitude", "depth"):
        np.testing.assert_array_equal(tt.source_coordinates[c],
                                      jt.source_coordinates[c].values)
    np.testing.assert_array_equal(tt.source_coordinates.index,
                                  np.asarray(jt.source_coordinates.index))


def test_travel_times_subset_read_matches_jax(world):
    w = world
    kw = dict(source_indexes=np.array([7, 2, 5]), read_coords=True,
              stations=["S1", "S2"])
    jt = TravelTimes("tts.h5", str(w["tmp"])).read(["P"], **kw)
    tt = tdata.TravelTimes("tts.h5", str(w["tmp"])).read(["P"], **kw)
    np.testing.assert_array_equal(tt.get_travel_times_array(),
                                  jt.get_travel_times_array())
    np.testing.assert_array_equal(tt.source_coordinates.index, [7, 2, 5])
    np.testing.assert_array_equal(tt.source_coordinates["depth"],
                                  jt.source_coordinates["depth"].values)


# --------------------------------------------------------------------------
# the engine
def _engines(w, **kw):
    jbf = JaxBeamformer(network=w["net"], phases=["P", "S"],
                        travel_times=w["tts"], cfg=w["cfg"], **kw)
    tbf = Beamformer(network=w["tnet"], phases=["P", "S"],
                     travel_times=w["ttts"], cfg=w["tcfg"], device="cpu")
    return jbf, tbf


POLICIES = {
    "closest": dict(method="closest_stations", num_closest_stations=3),
    "closest_normalized": dict(method="closest_stations",
                               num_closest_stations=2, normalize=True),
    "max_moveout": dict(method="max_moveout", max_moveout=40),
    "n_min_stations": dict(method="max_moveout", max_moveout=30,
                           n_min_stations=3, normalize=True),
    "station_density": dict(method="closest_stations",
                            num_closest_stations=4,
                            weight_station_density=True,
                            lower_percentile=10.0, upper_percentile=90.0),
}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_weight_policies_match_jax(world, policy):
    jbf, tbf = _engines(world)
    np.testing.assert_array_equal(tbf.moveouts, jbf.moveouts)
    jbf.set_weights_sources(**POLICIES[policy])
    tbf.set_weights_sources(**POLICIES[policy])
    np.testing.assert_allclose(tbf.weights_sources, jbf.weights_sources,
                               rtol=1e-6, atol=0)
    # with a station down on the day
    alive = np.array([True, False, True, True, True])
    jbf.data = SimpleNamespace(availability_per_sta=pd.Series(
        alive, index=[f"S{i}" for i in range(N_STA)]))
    tbf.data = SimpleNamespace(availability_stations=[
        f"S{i}" for i in range(N_STA)][::-1], availability_per_sta=alive[::-1])
    jbf.set_weights_sources(**POLICIES[policy])
    tbf.set_weights_sources(**POLICIES[policy])
    np.testing.assert_allclose(tbf.weights_sources, jbf.weights_sources,
                               rtol=1e-6, atol=0)
    assert np.all(tbf.weights_sources[:, 1] == 0.0)


def test_backproject_matches_jax_and_caches_plans(world):
    w = world
    jbf, tbf = _engines(w)
    rng = np.random.default_rng(13)
    feats = np.abs(rng.normal(size=(N_STA, 3, 3000))).astype(np.float32)
    w_ph = twf.default_weights_phases(N_STA)
    for b in (jbf, tbf):
        b.set_weights(weights_phases=w_ph)
        b.set_weights_sources(method="closest_stations",
                              num_closest_stations=4, normalize=True)
    jv, ji = jbf.backproject(feats, engine="onehot")
    tv, ti = tbf.backproject(feats)
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(ti, ji)
    assert tv.dtype == np.float32 and ti.dtype == np.int32
    jb = jbf.backproject(feats, reduce="none", out_of_bounds="flexible",
                         engine="onehot")
    tb = tbf.backproject(feats, reduce="none", out_of_bounds="flexible")
    np.testing.assert_allclose(tb, jb, rtol=1e-4, atol=1e-5)
    assert len(tbf._plans) == 2
    tbf.backproject(torch.from_numpy(feats))       # a tensor: cache hit
    assert len(tbf._plans) == 2
    tbf.set_weights_sources(method="closest_stations",
                            num_closest_stations=2, normalize=True)
    tbf.backproject(feats)                         # new weights: new plan
    assert len(tbf._plans) == 3
    for n in range(3000, 3003):                    # bounded cache
        tbf.backproject(feats[..., : n - 2])
    assert len(tbf._plans) == 4
    # the likelihood and location-uncertainty integrals
    beam = tb[:, 1234]
    np.testing.assert_allclose(tbf._likelihood(beam), jbf._likelihood(beam))
    assert tbf.location_uncertainty(beam) == pytest.approx(
        jbf.location_uncertainty(beam), rel=1e-12)
    dom = tbf._rectangular_domain(30.1, 40.1, side_km=20.0)
    np.testing.assert_array_equal(
        dom, jbf._rectangular_domain(30.1, 40.1, side_km=20.0))
    lik = tbf._likelihood(beam)[dom]
    assert tbf._compute_location_uncertainty(
        30.1, 40.1, 9.0, lik, dom) == pytest.approx(
        jbf._compute_location_uncertainty(30.1, 40.1, 9.0, lik, dom),
        rel=1e-12)


def test_backproject_day_matches_jax(world, tmp_path):
    w = world
    kw = dict(minimum_interevent_time=10.0, threshold_window_sec=150.0,
              num_closest_stations=N_STA)
    jbf, jdets = jwf.backproject_day(w["data"], w["net"], w["tts"],
                                     cfg=w["cfg"], **kw)
    out = str(tmp_path / "raw_bp.h5")
    launches = bp.bp_beam.launches
    tbf, tdets = twf.backproject_day(w["tdata"], w["tnet"], w["ttts"],
                                     cfg=w["tcfg"], output_file=out,
                                     device="cpu", **kw)
    assert bp.bp_beam.launches == launches       # the CPU: plain version
    np.testing.assert_allclose(tbf.maxbeam, jbf.maxbeam, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tbf.detection_threshold,
                               jbf.detection_threshold, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(tbf.peak_indexes, jbf.peak_indexes)
    np.testing.assert_array_equal(tbf.source_indexes, jbf.source_indexes)
    assert len(tdets) == len(jdets) >= 2
    for te, je in zip(tdets, jdets):
        assert te.origin_time == np.datetime64(je.origin_time, "ns")
        assert (te.latitude, te.longitude, te.depth) == (
            je.latitude, je.longitude, je.depth)
        assert te.aux_data["source_index"] == je.aux_data["source_index"]
        assert te.aux_data["maxbeam"] == pytest.approx(
            je.aux_data["maxbeam"], rel=1e-4)
        np.testing.assert_allclose(te.moveouts_table(),
                                   je.moveouts.values, rtol=1e-12)
    # both injected events, at the injected source
    t_det = sorted(e.origin_time_epoch - T0 for e in tdets)
    for ev_t in EVENT_TIMES:
        assert min(abs(t - ev_t) for t in t_det) < 1.0
    # the "w"-mode file holds this run's detections, in the reference schema
    ev0 = tdata.Event.read_from_file(out, gid="0")
    assert ev0.origin_time == tdets[0].origin_time
    # the other stage helpers agree
    tbf.smooth_maxbeam(2.0)
    jbf.smooth_maxbeam(2.0)
    np.testing.assert_allclose(tbf.smoothed, jbf.smoothed, rtol=1e-4,
                               atol=1e-4)
    tbf.remove_baseline(30.0)
    jbf.remove_baseline(30.0)
    np.testing.assert_allclose(tbf.maxbeam, jbf.maxbeam, rtol=1e-4,
                               atol=1e-4)
    pd.testing.assert_series_equal(tbf.return_pd_series(),
                                   jbf.return_pd_series(), check_exact=False,
                                   rtol=1e-4, atol=1e-4)


def test_backproject_day_peaks_are_the_plain_loops(world, monkeypatch):
    """A day's peaks through the native `mpd` suppression and through its
    plain loop: the same peak, source and Event indexes; the day's records
    hold the suppression's meters, kept <= candidates."""
    w = world
    kw = dict(minimum_interevent_time=10.0, threshold_window_sec=150.0,
              num_closest_stations=N_STA, device="cpu")
    plain_calls = []

    def plain(*a, **k):
        plain_calls.append(1)
        return host_ops.peak_suppression_plain(*a, **k)

    runs = {}
    for path in ("native", "plain"):
        if path == "plain":
            monkeypatch.setattr(host_ops, "peak_suppression", plain)
        with GLOBAL_TIMER.day(f"peaks-{path}", fresh=True):
            tbf, tdets = twf.backproject_day(w["tdata"], w["tnet"], w["ttts"],
                                             cfg=w["tcfg"], **kw)
        runs[path] = (tbf.peak_indexes, tbf.source_indexes,
                      [(e.origin_time, e.aux_data["source_index"])
                       for e in tdets],
                      GLOBAL_TIMER.day_meters[f"peaks-{path}"])
    assert plain_calls == [1]
    (pk, src, evs, meters), (ppk, psrc, pevs, pmeters) = (
        runs["native"], runs["plain"])
    np.testing.assert_array_equal(pk, ppk)
    np.testing.assert_array_equal(src, psrc)
    assert evs == pevs and len(evs) >= 2
    for m in (meters, pmeters):
        assert len(pk) <= m["bp_peaks_kept"] <= m["bp_peak_candidates"]
    assert meters["bp_peak_candidates"] > meters["bp_peaks_kept"]
    assert {k: meters[k] for k in ("bp_peak_candidates", "bp_peaks_kept")
            } == {k: pmeters[k] for k in ("bp_peak_candidates",
                                          "bp_peaks_kept")}


def test_scan_days_bp_campaign_matches_jax(world, tmp_path):
    w = world
    kw = dict(minimum_interevent_time=10.0, threshold_window_sec=150.0,
              num_closest_stations=N_STA)
    js, ts = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    db = str(tmp_path / "bp_db")
    jwf.scan_days(["d1", "d2"], lambda d: w["data"], cfg=w["cfg"],
                  state_file=js, stage="bp", network=w["net"],
                  travel_times=w["tts"], **kw)
    calls, engines = [], []
    orig = twf.backproject_day

    def spy(*a, **k):
        out = orig(*a, **k)
        engines.append(id(out[0]))
        return out

    twf.backproject_day = spy
    try:
        rt = twf.scan_days(["d1", "d2"],
                           lambda d: calls.append(d) or w["tdata"],
                           cfg=w["tcfg"], state_file=ts, db_path=db,
                           stage="bp", network=w["tnet"],
                           travel_times=w["ttts"], device="cpu", **kw)
    finally:
        twf.backproject_day = orig
    with open(js) as f1, open(ts) as f2:
        assert json.load(f1) == json.load(f2)
    assert set(rt) == {"d1", "d2"} and calls == ["d1", "d2"]
    for key in ("d1", "d2"):
        assert len(rt[key]) >= 2
        assert all("maxbeam" in ev.aux_data for ev in rt[key])
    assert len(set(engines)) == 1           # one Beamformer for both days
    for key in ("d1", "d2"):
        assert os.path.isfile(os.path.join(db, f"raw_bp_{key}.h5"))
    # resume: nothing re-run
    again = twf.scan_days(["d1", "d2"], lambda d: calls.append(d),
                          cfg=w["tcfg"], state_file=ts, db_path=db,
                          stage="bp", network=w["tnet"],
                          travel_times=w["ttts"], device="cpu", **kw)
    assert again == {} and calls == ["d1", "d2"]
    with pytest.raises(ValueError, match="stage='bp' requires"):
        twf.scan_days(["d1"], lambda d: w["tdata"], stage="bp")
    with pytest.raises(ValueError, match="template_group"):
        twf.scan_days(["d1"], lambda d: w["tdata"], stage="mf")
    with pytest.raises(ValueError, match="stage must be"):
        twf.scan_days(["d1"], lambda d: w["tdata"], stage="xx")


def test_unported_options_raise(world):
    w = world
    with pytest.raises(NotImplementedError, match="Queue 1 #19"):
        Beamformer(network=w["tnet"], device="cpu", mesh=object())
    # PhaseNet features and relocation are ported
    # (tests/test_torch_phasenet.py, test_torch_relocation.py); an unknown
    # relocation routine raises
    event = tdata.Event(0.0, np.zeros((1, 2)), ["A"], ["P", "S"])
    with pytest.raises(ValueError, match="unknown relocation routine"):
        event.relocate(routine="hypoinverse")
    # the plots are ported (tests/test_torch_viz.py): the max beam's line
    # holds the beam
    pytest.importorskip("matplotlib")
    _, tbf = _engines(w)
    tbf.maxbeam = np.linspace(0.0, 1.0, 50, dtype=np.float32)
    fig = tbf.plot_maxbeam(detection_indices=[3, 40])
    lines = fig.axes[0].get_lines()
    np.testing.assert_array_equal(lines[0].get_ydata(), tbf.maxbeam)
    np.testing.assert_array_equal(lines[-1].get_ydata(),
                                  tbf.maxbeam[[3, 40]])
    with pytest.raises(ValueError, match="unknown precision"):
        Beamformer(device="cpu", precision="screen")
