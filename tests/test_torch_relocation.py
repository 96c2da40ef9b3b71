"""The port's relocation and event location state against the JAX package.

A small cut of the dense-array world (`tools/dense_world.py`, equal to
`scripts/dense_array.py:build_world`) goes through `backproject_day` in
both packages; the best detection is relocated by `relocate_beam` in both,
spatial and temporal, on the same features and grid: the same
longitude/latitude/depth, the origin time within 1 us, the uncertainties
within 1e-6 relative, the same arrival-time columns.  The `Event` helpers
of the location state (distances, arrival times, outlier picks, the
covariance's marginals) are compared on seeded inputs.
"""

import copy
import os
import shutil
import sys

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from seismic_bpmf_tpu import workflow as jwf  # noqa: E402
from seismic_bpmf_tpu.data import data_reader_hdf5  # noqa: E402
from seismic_bpmf_tpu.data.events import Event as JaxEvent  # noqa: E402
from seismic_bpmf_tpu.data.network import Network as JaxNetwork  # noqa: E402
from seismic_bpmf_tpu.detection import Beamformer as JaxBeamformer  # noqa: E402
from seismic_bpmf_tpu.ops import saturated_envelopes as jax_envelopes  # noqa: E402

from seismic_bpmf_tpu_torch import workflow as twf  # noqa: E402
from seismic_bpmf_tpu_torch.data import Event, Network  # noqa: E402
from seismic_bpmf_tpu_torch.detection import Beamformer  # noqa: E402
from seismic_bpmf_tpu_torch.ops import bp  # noqa: E402
from seismic_bpmf_tpu_torch.ops.picks import PickTable  # noqa: E402
from seismic_bpmf_tpu_torch.tools import dense_world  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import dense_array  # noqa: E402

N_STA, N_SRC, SCAN_SEC, SR = 12, 2000, 600.0, 25.0
SCAN_KW = dict(num_closest_stations=12, minimum_interevent_time=20.0,
               threshold_window_sec=600.0)


@pytest.fixture(scope="module")
def world():
    cfg, net, tts, data, event_src, tmp = dense_array.build_world(
        N_STA, N_SRC, SCAN_SEC, SR)
    w = dense_world.build_world(N_STA, N_SRC, SCAN_SEC, SR)
    jbf = JaxBeamformer(data=data, network=net, phases=["P", "S"],
                        travel_times=tts, cfg=cfg)
    jbf, jdets = jwf.backproject_day(data, net, tts, cfg=cfg, bf=jbf,
                                     **SCAN_KW)
    tbf, tdets = twf.backproject_day(w.data, w.network, w.travel_times,
                                     cfg=w.cfg, device="cpu", **SCAN_KW)
    env = np.asarray(jax_envelopes(data.get_np_array(net.stations))[0])
    yield dict(cfg=cfg, net=net, tts=tts, data=data, event_src=event_src,
               tmp=tmp, w=w, jbf=jbf, tbf=tbf, jdets=jdets, tdets=tdets,
               env=env)
    shutil.rmtree(tmp, ignore_errors=True)


def _best(dets):
    return max(dets, key=lambda d: d.aux_data["maxbeam"])


def test_dense_world_equals_the_scripts_world(world):
    w = world["w"]
    assert w.event_src == world["event_src"]
    assert list(w.network.stations) == list(world["net"].stations)
    for attr in ("latitude", "longitude", "depth"):
        np.testing.assert_array_equal(getattr(w.network, attr),
                                      getattr(world["net"], attr))
    jt, tt = world["tts"], w.travel_times
    for ph in ("P", "S"):
        for sta in world["net"].stations:
            np.testing.assert_array_equal(tt.travel_times[ph][sta],
                                          jt.travel_times[ph][sta])
            np.testing.assert_array_equal(tt.travel_times_samp[ph][sta],
                                          jt.travel_times_samp[ph][sta])
    for c in ("longitude", "latitude", "depth"):
        np.testing.assert_array_equal(tt.source_coordinates[c],
                                      jt.source_coordinates[c].to_numpy())
    np.testing.assert_array_equal(
        w.data.get_np_array(w.network.stations),
        world["data"].get_np_array(world["net"].stations))
    assert w.data.date_epoch == world["data"].date_epoch
    for k in ("sampling_rate_hz", "n_dev_bp_threshold", "data_buffer_sec",
              "template_len_sec"):
        assert getattr(w.cfg, k) == getattr(world["cfg"], k)
    # the detections of both packages agree, so both relocate one event
    assert [round(d.origin_time_epoch * SR) for d in world["tdets"]] == [
        round(d.origin_time_epoch * SR) for d in world["jdets"]]


def _columns_equal(jframe, table):
    assert list(table.stations) == list(jframe.index)
    assert list(table.columns) == list(jframe.columns)
    for c in jframe.columns:
        want = jframe[c].to_numpy()
        if want.dtype.kind == "M":
            want = want.astype("datetime64[ns]")
        assert table[c].dtype == want.dtype, c
        np.testing.assert_array_equal(table[c], want)


def _relocate_both(world, method, n_win):
    """Both packages' best detection relocated on the same window of the
    JAX package's envelopes."""
    data = world["data"]
    je, te = copy.deepcopy(_best(world["jdets"])), copy.deepcopy(
        _best(world["tdets"]))
    k0 = max(0, int((je.origin_time_epoch - data.date_epoch - 10.0) * SR))
    feats = world["env"][..., k0:k0 + n_win]
    start = data.date_epoch + k0 / SR
    je.relocate(world["jbf"], feats, routine="beam",
                uncertainty_method=method, features_starttime=start)
    te.relocate(world["tbf"], feats, routine="beam",
                uncertainty_method=method, features_starttime=start)
    return je, te


@pytest.mark.parametrize("method,n_win", [("spatial", 1500),
                                          ("temporal", 2000)])
def test_relocate_beam_matches_jax(world, method, n_win):
    je, te = _relocate_both(world, method, n_win)
    assert (te.longitude, te.latitude, te.depth) == (
        je.longitude, je.latitude, je.depth)
    dt = abs(int(te.origin_time.astype("int64"))
             - int(je.origin_time.astype("datetime64[ns]").astype("int64")))
    assert dt <= 1000                                  # 1 us
    for k in ("hmax_unc", "hmin_unc", "vmax_unc", "az_hmax_unc"):
        np.testing.assert_allclose(te.aux_data[k], je.aux_data[k],
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(te.aux_data["maxbeam_reloc"],
                               je.aux_data["maxbeam_reloc"], rtol=1e-5)
    _columns_equal(je.arrival_times, te.arrival_times_table)
    pd.testing.assert_frame_equal(
        te.arrival_times,
        je.arrival_times.astype({f"{p}_abs_arrival_times": "datetime64[ns]"
                                 for p in "PS"}))
    # the injected node, within one lattice spacing
    w = world["w"]
    src = w.travel_times.source_coordinates
    e = world["event_src"]
    assert abs(te.depth - src["depth"][e]) <= w.spacing_km[2] + 1e-9
    for c in ("longitude", "latitude"):
        assert abs(getattr(te, c) - src[c][e]) <= (
            w.spacing_km[0] / dense_world.KM_PER_DEG + 1e-9)
    tbf = world["tbf"]
    assert tbf.likelihood.shape == ((N_SRC,) if method == "spatial"
                                    else (n_win,))
    assert not hasattr(tbf, "beam")     # the full beam stayed where it was


def test_spatial_and_temporal_find_the_same_hypocentre(world):
    """The temporal route (max-reduced, O(n_src) memory) finds the full
    beam's hypocentre (tests/test_pipeline.py:266-284, for the port)."""
    _, sp = _relocate_both(world, "spatial", 1500)
    _, tm = _relocate_both(world, "temporal", 1500)
    assert (sp.longitude, sp.latitude, sp.depth) == (
        tm.longitude, tm.latitude, tm.depth)
    assert sp.origin_time == tm.origin_time
    assert np.isfinite(tm.hmax_unc) and np.isfinite(tm.vmax_unc)


def test_beam_peak_is_numpys_first_argmax_of_the_full_beam(world):
    tbf = world["tbf"]
    feats = world["env"][..., 3000:3400].copy()
    feats[..., 200] = feats[..., 100]       # a repeated sample: exact ties
    full = np.asarray(tbf.backproject(feats, reduce="none",
                                      out_of_bounds="flexible"))
    del tbf.beam
    s, t, column = tbf.beam_peak(feats, out_of_bounds="flexible")
    assert (s, t) == np.unravel_index(int(full.argmax()), full.shape)
    np.testing.assert_array_equal(column, full[:, t])


def test_relocate_reads_its_own_waveforms(world):
    """waveform_features=None: each package reads the event's window
    through its reader (the JAX one from the script's HDF5 day, the port
    from memory), std-normalizes and envelopes it."""
    je, te = copy.deepcopy(_best(world["jdets"])), copy.deepcopy(
        _best(world["tdets"]))
    ot_before = te.origin_time_epoch
    je.relocate(world["jbf"], routine="beam", duration=40.0, offset_ot=10.0,
                data_reader=data_reader_hdf5)
    te.relocate(world["tbf"], routine="beam", duration=40.0, offset_ot=10.0)
    assert te.traces[0].stats.starttime == pytest.approx(ot_before - 10.0)
    assert (te.longitude, te.latitude, te.depth) == (
        je.longitude, je.latitude, je.depth)
    assert te.origin_time == je.origin_time.astype("datetime64[ns]")
    assert abs(te.origin_time_epoch - ot_before) < 2.0
    np.testing.assert_allclose(te.aux_data["hmax_unc"],
                               je.aux_data["hmax_unc"], rtol=1e-6)


def test_shared_plan_tables_give_a_built_plans_beam(world):
    tbf = world["tbf"]
    feats = world["env"][..., :1200]
    shared = tbf._plan(1200, "max", "flexible")
    base = next(p for k, p in tbf._plans.items()
                if k[2] != 1200 or k[0] != "max")
    assert shared.tables.prog is base.tables.prog       # reused, not built
    built = bp.BeamformPlan(tbf.moveouts, tbf.weights_phases,
                            tbf.weights_sources, 1200,
                            out_of_bounds="flexible", device="cpu")
    for name in ("n_samp", "n_t_blocks", "ext", "strict", "stride",
                 "max_rows", "prog_bytes", "hi_max"):
        assert getattr(shared.tables, name) == getattr(built.tables, name)
    for a, b in zip(shared(feats), built(feats)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the location state of an Event
def _pair(mv=None, stations=("ST1", "ST2", "ST3"), **kw):
    mv = (np.array([[4.0, 8.0], [5.0, 10.0], [1.0, 1.7]]) if mv is None
          else mv)
    kw = dict(dict(sampling_rate=25.0, latitude=40.05, longitude=30.1,
                   depth=7.5), **kw)
    args = ("2012-07-26T01:02:03.5", mv, list(stations), ["P", "S"])
    return JaxEvent(*args, **kw), Event(*args, **kw)


@pytest.mark.parametrize("seed", range(4))
def test_hor_ver_uncertainties_match_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(3, 3))
    cov = (a @ a.T + 0.1 * np.eye(3)).astype(np.float32)
    je, te = _pair()
    je.cov_mat = cov
    te.set_aux_data({"cov_mat": cov})     # read from aux_data as well
    je.hor_ver_uncertainties()
    for k in ("hmax_unc", "hmin_unc", "vmax_unc", "az_hmax_unc",
              "az_hmin_unc", "pl_vmax_unc"):
        assert getattr(te, k) == je.aux_data[k], k


def test_uncertainties_of_an_unlocated_event_are_the_defaults():
    je, te = _pair()
    assert (te.hmax_unc, te.vmax_unc, te.az_hmin_unc) == (
        je.hmax_unc, je.vmax_unc, je.az_hmin_unc) == (15.0, 15.0, 90.0)


def _networks():
    names = ["ST1", "ST2", "ST3", "ST4"]
    lat, lon = [40.0, 40.3, 40.9, 40.06], [30.0, 30.4, 31.2, 30.15]
    elev = [0.0, 800.0, 100.0, 20.0]
    jnet = JaxNetwork.from_dataframe(pd.DataFrame({
        "stations": names, "networks": ["XX"] * 4, "latitude": lat,
        "longitude": lon, "elevation_m": elev}))
    return jnet, Network.from_arrays(names, networks=["XX"] * 4,
                                     latitude=lat, longitude=lon,
                                     elevation_m=elev)


def _picks(ot):
    def ts(sec):
        return pd.Timestamp(np.datetime64(int((ot + sec) * 1e9), "ns"))

    return pd.DataFrame(
        {"P_picks": [117.0, 200.0, np.nan], "P_probas": [0.9, 0.8, np.nan],
         "P_unc": [1.0, 1.0, np.nan],
         "P_abs_picks": [ts(4.7), ts(8.0), pd.NaT],
         "S_picks": [210.0, 240.0, 50.0], "S_probas": [0.7, 0.6, 0.5],
         "S_unc": [1.0, 1.0, 2.0],
         "S_abs_picks": [ts(8.4), ts(9.6), ts(1.9)]},
        index=pd.Index(["ST1", "ST2", "ST3"], name="stations"))


def _set_picks(je, te, df):
    je.picks = df.copy()
    te.picks_table = PickTable.from_frame(df)


def _picks_equal(je, te):
    _columns_equal(je.picks, te.picks_table)


def test_source_receiver_distances_match_jax():
    jnet, tnet = _networks()
    je, te = _pair()
    want = je.set_source_receiver_dist(jnet)
    got = te.set_source_receiver_dist(tnet)
    np.testing.assert_array_equal(got, want.to_numpy())
    np.testing.assert_array_equal(te.source_receiver_dist, want.to_numpy())
    np.testing.assert_array_equal(
        te.source_receiver_epicentral_dist,
        je.source_receiver_epicentral_dist.to_numpy())
    _set_picks(je, te, _picks(je.origin_time_epoch))
    je.remove_distant_stations(max_distance_km=40.0)
    te.remove_distant_stations(max_distance_km=40.0)
    _picks_equal(je, te)
    far = te.source_receiver_dist[:3] > 40.0
    assert list(far) == [False, False, True]
    np.testing.assert_array_equal(np.isnat(te.picks_table["S_abs_picks"]),
                                  far)
    fresh = _pair()[1]
    with pytest.raises(RuntimeError, match="set_source_receiver_dist"):
        fresh.source_receiver_dist


def test_arrival_times_from_moveouts_match_jax():
    je, te = _pair()
    je.set_arrival_times_from_moveouts()
    te.set_arrival_times_from_moveouts()
    _columns_equal(je.arrival_times, te.arrival_times_table)
    # the origin moves: update_travel_times re-reads the absolute times
    for ev in (je, te):
        ev.origin_time = np.datetime64("2012-07-26T01:02:02.250000001", "ns")
        ev.update_travel_times()
    _columns_equal(je.arrival_times, te.arrival_times_table)
    # the DataFrame view is the JAX package's table
    pd.testing.assert_frame_equal(
        te.arrival_times,
        je.arrival_times.astype({f"{p}_abs_arrival_times": "datetime64[ns]"
                                 for p in "PS"}))


def test_update_travel_times_keeps_the_relocation_dtype():
    """relocate_beam's tt columns are float32: an update keeps them so."""
    je, te = _pair()
    ot = je.origin_time_epoch
    at = pd.DataFrame(
        {"P_tt_sec": np.array([4.5, 5.5, 1.0], np.float32),
         "P_abs_arrival_times": [pd.Timestamp(np.datetime64(
             int((ot + s) * 1e9), "ns")) for s in (4.5, 5.5, 1.0)]},
        index=pd.Index(["ST1", "ST2", "ST3"], name="stations"))
    je.arrival_times = at.copy()
    te.arrival_times = at.copy()      # a DataFrame set on the port's event
    for ev in (je, te):
        ev.origin_time = np.datetime64("2012-07-26T01:02:03.1", "ns")
        ev.update_travel_times()
    _columns_equal(je.arrival_times, te.arrival_times_table)


def test_moveouts_to_empirical_and_theoretical_times_match_jax():
    je, te = _pair()
    _set_picks(je, te, _picks(je.origin_time_epoch))
    je.set_moveouts_to_empirical_times()
    te.set_moveouts_to_empirical_times()
    pd.testing.assert_frame_equal(te.moveouts, je.moveouts)
    tt = pd.DataFrame({"P": [3.0, 3.5], "S": [6.0, 6.5]},
                      index=pd.Index(["ST2", "ST3"]))
    je.set_moveouts_to_theoretical_times(tt)
    te.set_moveouts_to_theoretical_times(PickTable.from_frame(tt))
    pd.testing.assert_frame_equal(te.moveouts, je.moveouts)
    je.update_picks()
    te.update_picks()
    _picks_equal(je, te)


@pytest.mark.parametrize("case", ["moveouts", "nlloc_table", "min_tt"])
def test_remove_outlier_picks_matches_jax(case):
    je, te = _pair()
    ot = je.origin_time_epoch
    _set_picks(je, te, _picks(ot))
    if case == "nlloc_table":
        # NLLoc-predicted travel times; no absolute column (ot + tt)
        at = pd.DataFrame(
            {"P_tt_sec": [4.5, 5.5, np.nan], "P_residuals_sec": [0.0] * 3,
             "S_tt_sec": [np.nan, 9.5, 2.2], "S_residuals_sec": [0.0] * 3},
            index=pd.Index(["ST1", "ST2", "ST3"], name="stations"))
        je.arrival_times = at
        te.arrival_times_table = PickTable.from_frame(at)
    elif case == "min_tt":
        for ev in (je, te):
            ev.set_arrival_times_from_moveouts()
    for ev in (je, te):
        ev.remove_outlier_picks(max_diff_percent=25.0,
                                min_tt=0.5 if case == "min_tt" else 2.0)
    _picks_equal(je, te)


def test_picks_and_arrival_times_are_dataframes_only_when_read():
    _, te = _pair()
    assert not hasattr(te, "picks") and not hasattr(te, "arrival_times")
    te.set_arrival_times_from_moveouts()
    assert isinstance(te._tables["arrival_times"], PickTable)
    table = te.arrival_times_table
    assert te.arrival_times_table is table    # one object, read twice
    table["P_tt_sec"][1] = 42.0               # an edit of the table persists
    frame = te.arrival_times
    assert te.arrival_times is frame
    assert frame.index.name == "stations" and list(frame.columns) == [
        "P_abs_arrival_times", "P_tt_sec", "S_abs_arrival_times", "S_tt_sec"]
    assert frame.loc["ST2", "P_tt_sec"] == 42.0
    frame.loc["ST1", "P_tt_sec"] = 99.0       # an edit of the view persists
    table = te.arrival_times_table
    assert table["P_tt_sec"][0] == 99.0 and table["P_tt_sec"][1] == 42.0
    assert te.arrival_times_table is table
