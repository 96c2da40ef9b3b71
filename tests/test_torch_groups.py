"""The port's event, template and family layer against the JAX package's,
on the CPU: a family of six repeats of one event on 4 stations x 3
components (25 Hz, an 1,800 s day in one HDF5 file that both packages'
`data_reader_hdf5` read), each package's Events and Templates built on it.

- `Event`: availability, component aliases, `get_np_array`, peak
  amplitudes, SNR, the n closest / best-SNR stations, clipped traces, the
  aux-data update of a database: equal values (the port keeps numpy
  arrays where the JAX package keeps Series and DataFrames).
- `Template`: `template_idx`, `moveouts_win`, `distance`,
  `find_monochromatic_traces`, `read_catalog` of a detection file written
  by the port's `write_detections` (read by both packages), summaries.
- `TemplateGroup`: `box`, `n_closest_stations`, `n_best_SNR_stations`,
  `normalize`, `set_network`, the channel map and `read_catalog`.
- The family chain `EventGroup.read_waveforms` -> `get_waveforms_arr` ->
  `normalize` -> `SVDWF_stack` -> `Stack.read_waveforms` ->
  `pick_PS_phases_family_mode` on a seeded depth-3 PhaseNet whose Flax
  weights are carried across with `from_flax_variables`: the stacks within
  1e-6 of their maximum (the JAX stack is float32 from scipy, the port's
  from torch's float64), the picks within rtol 1e-4 (two libraries' f32
  probabilities), NaN where the JAX package has NaN.
- `fetch_detection_waveforms`, `fetch_detection_waveforms_refilter` and
  `svdwf_multiplets` on the template's detection file.
- The family mode skips a member without data and lets any other error
  propagate (the JAX package skips a member on any exception).
"""

import os

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import seismic_bpmf_tpu.data as jdata  # noqa: E402
from seismic_bpmf_tpu.models import phasenet as jpn  # noqa: E402
from seismic_bpmf_tpu.utils import stacking as jstacking  # noqa: E402

import seismic_bpmf_tpu_torch.data as tdata  # noqa: E402
from seismic_bpmf_tpu_torch.models import phasenet as tpn  # noqa: E402
from seismic_bpmf_tpu_torch.utils import stacking  # noqa: E402

SR = 25.0
DAY = 1800.0
T0 = 1343260800.0
STATIONS = ["S0", "S1", "S2", "S3"]
EVENT_TIMES = [100.0, 350.0, 600.0, 850.0, 1100.0, 1350.0]
TT_P = np.array([2.0, 2.8, 3.6, 4.4])
RTOL_PICKS = 1e-4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("family")
    rng = np.random.default_rng(21)
    n = int(DAY * SR)
    n_w = int(2.0 * SR)
    t = np.arange(n_w) / SR
    wavelet = np.sin(2 * np.pi * 4.0 * t) * np.hanning(n_w)
    st = tdata.Stream()
    for s, sta in enumerate(STATIONS):
        for comp in "NEZ":
            x = 0.1 * rng.normal(size=n)
            for e, ev_t in enumerate(EVENT_TIMES):
                tt = TT_P[s] * (1.0 if comp == "Z" else 1.7)
                k = int(round((ev_t + tt) * SR))
                x[k:k + n_w] += (2.0 + 0.2 * e) * wavelet
            if sta == "S3" and comp == "E":
                x = np.clip(x, -0.05, 0.05)           # a clipped channel
            st += tdata.Trace(x.astype(np.float32), station=sta,
                              network="XX", channel=f"HH{comp}",
                              sampling_rate=SR, starttime=T0)
    path = str(tmp / "day.h5")
    tdata.write_hdf5_continuous(path, st)
    md = pd.DataFrame({"stations": STATIONS, "networks": ["XX"] * 4,
                       "latitude": 40.0 + 0.05 * np.arange(4),
                       "longitude": 30.0 + 0.05 * np.arange(4),
                       "elevation_m": np.zeros(4)})
    mv = np.stack([TT_P, 1.7 * TT_P], axis=1).astype(np.float32)

    def events(pkg):
        return [pkg.Event(
            np.datetime64(int((T0 + ev_t) * 1e9), "ns"), mv, STATIONS,
            ["P", "S"], data_filename="day.h5", data_path=str(tmp),
            latitude=40.05 + 0.01 * e, longitude=30.05 + 0.02 * e,
            depth=5.0 + e, sampling_rate=SR,
            data_reader=pkg.data_reader_hdf5,
        ) for e, ev_t in enumerate(EVENT_TIMES)]

    return dict(tmp=tmp, path=path, mv=mv,
                net=tdata.Network.from_dataframe(md),
                jnet=jdata.Network.from_dataframe(md),
                events=lambda: events(tdata), jevents=lambda: events(jdata))


def _read(evs, duration=10.0):
    for ev in evs:
        ev.read_waveforms(duration, offset_phase={"P": 1.0, "S": 2.0})
    return evs


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# Event
# ---------------------------------------------------------------------------
def _availability(ev, jev):
    ev.set_availability()
    jev.set_availability()
    _eq(ev.availability, jev.availability.values)


def _aliases(ev, jev):
    aliases = {"N": ["1", "N"], "E": ["2", "E"], "Z": ["Z"]}
    ev.set_component_aliases(aliases)
    jev.set_component_aliases(aliases)
    assert ev.component_aliases == jev.component_aliases == aliases
    _eq(ev.get_np_array(), jev.get_np_array())


def _snr(ev, jev):
    _eq(ev.compute_snr(), jev.compute_snr().values)
    _eq(ev.compute_snr(2.0), jev.compute_snr(2.0).values)
    for cp in "NEZ":
        _eq(ev.aux_data[f"snr_{cp}"], jev.aux_data[f"snr_{cp}"].values)
    for avail in (None, ["S0", "S2", "S3"]):
        _eq(ev.n_best_SNR_stations(2, avail),
            jev.n_best_SNR_stations(2, avail))


def _closest(ev, jev):
    for n, avail in ((2, None), (3, ["S3", "S1"]), (5, None)):
        _eq(ev.n_closest_stations(n, avail), jev.n_closest_stations(n, avail))


def _clipped(ev, jev):
    ev.zero_out_clipped_waveforms()
    jev.zero_out_clipped_waveforms()
    arr = ev.get_np_array()
    _eq(arr, jev.get_np_array())
    assert not arr[3, 1].any() and arr[3, 0].any()


EVENT_CASES = {
    "availability": _availability,
    "set_component_aliases": _aliases,
    "get_np_array": lambda ev, jev: (
        _eq(ev.get_np_array(), jev.get_np_array()),
        _eq(ev.get_np_array(["S2", "S0"], ["Z"]),
            jev.get_np_array(["S2", "S0"], ["Z"]))),
    "get_peak_amplitudes": lambda ev, jev: (
        _eq(ev.get_peak_amplitudes(), jev.get_peak_amplitudes()),
        _eq(ev.get_peak_amplitudes(["S1"], ["N", "Z"]),
            jev.get_peak_amplitudes(["S1"], ["N", "Z"]))),
    "compute_snr_and_best_stations": _snr,
    "n_closest_stations": _closest,
    "zero_out_clipped_waveforms": _clipped,
}


@pytest.mark.parametrize("case", sorted(EVENT_CASES))
def test_event_methods_match_jax(world, case):
    ev, jev = _read(world["events"]()[:1])[0], _read(world["jevents"]()[:1])[0]
    EVENT_CASES[case](ev, jev)


def test_event_availability_needs_set_availability(world):
    ev = world["events"]()[0]
    with pytest.raises(RuntimeError, match="set_availability"):
        ev.availability
    with pytest.raises(RuntimeError, match="compute_snr"):
        ev.snr


def test_update_aux_data_database_matches_jax(world, tmp_path):
    ev = _read(world["events"]()[:1])[0]
    ev.set_aux_data({"cc": 0.5, "tid": "7"})
    ev.write("ev.h5", db_path=str(tmp_path), gid="g")
    ev.set_aux_data({"cc": 0.75, "Mw": np.float64(2.5),
                     "stations_used": np.array(["S0", "S2"])})
    ev.update_aux_data_database(["cc", "Mw", "stations_used"],
                                filename="ev.h5", db_path=str(tmp_path),
                                gid="g")
    for pkg in (tdata, jdata):
        back = pkg.Event.read_from_file("ev.h5", db_path=str(tmp_path),
                                        gid="g")
        assert back.aux_data["cc"] == 0.75 and back.aux_data["Mw"] == 2.5
        assert back.aux_data["tid"] == "7"
        _eq(np.asarray(back.aux_data["stations_used"]).astype("U"),
            ["S0", "S2"])


# ---------------------------------------------------------------------------
# Template and TemplateGroup
# ---------------------------------------------------------------------------
def _templates(pkg, evs):
    out = []
    for i, ev in enumerate(evs):
        tp = pkg.Template.init_from_event(ev)
        tp.set_aux_data({"tid": i})
        tp.id = str(i)
        out.append(tp)
    return out


@pytest.fixture(scope="module")
def banks(world):
    evs, jevs = _read(world["events"]()), _read(world["jevents"]())
    tps, jtps = _templates(tdata, evs), _templates(jdata, jevs)
    return dict(tps=tps, jtps=jtps, evs=evs, jevs=jevs)


def _monochromatic(tp, jtp):
    for t in (tp, jtp):
        t.traces[0].data = np.sin(np.arange(250) / 2.0).astype(np.float32)
    assert tp.find_monochromatic_traces() == jtp.find_monochromatic_traces()
    assert len(tp.find_monochromatic_traces()) >= 1
    assert (tp.find_monochromatic_traces(0.9, 50)
            == jtp.find_monochromatic_traces(0.9, 50))


def _template_idx(tp, jtp):
    assert tp.template_idx == jtp.template_idx == "2"


def _distance(tp, jtp):
    for point in ((30.2, 40.1, 3.0), (30.05, 40.05, 5.0)):
        assert tp.distance(*point) == jtp.distance(*point)


TEMPLATE_CASES = {
    "template_idx": _template_idx,
    "moveouts_win": lambda tp, jtp: pd.testing.assert_frame_equal(
        tp.moveouts_win, jtp.moveouts_win, check_dtype=False),
    "distance": _distance,
    "find_monochromatic_traces": _monochromatic,
}


@pytest.mark.parametrize("case", sorted(TEMPLATE_CASES))
def test_template_methods_match_jax(world, case):
    ev, jev = _read(world["events"]()[2:3])[0], _read(
        world["jevents"]()[2:3])[0]
    tp, jtp = _templates(tdata, [ev])[0], _templates(jdata, [jev])[0]
    tp.id = jtp.id = "2"
    TEMPLATE_CASES[case](tp, jtp)


def test_template_summary_round_trips_with_jax(banks, tmp_path):
    tp, jtp = banks["tps"][0], banks["jtps"][0]
    summary = {"rt": np.arange(5.0), "cc": np.float32([0.5, 0.7])}
    tp.write_summary(summary, db_path=str(tmp_path))
    for t in (tp, jtp):
        got = t.read_summary(db_path=str(tmp_path))
        assert sorted(got) == ["cc", "rt"]
        for k in summary:
            _eq(got[k], summary[k])
    assert tp.read_summary(filename="none.h5", db_path=str(tmp_path)) == {}


def _write_detections(tp, evs, db_path, ccs):
    for ev, cc in zip(evs, ccs):
        ev.set_aux_data({"cc": cc, "n_dev": 10 * cc, "tid": tp.tid})
    tp.write_detections(evs, db_path=db_path)


def _catalogs_equal(cat, jcat):
    assert cat.n_events == jcat.n_events
    for c in jcat.catalog.columns:
        want = jcat.catalog[c].to_numpy()
        got = cat[c]
        if want.dtype.kind in "fM":
            _eq(got.astype(want.dtype), want)
        else:
            _eq(np.asarray(got).astype(str), want.astype(str))


def test_read_catalog_of_port_detection_files_matches_jax(world, banks,
                                                          tmp_path):
    db = str(tmp_path)
    evs = world["events"]()
    _write_detections(banks["tps"][0], evs[:4], db, [0.9, 0.8, 0.7, 0.6])
    _write_detections(banks["tps"][1], evs[3:], db, [0.5, 0.55, 0.65])
    _catalogs_equal(banks["tps"][0].read_catalog(db_path=db),
                    banks["jtps"][0].read_catalog(db_path=db))
    group = tdata.TemplateGroup(banks["tps"][:3], world["net"])
    jgroup = jdata.TemplateGroup(banks["jtps"][:3], world["jnet"])
    cat = group.read_catalog(db_path=db)
    _catalogs_equal(cat, jgroup.read_catalog(db_path=db))
    assert cat.n_events == 7 and group.catalog is cat
    with pytest.raises(FileNotFoundError):
        tdata.TemplateGroup(banks["tps"][3:4], world["net"]).read_catalog(
            db_path=db)


def _group_pair(world, banks):
    return (tdata.TemplateGroup(banks["tps"], world["net"]),
            jdata.TemplateGroup(banks["jtps"], world["jnet"]))


def _box(g, jg):
    for box in ((30.05, 30.13, 40.0, 40.1), (29.0, 31.0, 40.07, 40.2)):
        sub, jsub = g.box(*box), jg.box(*box)
        _eq(sub.tids, jsub.tids)
        assert 0 < sub.n_templates < g.n_templates


def _normalize(g, jg):
    for method in ("rms", "max"):
        g.normalize(method)
        jg.normalize(method)
        _eq(g.waveforms_arr, jg.waveforms_arr)
    with pytest.raises(ValueError):
        g.normalize("l1")


def _set_network(g, jg):
    g.normalize("max")
    jg.normalize("max")
    _ = g.ellipsoid_distances, jg.ellipsoid_distances
    sub = g.network.subset(["S3", "S1"], ["N", "E", "Z"])
    jsub = jg.network.subset(["S3", "S1"], ["N", "E", "Z"])
    g.set_network(sub)
    jg.set_network(jsub)
    assert g.waveforms_arr.shape[1] == 2
    _eq(g.waveforms_arr, jg.waveforms_arr)
    _eq(g.moveouts_arr, jg.moveouts_arr)
    assert not hasattr(g, "_ellips_dist")


def _network_map(g, jg):
    g.set_network_to_template_map()
    jg.set_network_to_template_map()
    _eq(g.network_to_template_map, jg.network_to_template_map)


TEMPLATE_GROUP_CASES = {
    "box": _box,
    "n_closest_stations": lambda g, jg: [
        _eq(a, b) for a, b in zip(
            g.n_closest_stations(2, ["S1", "S2", "S3"]).values(),
            jg.n_closest_stations(2, ["S1", "S2", "S3"]).values())],
    "n_best_SNR_stations": lambda g, jg: [
        _eq(a, b) for a, b in zip(g.n_best_SNR_stations(3).values(),
                                  jg.n_best_SNR_stations(3).values())],
    "normalize": _normalize,
    "set_network": _set_network,
    "set_network_to_template_map": _network_map,
}


@pytest.mark.parametrize("case", sorted(TEMPLATE_GROUP_CASES))
def test_template_group_methods_match_jax(world, case):
    evs, jevs = _read(world["events"]()), _read(world["jevents"]())
    banks = dict(tps=_templates(tdata, evs), jtps=_templates(jdata, jevs))
    g, jg = _group_pair(world, banks)
    TEMPLATE_GROUP_CASES[case](g, jg)


def test_n_best_snr_falls_back_to_the_closest_stations(world):
    tp = tdata.Template.init_from_event(_read(world["events"]()[:1])[0])
    del tp.traces
    g = tdata.TemplateGroup([tp], world["net"])
    assert list(g.n_best_SNR_stations(2)[tp.tid]) == list(
        tp.n_closest_stations(2))


# ---------------------------------------------------------------------------
# the family chain: EventGroup -> SVDWF stack -> Stack -> family picks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pickers():
    jm = jpn.PhaseNet(depth=3, filters_root=4)
    jv = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(3), np.zeros((1, 3001, 3), np.float32),
        train=False))
    tm = tpn.PhaseNet(depth=3, filters_root=4)
    tm.load_state_dict(tpn.from_flax_variables(jv))
    return tpn.make_picker(tm.eval()), jpn.make_picker(jm, jv)


def _groups(world):
    g = tdata.EventGroup(world["events"](), world["net"])
    jg = jdata.EventGroup(world["jevents"](), world["jnet"])
    kw = dict(offset_phase={"P": 1.0, "S": 2.0})
    g.read_waveforms(12.0, **kw)
    jg.read_waveforms(12.0, **kw)
    return g, jg


def _close(got, want, rel=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def test_event_group_arrays_match_jax(world):
    g, jg = _groups(world)
    _eq(g.get_moveouts_arr(), jg.get_moveouts_arr())
    _eq(g.get_waveforms_arr(), jg.get_waveforms_arr())
    assert g.waveforms_arr.shape == (6, 4, 3, 300)
    for method in ("max", "rms"):
        g.normalize(method)
        jg.normalize(method)
        _eq(g.waveforms_arr, jg.waveforms_arr)
    sub = world["net"].subset(["S2", "S0"], ["N", "E", "Z"])
    g.set_network(sub)
    jg.set_network(world["jnet"].subset(["S2", "S0"], ["N", "E", "Z"]))
    assert g.waveforms_arr.shape[1] == 2
    _eq(g.waveforms_arr, jg.waveforms_arr)
    with pytest.raises(ValueError):
        g.normalize("l1")


def test_family_chain_matches_jax(world, pickers):
    picker, jpicker = pickers
    g, jg = _groups(world)
    for grp in (g, jg):
        grp.get_waveforms_arr()
        grp.normalize("rms")
    stack = g.SVDWF_stack(2.0, 10.0, SR, device="cpu")
    jstack = jg.SVDWF_stack(2.0, 10.0, SR)
    # both packages stamp a new Stack's origin with the wall clock, so two
    # stacks built seconds apart may lie in different seconds: give the
    # JAX stack the port's origin, and compare what each does from there
    assert abs(stack.origin_time - jstack.origin_time) < np.timedelta64(
        10, "m")
    jstack.origin_time = stack.origin_time
    arr, jarr = stack.get_np_array(), jstack.waveforms_arr
    assert arr.shape == (4, 3, 300) and np.abs(arr).max() > 0
    _close(arr, jarr)
    assert stack.events is g.events
    for time_shifted in (True, False):
        kw = dict(offset_phase={"P": 2.0, "S": 3.0},
                  time_shifted=time_shifted, offset_ot=4.0)
        stack.read_waveforms(10.0, **kw)
        jstack.read_waveforms(10.0, **kw)
        _close(stack.get_np_array(), jstack.waveforms_arr)
        _eq(stack.availability, jstack.availability.values)
    stack.set_arrival_times_from_moveouts(offset_ot=-3.0)
    jstack.set_arrival_times_from_moveouts(offset_ot=-3.0)
    assert stack.origin_time == jstack.origin_time
    for ph in "PS":
        _eq(stack.arrival_times_table[f"{ph}_abs_arrival_times"],
            jstack.arrival_times[f"{ph}_abs_arrival_times"].to_numpy())
    # the members picked from windows read around their origin times, at
    # thresholds from the probabilities' quantiles (random weights)
    for grp in (g, jg):
        for ev in grp.events:
            del ev.traces
    from scipy.signal import resample_poly

    x = world["jevents"]()[0].read_waveforms(
        40.0, time_shifted=False, offset_ot=10.0).waveforms_arr
    probas = jpicker(resample_poly(x[:, [2, 0, 1]], 4, 1, axis=-1))
    thr = {f"threshold_{ph}": float(np.quantile(probas[:, p], 0.9))
           for p, ph in enumerate("PS")}
    kw = dict(offset_ot=10.0, **thr)
    table = stack.pick_PS_phases_family_mode(40.0, picker, **kw)
    frame = jstack.pick_PS_phases_family_mode(40.0, jpicker, **kw)
    assert stack.picks_table is table and list(table.stations) == list(
        frame.index)
    for c in frame.columns:
        want = frame[c].to_numpy(np.float64)
        np.testing.assert_array_equal(np.isnan(table[c]), np.isnan(want))
        np.testing.assert_allclose(table[c][~np.isnan(want)],
                                   want[~np.isnan(want)], rtol=RTOL_PICKS,
                                   atol=RTOL_PICKS)
    assert np.isfinite(table["P_picks"]).any()


class _NoFile:
    def __call__(self, where, **kwargs):
        raise FileNotFoundError(where)


def test_family_mode_skips_members_without_data_only(world, pickers):
    picker, _ = pickers
    g, _ = _groups(world)
    stack = g.SVDWF_stack(2.0, 10.0, SR, device="cpu")
    members = stack.events
    for ev in members:
        del ev.traces
    members[0].data_reader = _NoFile()
    members[1].data_reader = None
    kw = dict(offset_ot=10.0, threshold_P=0.0, threshold_S=0.0)
    table = stack.pick_PS_phases_family_mode(40.0, picker, **kw)
    assert table is not None and np.isfinite(table["P_picks"]).all()
    alone = tdata.Stack(np.zeros((4, 3, 10), np.float32), STATIONS, "NEZ",
                        SR, moveouts=world["mv"])
    alone.events = members[:2]
    assert alone.pick_PS_phases_family_mode(40.0, picker, **kw) is None

    def broken(x):
        raise RuntimeError("CUDA error: an illegal memory access")

    with pytest.raises(RuntimeError, match="illegal memory"):
        stack.pick_PS_phases_family_mode(40.0, broken, **kw)
    with pytest.raises(RuntimeError, match="no member"):
        tdata.Stack(np.zeros((4, 3, 10), np.float32), STATIONS, "NEZ",
                    SR).pick_PS_phases_family_mode(40.0, picker)


# ---------------------------------------------------------------------------
# a template's detection file -> waveforms -> the SVDWF stack
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def detections(world, tmp_path_factory):
    db = str(tmp_path_factory.mktemp("det"))
    evs = world["events"]()
    tp = tdata.Template.init_from_event(_read(world["events"]()[:1])[0])
    tp.set_aux_data({"tid": 0})
    tp.id = "0"
    jtp = jdata.Template.init_from_event(_read(world["jevents"]()[:1])[0])
    jtp.set_aux_data({"tid": 0})
    jtp.id = "0"
    _write_detections(tp, evs, db, [0.9, 0.5, 0.8, 0.6, 0.95, 0.7])
    return tp, jtp, db


FETCH_CASES = {
    "all": dict(),
    "best_cc": dict(best_cc=True, flip_order=False),
    "top_3": dict(max_n_events=3, norm_rms=False),
    "unordered": dict(ordering=None, return_event_ids=True),
}


@pytest.mark.parametrize("case", sorted(FETCH_CASES))
def test_fetch_detection_waveforms_matches_jax(detections, case):
    tp, jtp, db = detections
    kw = dict(db_path=db, duration=10.0,
              offset_phase={"P": 1.0, "S": 2.0}, **FETCH_CASES[case])
    got = stacking.fetch_detection_waveforms(
        tp, data_reader=tdata.data_reader_hdf5, **kw)
    want = jstacking.fetch_detection_waveforms(
        jtp, data_reader=jdata.data_reader_hdf5, **kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _eq(a, b)
    assert got[0].shape[0] >= 3


def test_fetch_detection_waveforms_refilter_matches_jax(detections):
    tp, jtp, db = detections
    kw = dict(db_path=db, max_n_events=4, target_sr=12.5, integrate=True)
    got = stacking.fetch_detection_waveforms_refilter(
        tp, 1.0, 5.0, 10.0, data_reader=tdata.data_reader_hdf5, **kw)
    want = jstacking.fetch_detection_waveforms_refilter(
        jtp, 1.0, 5.0, 10.0, data_reader=jdata.data_reader_hdf5, **kw)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert got[0].shape == (4, 4, 3, 125)


def test_svdwf_multiplets_matches_jax(detections):
    tp, jtp, db = detections
    kw = dict(db_path=db, duration=10.0, freqmin=2.0, freqmax=10.0,
              offset_phase={"P": 1.0, "S": 2.0})
    stack = stacking.svdwf_multiplets(tp, data_reader=tdata.data_reader_hdf5,
                                      device="cpu", **kw)
    jstack = jstacking.svdwf_multiplets(
        jtp, data_reader=jdata.data_reader_hdf5, **kw)
    _close(stack.get_np_array(), jstack.waveforms_arr)
    _eq(stack.moveouts_table(), jstack.moveouts.values)
    with pytest.raises(ValueError, match="no detections"):
        stacking.svdwf_multiplets(
            tp, detection_waveforms=np.zeros((0,)), device="cpu")
    assert os.path.isfile(os.path.join(db, "detections_tp0.h5"))
