"""The month-long two-step workflow (BASELINE config 3) through the port
against the JAX package's `scripts/month_workflow.py`, on the CPU, at a cut:
5 stations, 300 sources, two days of 1,800 s, and a tiny picker (depth 3,
filters_root 4) whose Flax weights are carried across with
`from_flax_variables`.

- `tools/month_world.py` is the script's world: the same network, travel
  times, days (bit for bit) and training windows; each day is drawn once
  into its workdir and loaded after.
- The chain: the same BP detections (origin times and sources) on each
  day, the same template bank (arrays bit for bit), the same MF
  detections (template, origin time; CC within 1e-5), and the same
  catalog (rows and `unique_event`).  The JAX MF engine draws its
  threshold zero-fill from numpy's global state and the port from an
  explicit generator, so their thresholds differ by the draw; the events
  here stand far above either.
- The resume: a second campaign over the same state files runs nothing.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import seismic_bpmf_tpu.models as jmodels  # noqa: E402
from seismic_bpmf_tpu import workflow as jwf  # noqa: E402
from seismic_bpmf_tpu.data import data_reader_hdf5  # noqa: E402
from seismic_bpmf_tpu.models import phasenet as jpn  # noqa: E402

from seismic_bpmf_tpu_torch import workflow as twf  # noqa: E402
from seismic_bpmf_tpu_torch.models import phasenet as tpn  # noqa: E402
from seismic_bpmf_tpu_torch.tools import month_workflow as tmw  # noqa: E402
from seismic_bpmf_tpu_torch.tools.month_world import (  # noqa: E402
    build_world, training_windows,
)

N_STA, N_SRC, DAY_SEC = 5, 300, 1800.0
DATES = tmw.dates_of(2)
SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "month_workflow.py")


def _script():
    spec = importlib.util.spec_from_file_location("month_workflow_script",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("month"))
    cfg, net, tts, make_data, wavelet = _script().build_world(
        tmp, n_sta=N_STA, n_src=N_SRC, day_sec=DAY_SEC)
    jm = jpn.PhaseNet(depth=3, filters_root=4)
    jv = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(1), np.zeros((1, 3001, 3), np.float32),
        train=False))
    tm = tpn.PhaseNet(depth=3, filters_root=4)
    tm.load_state_dict(tpn.from_flax_variables(jv))
    return dict(tmp=tmp, cfg=cfg, net=net, tts=tts, make_data=make_data,
                wavelet=wavelet, jm=jm, jv=jv, tm=tm.eval(),
                world=build_world(str(tmp_path_factory.mktemp("days")),
                                  n_sta=N_STA, n_src=N_SRC,
                                  day_sec=DAY_SEC))


def test_month_world_is_the_scripts(worlds, monkeypatch):
    w, tw = worlds, worlds["world"]
    assert list(tw.network.stations) == list(w["net"].stations)
    for attr in ("latitude", "longitude"):
        np.testing.assert_array_equal(getattr(tw.network, attr),
                                      getattr(w["net"], attr))
    for ph in ("P", "S"):
        for sta in w["net"].stations:
            np.testing.assert_array_equal(
                tw.travel_times.travel_times[ph][sta],
                w["tts"].travel_times[ph][sta])
    np.testing.assert_array_equal(tw.wavelet, w["wavelet"])
    for date in DATES:
        np.testing.assert_array_equal(
            tw.make_data(date).get_np_array(tw.network.stations),
            w["make_data"](date).get_np_array(w["net"].stations))
    # the picker's training windows: what the script hands its trainer
    seen = {}

    def capture(x, picks, **kw):
        seen.update(x=x, picks=picks, kw=kw)
        raise RuntimeError("captured")

    monkeypatch.setattr(jmodels, "train_phasenet", capture)
    with pytest.raises(RuntimeError, match="captured"):
        _script().train_picker(w["wavelet"])
    x, picks = training_windows(tw.wavelet)
    assert np.array_equal(x, seen["x"].transpose(0, 2, 1))
    assert np.array_equal(picks, seen["picks"])
    assert {k: seen["kw"][k] for k in tmw.TRAIN_KW} == tmw.TRAIN_KW


def test_month_world_draws_each_day_once_into_its_workdir(worlds,
                                                         tmp_path):
    """A day is drawn once, written whole and loaded after (the script's
    HDF5 days): the same day in a fresh folder as the fixture's, and a
    world over the same folder loads the file instead of drawing."""
    from seismic_bpmf_tpu_torch.utils.observe import GLOBAL_TIMER

    tw = worlds["world"]
    kw = dict(workdir=str(tmp_path), n_sta=N_STA, n_src=N_SRC,
              day_sec=DAY_SEC)
    drawn = GLOBAL_TIMER.counts["month_draw"]
    np.testing.assert_array_equal(build_world(**kw).day(DATES[0]),
                                  tw.day(DATES[0]))
    assert sorted(os.listdir(tmp_path)) == [f"{DATES[0]}.npy"]
    assert GLOBAL_TIMER.counts["month_draw"] == drawn + 1
    marked = tw.day(DATES[0]) + 1.0
    np.save(tmp_path / f"{DATES[0]}.npy", marked)
    loaded = GLOBAL_TIMER.counts["month_load"]
    np.testing.assert_array_equal(build_world(**kw).day(DATES[0]), marked)
    assert GLOBAL_TIMER.counts["month_load"] == loaded + 1
    assert GLOBAL_TIMER.counts["month_draw"] == drawn + 1


@pytest.fixture(scope="module")
def chains(worlds):
    """Both packages' chains over the two days: BP -> bank from day 0 ->
    MF at `screen` -> catalog, with the script's arguments."""
    w, tw = worlds, worlds["world"]
    tmp = w["tmp"]
    jfeat = jwf.phasenet_feature_fn(w["jm"], w["jv"], device=True)
    jbp = jwf.scan_days(
        DATES, w["make_data"], cfg=w["cfg"], stage="bp", network=w["net"],
        travel_times=w["tts"], state_file=os.path.join(tmp, "jbp.json"),
        db_path=tmp, feature_fn=jfeat, num_closest_stations=N_STA,
        precision="high", **tmw.BP_KW)
    jtg = jwf.build_templates(jbp[DATES[0]], w["net"], cfg=w["cfg"],
                              data_reader=data_reader_hdf5,
                              dedup_similarity=0.9)
    np.random.seed(0)
    jmf = jwf.scan_days(DATES, w["make_data"], jtg, cfg=w["cfg"],
                        state_file=os.path.join(tmp, "jmf.json"),
                        precision="screen", **tmw.MF_KW)

    states = [os.path.join(tmp, f"t{s}.json") for s in ("bp", "mf")]
    tfeat = twf.phasenet_feature_fn(w["tm"])
    tbp = tmw.bp_campaign(tw, DATES, tfeat, states[0], device="cpu")
    ttg = tmw.template_bank(tw, tbp[DATES[0]], device="cpu")
    tmf = tmw.mf_campaign(tw, DATES, ttg, states[1], device="cpu")
    jall = {}
    for day in jmf.values():
        for tid, evs in day.items():
            jall.setdefault(tid, []).extend(evs)
    return dict(jbp=jbp, jtg=jtg, jmf=jmf,
                jcat=jwf.assemble_catalog(jall, jtg).catalog,
                tbp=tbp, ttg=ttg, tmf=tmf, states=states, tfeat=tfeat,
                tcat=tmw.catalog_of(tmf, ttg, device="cpu"))


def test_bp_campaign_matches_jax(chains):
    c = chains
    assert set(c["tbp"]) == set(c["jbp"]) == set(DATES)
    for date in DATES:
        key = [(e.origin_time, e.aux_data["source_index"])
               for e in c["jbp"][date]]
        assert key == [(e.origin_time, e.aux_data["source_index"])
                       for e in c["tbp"][date]]
        assert len(key) >= 2, date   # both injected events


def test_bank_matches_jax(chains):
    jtg, ttg = chains["jtg"], chains["ttg"]
    assert ttg.n_templates == jtg.n_templates >= 1
    assert [str(t) for t in ttg.tids] == [str(t) for t in jtg.tids]
    np.testing.assert_array_equal(ttg.moveouts_arr, jtg.moveouts_arr)
    np.testing.assert_array_equal(ttg.waveforms_arr, jtg.waveforms_arr)


def test_mf_campaign_and_catalog_match_jax(chains):
    c = chains
    assert set(c["tmf"]) == set(c["jmf"]) == set(DATES)
    for date in DATES:
        jd, td = c["jmf"][date], c["tmf"][date]
        assert {str(k) for k in td} == {str(k) for k in jd}
        for tid in jd:
            assert [e.origin_time for e in td[tid]] == [
                e.origin_time for e in jd[tid]], (date, tid)
            np.testing.assert_allclose(
                [e.aux_data["cc"] for e in td[tid]],
                [e.aux_data["cc"] for e in jd[tid]], rtol=0, atol=1e-5)
    cat, n_events, n_uniq = c["tcat"]
    jcat = c["jcat"]
    assert n_events == len(jcat) and n_uniq == int(
        jcat["unique_event"].sum()) >= 2

    def rows(ot, tid, uniq):
        return sorted(zip([str(t) for t in ot], [str(t) for t in tid],
                          [bool(u) for u in uniq]))

    assert rows(cat["origin_time"], cat["tid"], cat["unique_event"]) == \
        rows(jcat["origin_time"].values.astype("datetime64[ns]"),
             jcat["tid"].values, jcat["unique_event"].values)


def test_resume_runs_no_done_day(chains, worlds):
    c, tw = chains, worlds["world"]
    made = []
    tw_calls = tmw.MonthWorld(**{**tw.__dict__, "make_data": lambda d: (
        made.append(d), tw.make_data(d))[1]})
    assert tmw.bp_campaign(tw_calls, DATES, c["tfeat"], c["states"][0],
                           device="cpu") == {}
    assert tmw.mf_campaign(tw_calls, DATES, c["ttg"], c["states"][1],
                           device="cpu") == {}
    assert made == []
    more = tmw.dates_of(3)
    out = tmw.bp_campaign(tw_calls, more, c["tfeat"], c["states"][0],
                          device="cpu")
    assert set(out) == {more[2]} and made == [more[2]]
