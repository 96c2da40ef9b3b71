"""The 1024-template year campaign (BASELINE config 4) through the port
against the JAX package's `scripts/year_scan.py`, on the CPU, at a cut.

- `tools/year_world.py` is the script's world: at a 600 s day its arrays
  equal, bit for bit, the script's HDF5 day read back through the JAX
  package's `data_reader_hdf5`; the bank's arrays equal the script's; the
  churn drops the same stations and rolls by the same shift.
- A bank of 10 tid-distinct copies on a 3,600 s day, cut into plans of 4
  templates and extraction chunks of 3 (a cut that is not a multiple of
  the plan's), through the JAX `MatchedFilter` and the port's on the CPU
  with one seeded 500-sample zero-fill: the same template ids and sample
  indices, every CC within 1e-4.
- `scan_days` with a state file resumes at the first unfinished day.  The
  JAX campaign draws its zero-fill from numpy's global state and the port
  from an explicit generator (ROADMAP's deliberate differences), so the
  two campaigns' detection counts are compared, not their values.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from seismic_bpmf_tpu import workflow as jwf  # noqa: E402
from seismic_bpmf_tpu.detection.matched_filter import (  # noqa: E402
    MatchedFilter as JaxMatchedFilter,
)

from seismic_bpmf_tpu_torch.detection import MatchedFilter  # noqa: E402
from seismic_bpmf_tpu_torch.tools import year_scan  # noqa: E402
from seismic_bpmf_tpu_torch.tools.year_world import (  # noqa: E402
    T0_EPOCH, build_bank, build_world, churn_pattern, churn_wrapper,
)

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "year_scan.py")
SCAN_KW = dict(min_channels=3, min_stations=2, max_kurto=1e6)


def _script():
    spec = importlib.util.spec_from_file_location("year_scan_script", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _script_world(tmp, day_sec):
    script = _script()
    cfg, net, make_data, event_times, mv_p = script.build_world(
        str(tmp), day_sec=day_sec)
    return script, cfg, net, make_data, event_times, mv_p


@pytest.fixture(scope="module")
def short(tmp_path_factory):
    """The script's world and the port's at a 600 s day."""
    tmp = tmp_path_factory.mktemp("year600")
    return _script_world(tmp, 600.0), build_world(day_sec=600.0)


def test_year_world_is_the_scripts(short):
    (script, cfg, net, make_data, event_times, mv_p), world = short
    assert list(world.network.stations) == list(net.stations)
    for attr in ("latitude", "longitude"):
        np.testing.assert_array_equal(getattr(world.network, attr),
                                      getattr(net, attr))
    assert world.event_times == event_times and world.mv_p == mv_p
    assert world.cfg.template_len_sec == cfg.template_len_sec
    assert world.cfg.n_dev_mf_threshold == cfg.n_dev_mf_threshold
    jdata = make_data("day000")
    want = jdata.get_np_array(list(net.stations))
    got = world.make_data("day000").get_np_array(list(net.stations))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(world.day, want[..., :world.n_samples])
    assert got.dtype == want.dtype == np.float32


def test_bank_is_the_scripts(short):
    (script, cfg, net, make_data, event_times, mv_p), world = short
    jtg = script.build_bank(cfg, net, make_data, event_times, mv_p, 5)
    tg = build_bank(world, 5)
    assert [str(t) for t in tg.tids] == [str(t) for t in jtg.tids]
    np.testing.assert_array_equal(tg.waveforms_arr, jtg.waveforms_arr)
    np.testing.assert_array_equal(tg.moveouts_arr, jtg.moveouts_arr)
    for tp, jtp in zip(tg.templates, jtg.templates):
        assert tp.origin_time == jtp.origin_time
        np.testing.assert_array_equal(tp.moveouts_table(),
                                      jtp.moveouts.values)


@pytest.mark.parametrize("date", ["day000", "day001", "day004", "day013"])
def test_churn_is_the_scripts(short, date):
    (script, cfg, net, make_data, event_times, mv_p), world = short
    n_patterns = 5
    jday = script.churn_wrapper(make_data, net, n_patterns)(date)
    day = churn_wrapper(world.make_data, world.network, n_patterns)(date)
    stations = list(net.stations)
    np.testing.assert_array_equal(day.get_np_array(stations),
                                  jday.get_np_array(stations))
    np.testing.assert_array_equal(day.availability_per_sta,
                                  jday.availability.values)
    drop, shift = churn_pattern(date, len(stations), n_patterns)
    assert set(np.flatnonzero(~day.availability_per_sta)) == set(drop)
    assert not day.get_np_array(stations)[drop].any()
    # each trace of a day holds one sample past its end (a zero)
    keep = np.setdiff1d(np.arange(len(stations)), drop)
    whole = np.concatenate([world.day, np.zeros((10, 3, 1), np.float32)], -1)
    np.testing.assert_array_equal(
        day.get_np_array(stations)[keep],
        np.roll(whole[keep], shift, axis=-1)[..., :world.n_samples])


@pytest.fixture(scope="module")
def hour(tmp_path_factory):
    """The script's world at a 3,600 s day and a bank of 10 copies, in
    both packages."""
    tmp = tmp_path_factory.mktemp("year3600")
    script, cfg, net, make_data, event_times, mv_p = _script_world(
        tmp, 3600.0)
    world = build_world(day_sec=3600.0)
    return dict(
        cfg=cfg, make_data=make_data, world=world,
        jtg=script.build_bank(cfg, net, make_data, event_times, mv_p, 10),
        tg=build_bank(world, 10),
        white_noise=np.random.default_rng(7).normal(size=500).astype(
            np.float32))


def _scan(engine, data, white_noise):
    engine.set_data(data)
    engine.set_weights_channels(method="simple", normalize=True)
    return engine.run_matched_filter_search(
        5.0, threshold_window_dur=1800.0, white_noise=white_noise,
        verbose=-1)


@pytest.mark.parametrize("n_chunk, plans", [(3, [3, 3, 3, 1]),
                                             (6, [4, 2, 4])])
def test_bank_scan_across_plan_and_extraction_cuts_matches_jax(
        hour, n_chunk, plans):
    """Plans of at most 4 templates inside extraction chunks of 3 (cuts at
    3, 6 and 9) or of 6 (cuts at 6, and plan cuts at 4 and 10): the two
    cuts interleave, as the 1024 bank's plans of 256 and chunks of ~614 do
    on the card."""
    h = hour
    data = h["world"].make_data("day000")
    row_gb = 4 * h["world"].n_samples / 1024.0**3
    kw = dict(template_chunk=4, max_memory_gb=(n_chunk + 0.5) * row_gb,
              precision="screen", **SCAN_KW)
    tmf = MatchedFilter(h["tg"], cfg=h["world"].cfg, device="cpu", **kw)
    td = _scan(tmf, data, h["white_noise"])
    assert tmf._extraction_chunk(10) == n_chunk
    assert [p.n_tp for ps in tmf._plans.values() for p in ps] == plans
    jmf = JaxMatchedFilter(h["jtg"], cfg=h["cfg"], engine="pallas", **kw)
    jd = _scan(jmf, h["make_data"]("day000"), h["white_noise"])
    assert sorted(map(str, td)) == sorted(map(str, jd)) == [
        str(t) for t in sorted(range(10), key=str)]
    sr = h["world"].cfg.sampling_rate_hz
    n_total = 0
    for tid in jd:
        want = [(round((e.origin_time_epoch - T0_EPOCH) * sr),
                 e.aux_data["cc"]) for e in jd[tid]]
        got = [(round((e.origin_time_epoch - T0_EPOCH) * sr),
                e.aux_data["cc"]) for e in td[tid]]
        assert [i for i, _ in got] == [i for i, _ in want], tid
        np.testing.assert_allclose([c for _, c in got],
                                   [c for _, c in want], atol=1e-4)
        n_total += len(got)
        # both injected events, through every copy of either template
        for ev_t in h["world"].event_times:
            assert min(abs(i - ev_t * sr) for i, _ in got) <= 1
    assert n_total >= 20


def test_scan_days_resumes_at_the_first_unfinished_day(short, tmp_path):
    (script, cfg, net, make_data, event_times, mv_p), world = short
    dates = year_scan.dates_of(3)
    state = str(tmp_path / "state.json")
    tg = build_bank(world, 2)
    first = year_scan.campaign(world, tg, dates[:2], state_file=state,
                               device="cpu")
    # the second campaign over the same state file reads only day 2
    seen = []
    world_days = world.make_data
    world.make_data = lambda d: seen.append(d) or world_days(d)
    try:
        rest = year_scan.campaign(world, tg, dates, state_file=state,
                                  device="cpu")
    finally:
        world.make_data = world_days
    assert list(first) == dates[:2] and list(rest) == dates[2:]
    assert seen == dates[2:]
    with open(state) as f:
        done = json.load(f)
    assert list(done) == dates
    jstate = str(tmp_path / "jax_state.json")
    jtg = script.build_bank(cfg, net, make_data, event_times, mv_p, 2)
    jres = jwf.scan_days(dates, make_data, jtg, cfg=cfg, state_file=jstate,
                         minimum_interevent_time=5.0,
                         threshold_window_dur=1800.0, precision="screen",
                         engine="pallas", **SCAN_KW)
    with open(jstate) as f:
        assert json.load(f) == done
    for d in dates:
        assert done[d]["n_detections"] == 4   # 2 templates x 2 events
        assert sum(len(v) for v in jres[d].values()) == 4
