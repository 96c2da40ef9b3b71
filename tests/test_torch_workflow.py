"""The PyTorch port's matched-filter day scan, and the whole staged
pipeline at the `high` rung, against the JAX package.

The synthetic world of tests/test_workflow.py (the code that makes it is
copied here): a template bank is made with the JAX package, carried across with
`TemplateGroup.from_arrays`, and both packages' `MatchedFilter`s scan the
same day on the CPU.  Detections must be identical (template ids and
sample indexes) with CC within 1e-5; the campaign state files must match.
The pipeline test walks backproject_day -> build_templates ->
matched_filter_day(precision="high") -> assemble_catalog in both packages.
"""

import json

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from seismic_bpmf_tpu import workflow as jwf  # noqa: E402
from seismic_bpmf_tpu.config import Config  # noqa: E402
from seismic_bpmf_tpu.data import (  # noqa: E402
    Data, Event, Network, Template, TemplateGroup, TravelTimes,
    data_reader_hdf5, write_hdf5_continuous,
)
from seismic_bpmf_tpu.data.stream import Stream, Trace  # noqa: E402
from seismic_bpmf_tpu.detection.matched_filter import (  # noqa: E402
    MatchedFilter as JaxMatchedFilter,
)

import seismic_bpmf_tpu_torch.config as tconfig  # noqa: E402
import seismic_bpmf_tpu_torch.data as tdata  # noqa: E402
from seismic_bpmf_tpu_torch import workflow as twf  # noqa: E402
from seismic_bpmf_tpu_torch.detection import MatchedFilter  # noqa: E402

SR = 25.0
DAY = 900.0
N_STA = 5
N_SRC = 9
EVENT_TIMES = [200.0, 600.0]
EVENT_SRC = 3
T0 = 1343260800.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_wf")
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
    TravelTimes.write_table(
        str(tmp / "tts.h5"), {"P": tt_p, "S": tt_s},
        {"longitude": np.linspace(30, 30.2, N_SRC),
         "latitude": np.linspace(40, 40.2, N_SRC),
         "depth": np.full(N_SRC, 8.0)},
    )
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

    # the bank, made with the JAX package: the injected event's source and
    # two more sources cut at quiet times
    templates = []
    for i, (ot, src) in enumerate([(EVENT_TIMES[0], EVENT_SRC),
                                   (400.0, 0), (750.0, 6)]):
        mv = np.stack([[tt_p[f"S{s}"][src], tt_s[f"S{s}"][src]]
                       for s in range(N_STA)]).astype(np.float64)
        ev = Event(T0 + ot, mv, net.stations, ["P", "S"], "day.h5",
                   str(tmp), sampling_rate=SR, latitude=40.1,
                   longitude=30.1, depth=8.0)
        ev.read_waveforms(cfg.template_len_sec, data_reader=data_reader_hdf5)
        tp = Template.init_from_event(ev)
        tp.set_aux_data({"tid": i})
        tp.id = str(i)
        templates.append(tp)
    tg = TemplateGroup(templates, net)
    tdat = tdata.Data("2012-07-26", path, tdata.data_reader_hdf5,
                      duration=DAY, sampling_rate=SR).read_waveforms()
    tts = TravelTimes("tts.h5", str(tmp)).read(
        ["P", "S"], read_coords=True).convert_to_samples(SR)
    tnet = tdata.Network.from_arrays(
        md["stations"], networks=md["networks"], latitude=md["latitude"],
        longitude=md["longitude"], elevation_m=md["elevation_m"])
    ttts = tdata.TravelTimes("tts.h5", str(tmp)).read(
        ["P", "S"], read_coords=True).convert_to_samples(SR)
    return dict(cfg=cfg, net=net, data=data, tg=tg, tdata=tdat, tmp=tmp,
                tts=tts, tnet=tnet, ttts=ttts,
                white_noise=rng.normal(size=500).astype(np.float32))


def carry_bank(tg):
    """The JAX group's arrays -> the port's TemplateGroup."""
    return tdata.TemplateGroup.from_arrays(
        tg.waveforms_arr, tg.moveouts_arr, tg.tids,
        stations=tg.stations, components=tg.components,
        sampling_rate=tg.templates[0].sr,
        phases=tg.templates[0].phases,
        moveouts_sec=np.stack([tp.moveouts.loc[tg.stations].values
                               for tp in tg.templates]),
        locations=np.array([[tp.longitude, tp.latitude, tp.depth]
                            for tp in tg.templates]),
        origin_times=[tp.origin_time for tp in tg.templates],
    )


def _as_cfg(cfg):
    return tconfig.Config(**{k: getattr(cfg, k) for k in (
        "data_buffer_sec", "sampling_rate_hz", "template_len_sec",
        "n_dev_bp_threshold", "n_dev_mf_threshold")})


def _summary(dets):
    return {str(tid): [(e.origin_time, e.aux_data["cc"]) for e in evs]
            for tid, evs in dets.items()}


@pytest.mark.parametrize("precision", ["highest", "high", "screen"])
def test_matched_filter_matches_jax(world, precision):
    w = world
    kw = dict(min_channels=3, min_stations=2, max_kurto=1e6,
              precision=precision)
    jmf = JaxMatchedFilter(w["tg"], cfg=w["cfg"], engine="pallas", **kw)
    jmf.set_data(w["data"])
    jmf.set_weights_channels(method="simple", normalize=True)
    jd = jmf.run_matched_filter_search(
        5.0, threshold_window_dur=150.0, white_noise=w["white_noise"],
        verbose=-1)

    ttg = carry_bank(w["tg"])
    tmf = MatchedFilter(ttg, cfg=_as_cfg(w["cfg"]), device="cpu", **kw)
    tmf.set_data(w["tdata"])
    tmf.set_weights_channels(method="simple", normalize=True)
    td = tmf.run_matched_filter_search(
        5.0, threshold_window_dur=150.0, white_noise=w["white_noise"],
        verbose=-1)

    js, ts = _summary(jd), _summary(td)
    assert set(js) == set(ts)
    n_total = 0
    for tid in js:
        assert [t for t, _ in js[tid]] == [t for t, _ in ts[tid]]
        np.testing.assert_allclose([c for _, c in ts[tid]],
                                   [c for _, c in js[tid]], atol=1e-5)
        n_total += len(js[tid])
    # both injected occurrences, through the event's own template
    assert len(js["0"]) >= 2 and n_total >= 2
    t_det = [e.origin_time_epoch - T0 for e in td["0"]]
    for ev_t in EVENT_TIMES:
        assert min(abs(t - ev_t) for t in t_det) < 0.5
    assert all(e.latitude == 40.1 for e in td["0"])


def test_scan_days_state_matches_jax(world, tmp_path):
    w = world
    kw = dict(minimum_interevent_time=5.0, threshold_window_dur=150.0,
              min_channels=3, min_stations=2, max_kurto=1e6)
    js, ts = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    rj = jwf.scan_days(["d1", "d2"], lambda d: w["data"], w["tg"],
                       cfg=w["cfg"], state_file=js, engine="pallas", **kw)
    days = []
    rt = twf.scan_days(["d1", "d2"], lambda d: days.append(d) or w["tdata"],
                       carry_bank(w["tg"]), cfg=_as_cfg(w["cfg"]),
                       state_file=ts, db_path=str(tmp_path / "db"),
                       device="cpu", **kw)
    with open(js) as f1, open(ts) as f2:
        assert json.load(f1) == json.load(f2)
    assert set(rj) == set(rt) == {"d1", "d2"}
    for day in rj:
        assert {t: len(v) for t, v in rj[day].items()} == {
            str(t): len(v) for t, v in rt[day].items()}
    # resume: nothing re-run
    again = twf.scan_days(["d1", "d2"], lambda d: days.append(d),
                          carry_bank(w["tg"]), cfg=_as_cfg(w["cfg"]),
                          state_file=ts, device="cpu", **kw)
    assert again == {} and days == ["d1", "d2"]
    # the detections were written per template
    assert (tmp_path / "db" / "detections_tp0.h5").is_file()
    with pytest.raises(ValueError, match="stage='bp' requires"):
        twf.scan_days(["d1"], lambda d: w["tdata"], stage="bp")


def test_full_workflow_at_high_matches_jax(world):
    """The slice as a whole: BP detections -> templates -> `high` MF scan
    -> catalog, through both packages on the same day.  The same kept
    templates, identical {tid: [sample index]}, CC within 5e-6 (both sides
    sum the same three bf16 products in f32, in different orders), the same
    `unique_event` flags."""
    w = world
    bp_kw = dict(minimum_interevent_time=10.0, threshold_window_sec=150.0,
                 num_closest_stations=N_STA)
    _, jdets = jwf.backproject_day(w["data"], w["net"], w["tts"],
                                   cfg=w["cfg"], **bp_kw)
    _, tdets = twf.backproject_day(w["tdata"], w["tnet"], w["ttts"],
                                   cfg=_as_cfg(w["cfg"]), device="cpu",
                                   **bp_kw)
    assert len(jdets) >= 2
    assert [e.origin_time for e in tdets] == [e.origin_time for e in jdets]

    jtg = jwf.build_templates(jdets, w["net"], cfg=w["cfg"],
                              data_reader=data_reader_hdf5,
                              dedup_similarity=0.95)
    ttg = twf.build_templates(tdets, w["tnet"], cfg=_as_cfg(w["cfg"]),
                              data_reader=tdata.data_reader_hdf5,
                              dedup_similarity=0.95, device="cpu")
    assert ttg.n_templates == jtg.n_templates >= 1
    assert [str(t) for t in ttg.tids] == [str(t) for t in jtg.tids]
    np.testing.assert_array_equal(ttg.moveouts_arr, jtg.moveouts_arr)
    np.testing.assert_array_equal(ttg.waveforms_arr, jtg.waveforms_arr)

    mf_kw = dict(minimum_interevent_time=5.0, threshold_window_dur=150.0,
                 min_channels=3, min_stations=2, max_kurto=1e6,
                 precision="high")
    np.random.seed(5)  # the JAX engine draws its zero-fill from numpy's
    jd = jwf.matched_filter_day(jtg, w["data"], cfg=w["cfg"],
                                engine="pallas", **mf_kw)
    td = twf.matched_filter_day(ttg, w["tdata"], cfg=_as_cfg(w["cfg"]),
                                device="cpu",
                                rng=np.random.default_rng(5), **mf_kw)
    js, ts = _summary(jd), _summary(td)
    assert set(js) == set(ts)
    for tid in js:
        assert [t for t, _ in js[tid]] == [t for t, _ in ts[tid]]
        np.testing.assert_allclose([c for _, c in ts[tid]],
                                   [c for _, c in js[tid]], rtol=0, atol=5e-6)
    n_total = sum(len(v) for v in js.values())
    assert n_total >= 2  # both injected occurrences found

    jcat = jwf.assemble_catalog(jd, jtg).catalog
    tcat = twf.assemble_catalog(td, ttg, device="cpu")
    assert tcat.n_events == len(jcat) == n_total
    # equal origin times may come in either order: compare as sorted rows
    def rows(ot, tid, uniq):
        return sorted(zip([str(t) for t in ot], [str(t) for t in tid],
                          [bool(u) for u in uniq]))
    assert rows(tcat["origin_time"], tcat["tid"], tcat["unique_event"]) == \
        rows(jcat["origin_time"].values.astype("datetime64[ns]"),
             jcat["tid"].values, jcat["unique_event"].values)
    assert int(np.sum(tcat["unique_event"])) >= 2


def test_backproject_day_with_phasenet_features_matches_jax(world):
    """PhaseNet features into `backproject_day`, one set of carried weights
    in both packages: the (n_sta, 2, n) P/S features within 1e-5 (both
    routes: the whole day on the device, and the host-normalized picker),
    and identical detections (times and sources) when both packages
    beamform the same feature array."""
    from seismic_bpmf_tpu.models import phasenet as jpn
    from seismic_bpmf_tpu_torch.models import phasenet as tpn

    w = world
    jmodel, variables = jpn.init_phasenet(jax.random.PRNGKey(2))
    tmodel = tpn.PhaseNet()
    tmodel.load_state_dict(tpn.from_flax_variables(
        jax.tree.map(np.asarray, variables)))
    arr = w["tdata"].get_np_array(w["tnet"].stations)
    jfeat = np.array(jwf.phasenet_feature_fn(jmodel, variables)(
        w["data"].get_np_array(w["net"].stations)))
    tfeat = twf.phasenet_feature_fn(tmodel)(arr)
    assert isinstance(tfeat, torch.Tensor)
    assert tfeat.shape == jfeat.shape == (N_STA, 2, int(DAY * SR))
    np.testing.assert_allclose(tfeat.numpy(), jfeat, rtol=0, atol=1e-5)
    host = twf.phasenet_feature_fn(tmodel, whole_day=False)(arr)
    np.testing.assert_allclose(host, jfeat, rtol=0, atol=1e-5)

    bp_kw = dict(minimum_interevent_time=10.0, threshold_window_sec=150.0,
                 num_closest_stations=N_STA)
    _, jdets = jwf.backproject_day(w["data"], w["net"], w["tts"],
                                   cfg=w["cfg"], feature_fn=lambda a: jfeat,
                                   **bp_kw)
    _, tdets = twf.backproject_day(w["tdata"], w["tnet"], w["ttts"],
                                   cfg=_as_cfg(w["cfg"]), device="cpu",
                                   feature_fn=lambda a: jfeat, **bp_kw)
    assert len(jdets) >= 1
    assert [(e.origin_time, e.aux_data["source_index"]) for e in tdets] == [
        (e.origin_time, e.aux_data["source_index"]) for e in jdets]
    # the port's own features, end to end on the CPU
    _, own = twf.backproject_day(w["tdata"], w["tnet"], w["ttts"],
                                 cfg=_as_cfg(w["cfg"]), device="cpu",
                                 feature_fn=twf.phasenet_feature_fn(tmodel),
                                 **bp_kw)
    assert all(np.isfinite(e.aux_data["maxbeam"]) for e in own)
