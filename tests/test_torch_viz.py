"""The port's plots against the JAX package's, on the CPU (matplotlib Agg).

Every function of `viz` and every plot method of the data, detection and
source classes, on both packages' objects built from the same arrays:
repeats of one event on 4 stations x 3 components (25 Hz, a 1,200 s day in
one HDF5 file that both packages' readers read), their Events, Templates,
TemplateGroups and detection files, a catalog, a spectrum, and the
engines' series (max beam, CC) set from the same arrays.  Each pair of
figures has the same axes, the same labels and titles, and every line's,
scatter's and bar's data within 1e-6 relative.
"""

import os

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
matplotlib = pytest.importorskip("matplotlib")

import seismic_bpmf_tpu.data as jdata  # noqa: E402
import seismic_bpmf_tpu.viz as jviz  # noqa: E402
from seismic_bpmf_tpu.detection import (  # noqa: E402
    Beamformer as JBeamformer, MatchedFilter as JMatchedFilter,
)
from seismic_bpmf_tpu.source import Spectrum as JSpectrum  # noqa: E402

import seismic_bpmf_tpu_torch.data as tdata  # noqa: E402
import seismic_bpmf_tpu_torch.viz as tviz  # noqa: E402
from seismic_bpmf_tpu_torch.detection import (  # noqa: E402
    Beamformer, MatchedFilter,
)
from seismic_bpmf_tpu_torch.ops.picks import PickTable  # noqa: E402
from seismic_bpmf_tpu_torch.source import Spectrum  # noqa: E402
from seismic_bpmf_tpu_torch.source.spectrum import SpectrumTable  # noqa: E402

import matplotlib.pyplot as plt  # noqa: E402

SR = 25.0
DAY = 1200.0
T0 = 1343260800.0
STATIONS = ["S0", "S1", "S2", "S3"]
EVENT_TIMES = [100.0, 400.0, 700.0, 1000.0]
TT_P = np.array([2.0, 2.8, 3.6, 4.4])
RTOL = 1e-6


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("viz")
    rng = np.random.default_rng(5)
    n = int(DAY * SR)
    n_w = int(2.0 * SR)
    wavelet = (np.sin(2 * np.pi * 4.0 * np.arange(n_w) / SR)
               * np.hanning(n_w))
    st = tdata.Stream()
    for s, sta in enumerate(STATIONS):
        for comp in "NEZ":
            x = 0.1 * rng.normal(size=n)
            for e, ev_t in enumerate(EVENT_TIMES):
                k = int(round((ev_t + TT_P[s] * (1.0 if comp == "Z"
                                                 else 1.7)) * SR))
                x[k:k + n_w] += (2.0 + 0.2 * e) * wavelet
            st += tdata.Trace(x.astype(np.float32), station=sta,
                              network="XX", channel=f"HH{comp}",
                              sampling_rate=SR, starttime=T0)
    tdata.write_hdf5_continuous(str(tmp / "day.h5"), st)
    md = pd.DataFrame({"stations": STATIONS, "networks": ["XX"] * 4,
                       "latitude": 40.0 + 0.05 * np.arange(4),
                       "longitude": 30.0 + 0.05 * np.arange(4),
                       "elevation_m": np.zeros(4)})
    mv = np.stack([TT_P, 1.7 * TT_P], axis=1).astype(np.float32)
    picks = {"P_picks": np.float32([50.0, 70.0, np.nan, 110.0]),
             "S_picks": np.float32([85.0, np.nan, 153.0, 187.0])}
    out = {"tmp": tmp, "cc": rng.uniform(0.05, 0.9, n).astype(np.float32),
           "beam": rng.uniform(1.0, 3.0, n).astype(np.float32),
           "thr": rng.uniform(2.5, 3.0, n).astype(np.float32),
           "src_beam": rng.uniform(0.0, 5.0, 9).astype(np.float32)}
    for key, pkg in (("t", tdata), ("j", jdata)):
        evs = [pkg.Event(
            np.datetime64(int((T0 + ev_t) * 1e9), "ns"), mv, STATIONS,
            ["P", "S"], data_filename="day.h5", data_path=str(tmp),
            latitude=40.05 + 0.01 * e, longitude=30.05 + 0.02 * e,
            depth=5.0 + e, sampling_rate=SR,
            data_reader=pkg.data_reader_hdf5,
        ) for e, ev_t in enumerate(EVENT_TIMES)]
        for ev in evs:
            ev.read_waveforms(10.0, offset_phase={"P": 1.0, "S": 2.0})
            ev.set_aux_data({"hmax_unc": 2.0, "hmin_unc": 1.0,
                             "vmax_unc": 3.0, "az_hmax_unc": 30.0})
        if key == "t":
            evs[0].picks_table = PickTable(STATIONS, picks)
        else:
            evs[0].picks = pd.DataFrame(picks, index=pd.Index(
                STATIONS, name="stations"))
        tps = []
        for i, ev in enumerate(evs[:2]):
            tp = pkg.Template.init_from_event(ev)
            tp.set_aux_data({"tid": i})
            tp.id = str(i)
            tps.append(tp)
        db = str(tmp / f"db_{key}")
        os.makedirs(db, exist_ok=True)
        for tp, members in ((tps[0], evs[1:]), (tps[1], evs[2:])):
            dets = [pkg.Event(ev.origin_time, mv, STATIONS, ["P", "S"],
                              data_filename="day.h5", data_path=str(tmp),
                              latitude=ev.latitude, longitude=ev.longitude,
                              depth=ev.depth, sampling_rate=SR,
                              data_reader=pkg.data_reader_hdf5)
                    for ev in members]
            for j, ev in enumerate(dets):
                ev.id = f"{tp.tid}_{j}"
                ev.set_aux_data({"cc": 0.5 + 0.1 * j, "n_dev": 9.0 + j,
                                 "tid": tp.tid})
            tp.write_detections(dets, db_path=db)
        net = pkg.Network.from_dataframe(md)
        data = pkg.Data("2012-07-26", str(tmp / "day.h5"),
                        pkg.data_reader_hdf5, duration=DAY,
                        sampling_rate=SR)
        out[key] = dict(evs=evs, tps=tps, db=db, net=net, data=data,
                        group=pkg.TemplateGroup(tps, net),
                        reader=pkg.data_reader_hdf5)
    return out


def _artists(ax):
    lines = [(ln.get_label(), np.asarray(ln.get_xydata(), np.float64))
             for ln in ax.get_lines()]
    scatters = [np.asarray(c.get_offsets(), np.float64)
                for c in ax.collections if hasattr(c, "get_offsets")]
    bars = [p.get_height() for p in ax.patches if hasattr(p, "get_height")]
    labels = (ax.get_xlabel(), ax.get_ylabel(), ax.get_title(),
              [t.get_text() for t in ax.texts],
              [t.get_text() for t in ax.get_xticklabels()]
              if not ax.xaxis.get_major_formatter().__class__.__name__
              .startswith("Auto") else None)
    return lines, scatters, bars, labels


def _same_figure(got, want):
    got = getattr(got, "figure", got)
    want = getattr(want, "figure", want)
    assert len(got.axes) == len(want.axes)
    assert ((got._suptitle.get_text() if got._suptitle else None)
            == (want._suptitle.get_text() if want._suptitle else None))
    n_items = 0
    for ax, jax_ in zip(got.axes, want.axes):
        (lines, scat, bars, labels) = _artists(ax)
        (jlines, jscat, jbars, jlabels) = _artists(jax_)
        assert labels == jlabels
        assert [k for k, _ in lines] == [k for k, _ in jlines]
        for (_, a), (_, b) in zip(lines, jlines):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)
        assert len(scat) == len(jscat)
        for a, b in zip(scat, jscat):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)
        np.testing.assert_allclose(bars, jbars, rtol=RTOL, atol=0)
        n_items += len(lines) + len(scat) + len(bars)
    plt.close("all")
    return n_items


def _catalogs(world):
    rng = np.random.default_rng(9)
    n = 40
    lon, lat = 30.0 + rng.random(n), 40.0 + rng.random(n)
    dep = rng.uniform(2.0, 15.0, n)
    ot = (np.datetime64("2012-07-20", "ns")
          + rng.integers(0, 20 * 86400, n).astype("timedelta64[s]"))
    tid = rng.integers(0, 3, n)
    return (tdata.Catalog(lon, lat, dep, ot, tid=tid),
            jdata.Catalog(lon, lat, dep, ot, tid=tid))


def _viz_calls(world):
    t, j = world["t"], world["j"]
    cat, jcat = _catalogs(world)
    arr = np.stack([ev.waveforms_arr[0, 2] for ev in t["evs"]])
    bf, jbf, _, _ = _engines(world)
    stations = {"longitude": np.array([30.0, 30.1]),
                "latitude": np.array([40.0, 40.1]), "stations": ["A", "B"]}

    def scale_bar(viz, _):
        ax = viz.initialize_map((29.5, 31.0), (39.5, 41.0))
        return viz.add_scale_bar(ax, length_km=20.0)

    def detection(viz, side):
        ev = side["evs"][1]
        ev._context_time = 400.0
        return viz.plot_detection(ev, context=world["cc"], context_sr=SR,
                                  context_label="cc")

    return {
        "initialize_map": lambda viz, s: viz.initialize_map(
            (29.5, 31.0), (39.5, 41.0), seismic_stations=stations),
        "add_scale_bar": scale_bar,
        "plot_template": lambda viz, s: viz.plot_template(s["tps"][0]),
        "plot_detection_matrix": lambda viz, s: viz.plot_detection_matrix(
            arr, STATIONS, SR),
        "plot_catalog": lambda viz, s: viz.plot_catalog(
            cat if viz is tviz else jcat, network=s["net"]),
        "plot_recurrence_times": lambda viz, s: viz.plot_recurrence_times(
            cat if viz is tviz else jcat, tid=1),
        "plot_time_of_day": lambda viz, s: viz.plot_time_of_day(
            cat if viz is tviz else jcat),
        "plot_time_statistics": lambda viz, s: viz.plot_time_statistics(
            cat if viz is tviz else jcat, UTC_local_corr=-7),
        "plot_space_time": lambda viz, s: viz.plot_space_time(
            cat if viz is tviz else jcat, axis="latitude"),
        "plot_detection": detection,
        "plot_event": lambda viz, s: viz.plot_event(s["evs"][0]),
        "plot_maxbeam": lambda viz, s: viz.plot_maxbeam(
            bf if viz is tviz else jbf, detection_indices=[7, 900]),
        "uncertainty_ellipse": lambda viz, s: viz.uncertainty_ellipse(
            s["evs"][2]),
        "vertical_uncertainty_ellipse":
            lambda viz, s: viz.vertical_uncertainty_ellipse(s["evs"][2]),
    }


VIZ_FUNCS = [
    "initialize_map", "add_scale_bar", "plot_template",
    "plot_detection_matrix", "plot_catalog", "plot_recurrence_times",
    "plot_time_of_day", "plot_time_statistics", "plot_space_time",
    "plot_detection", "plot_event", "plot_maxbeam", "uncertainty_ellipse",
    "vertical_uncertainty_ellipse",
]


@pytest.mark.parametrize("name", VIZ_FUNCS)
def test_viz_functions_match_jax(world, name):
    call = _viz_calls(world)[name]
    assert _same_figure(call(tviz, world["t"]), call(jviz, world["j"])) >= 1


def test_every_viz_function_is_ported():
    assert sorted(tviz.__all__) == sorted(jviz.__all__)
    assert sorted(VIZ_FUNCS + ["load_topography"]) == sorted(jviz.__all__)
    # the one without an object: both need netCDF4
    try:
        import netCDF4  # noqa: F401
    except ImportError:
        for viz in (tviz, jviz):
            with pytest.raises(ImportError, match="netCDF4"):
                viz.load_topography("none.nc", (0, 1), (0, 1))


def _spectra():
    rng = np.random.default_rng(3)
    freqs = np.geomspace(0.5, 20.0, 25)
    vals = rng.uniform(0.1, 2.0, (3, 25))
    avg = vals.mean(0)
    spec, jspec = Spectrum(), JSpectrum()
    spec.spectra = {"p": SpectrumTable(vals, freqs, rows=STATIONS[:3])}
    jspec.spectra = {"p": pd.DataFrame(vals, index=STATIONS[:3],
                                       columns=freqs)}
    spec.average_spectrum = SpectrumTable(avg, freqs)
    jspec.average_spectrum = pd.Series(avg, index=freqs)
    for s in (spec, jspec):
        s.fit_success, s.model_name, s.M0, s.fc = True, "brune", 1.5, 4.0
    return spec, jspec


def _engines(world):
    t, j = world["t"], world["j"]
    src = {"longitude": np.linspace(30.0, 30.2, 9),
           "latitude": np.linspace(40.0, 40.2, 9),
           "depth": np.full(9, 8.0)}
    bf = Beamformer(data=t["data"], network=t["net"], device="cpu")
    jbf = JBeamformer(data=j["data"], network=j["net"])
    for b in (bf, jbf):
        b.set_source_coordinates(src)
        b.detection_threshold = world["thr"]
    bf.maxbeam = torch.from_numpy(world["beam"])
    jbf.maxbeam = world["beam"]
    mf = MatchedFilter(t["group"], device="cpu")
    jmf = JMatchedFilter(j["group"])
    for m, side in ((mf, t), (jmf, j)):
        m.data = side["data"]
        m.threshold_window_dur, m.overlap = 300.0, 0.5
    mf.cc = {"0": torch.from_numpy(world["cc"])}
    jmf.cc = {"0": world["cc"]}
    return bf, jbf, mf, jmf


def _method_calls(world):
    t, j = world["t"], world["j"]
    cat, jcat = _catalogs(world)
    spec, jspec = _spectra()
    bf, jbf, mf, jmf = _engines(world)

    def mf_detection(m, side):
        ev = side["evs"][1]
        ev.set_aux_data({"tid": "0"})
        return m.plot_detection(ev)

    pairs = {
        "Catalog.plot_map": (lambda c, s: c.plot_map(network=s["net"]),
                             cat, jcat),
        "Catalog.plot_time_statistics": (
            lambda c, s: c.plot_time_statistics(), cat, jcat),
        "Catalog.plot_time_of_day": (lambda c, s: c.plot_time_of_day(),
                                     cat, jcat),
        "Catalog.plot_space_time": (lambda c, s: c.plot_space_time(),
                                    cat, jcat),
        "Catalog.plot_recurrence_times": (
            lambda c, s: c.plot_recurrence_times(tid=2), cat, jcat),
        "Event.plot": (lambda e, s: e.plot(), t["evs"][0], j["evs"][0]),
        "Template.plot": (lambda tp, s: tp.plot(), t["tps"][1],
                          j["tps"][1]),
        "Template.plot_recurrence_times": (
            lambda tp, s: tp.plot_recurrence_times(db_path=s["db"]),
            t["tps"][0], j["tps"][0]),
        "Template.plot_detection": (
            lambda tp, s: tp.plot_detection(1, db_path=s["db"],
                                            duration=20.0,
                                            data_reader=s["reader"]),
            t["tps"][0], j["tps"][0]),
        "TemplateGroup.plot_detection": (
            lambda g, s: g.plot_detection(2, db_path=s["db"],
                                          duration=20.0,
                                          data_reader=s["reader"]),
            t["group"], j["group"]),
        "TemplateGroup.plot_recurrence_times": (
            lambda g, s: g.plot_recurrence_times(db_path=s["db"]),
            t["group"], j["group"]),
        "Network.plot_map": (lambda n, s: n.plot_map(), t["net"], j["net"]),
        "Spectrum.plot_spectrum": (lambda sp, s: sp.plot_spectrum("P"),
                                   spec, jspec),
        "Spectrum.plot_average_spectrum": (
            lambda sp, s: sp.plot_average_spectrum(), spec, jspec),
        "MatchedFilter.plot_cc": (
            lambda m, s: m.plot_cc("0", detection=s["evs"][1]), mf, jmf),
        "MatchedFilter.plot_detection": (mf_detection, mf, jmf),
        "Beamformer.plot_detection": (
            lambda b, s: b.plot_detection(s["evs"][2]), bf, jbf),
        "Beamformer.plot_maxbeam": (
            lambda b, s: b.plot_maxbeam(detection_indices=[100, 5000]),
            bf, jbf),
        "Beamformer.plot_likelihood": (
            lambda b, s: b.plot_likelihood(
                torch.from_numpy(world["src_beam"]) if b is bf
                else world["src_beam"]), bf, jbf),
    }
    return pairs


METHODS = [
    "Catalog.plot_map", "Catalog.plot_time_statistics",
    "Catalog.plot_time_of_day", "Catalog.plot_space_time",
    "Catalog.plot_recurrence_times", "Event.plot", "Template.plot",
    "Template.plot_recurrence_times", "Template.plot_detection",
    "TemplateGroup.plot_detection", "TemplateGroup.plot_recurrence_times",
    "Network.plot_map", "Spectrum.plot_spectrum",
    "Spectrum.plot_average_spectrum", "MatchedFilter.plot_cc",
    "MatchedFilter.plot_detection", "Beamformer.plot_detection",
    "Beamformer.plot_maxbeam", "Beamformer.plot_likelihood",
]


@pytest.mark.parametrize("name", METHODS)
def test_plot_methods_match_jax(world, name):
    call, obj, jobj = _method_calls(world)[name]
    assert _same_figure(call(obj, world["t"]), call(jobj, world["j"])) >= 1
