"""The port's magnitude path (`source/spectrum.py`,
`workflow.compute_magnitudes`) against the JAX package's.

Every `Spectrum` step runs in float64 in both packages and lies within
1e-10 (relative) of the JAX one.  The windows pass through the response
removal, float32 in both, and lie within 1e-5 of each window's maximum;
the magnitudes from them within 1e-4.  tests/test_response.py's
`_mw_world` (Brune pulses of a known moment behind a known response) is
built in both packages, and the magnitudes recovered from it pass that
file's gates.  A small `tools/magnitude_world.py` world (miniSEED days and
StationXML) drives both packages' reader mode and `compute_magnitudes`.
"""

import shutil

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from seismic_bpmf_tpu import source as jsrc  # noqa: E402
from seismic_bpmf_tpu import workflow as jwf  # noqa: E402
from seismic_bpmf_tpu.data import Network as JNetwork  # noqa: E402
from seismic_bpmf_tpu.data import stationxml as jsx  # noqa: E402
from seismic_bpmf_tpu.data.events import Event as JEvent  # noqa: E402
from seismic_bpmf_tpu.data.readers import (  # noqa: E402
    data_reader_mseed as jax_reader,
)
from seismic_bpmf_tpu.data.stream import (  # noqa: E402
    Stream as JStream, Trace as JTrace,
)
from seismic_bpmf_tpu.source import spectrum as jspec  # noqa: E402

from seismic_bpmf_tpu_torch import source as tsrc  # noqa: E402
from seismic_bpmf_tpu_torch import workflow as twf  # noqa: E402
from seismic_bpmf_tpu_torch.data import Event, Network  # noqa: E402
from seismic_bpmf_tpu_torch.data import Stream, Trace  # noqa: E402
from seismic_bpmf_tpu_torch.data import stationxml as tsx  # noqa: E402
from seismic_bpmf_tpu_torch.source import spectrum as tspec  # noqa: E402
from seismic_bpmf_tpu_torch.tools import magnitude_world  # noqa: E402

SR = 100.0
REL = 1e-10


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    # NaN and inf (integrating the 0 Hz bin) where the JAX one has them
    np.testing.assert_array_equal(got[~np.isfinite(want)],
                                  want[~np.isfinite(want)])
    ok = np.isfinite(want)
    scale = np.abs(want[ok]).max() if ok.any() else 1.0
    assert np.abs(got[ok] - want[ok]).max() <= rel * scale


def _same_table(table, frame):
    """A port SpectrumTable against the JAX DataFrame (or Series)."""
    if isinstance(frame, pd.Series):
        assert table.rows is None
        np.testing.assert_array_equal(table.frequencies, frame.index.values)
    else:
        assert list(table.rows) == list(frame.index)
        np.testing.assert_array_equal(table.frequencies,
                                      np.asarray(frame.columns))
    _close(table.values, frame.values)


@pytest.mark.parametrize("name", ["brune", "boatwright"])
def test_source_models_and_conversions(name):
    f = np.logspace(-1, 1.6, 40)
    for log in (False, True):
        np.testing.assert_array_equal(
            getattr(tsrc, name)(f, 3e-6, 4.2, log=log),
            getattr(jsrc, name)(f, 3e-6, 4.2, log=log))
    mw = np.array([0.5, 2.0, 3.7])
    np.testing.assert_array_equal(tsrc.magnitude_to_moment(mw),
                                  jsrc.magnitude_to_moment(mw))
    np.testing.assert_array_equal(tsrc.moment_to_magnitude(1e13),
                                  jsrc.moment_to_magnitude(1e13))
    for phase in ("p", "s"):
        assert tsrc.fc_circular_crack(mw, 3e6, phase).tolist() == \
            jsrc.fc_circular_crack(mw, 3e6, phase).tolist()
        assert tsrc.stress_drop_circular_crack(mw, 5.0, phase).tolist() == \
            jsrc.stress_drop_circular_crack(mw, 5.0, phase).tolist()


def _windows(seed=4, n_sta=5, n=400):
    rng = np.random.default_rng(seed)
    w = {}
    for ph, amp in (("noise", 1e-9), ("p", 2e-7), ("s", 6e-7)):
        x = rng.normal(size=(n_sta, 3, n)) * 1e-9
        x[:, :, 100:140] += amp * np.hanning(40) * rng.uniform(
            0.5, 2.0, (n_sta, 3, 1))
        w[ph] = x.astype(np.float32)
    return w


STATIONS = ["A1", "A2", "A3", "A4", "A5"]


def _run_steps(module, device_kw, method, stack, bands):
    """A `Spectrum` of seeded windows with its spectra, SNR and Q model
    set, and the stations' distances."""
    s = module.Spectrum()
    w = _windows()
    if bands:
        s.set_frequency_bands({"b1": (1.0, 2.0), "b2": (2.0, 5.0),
                               "b3": (5.0, 12.0), "b4": (12.0, 30.0)})
    if method == "fft":
        s.compute_spectrum(w, STATIONS, SR, stack_components=stack,
                           **device_kw)
    else:
        s.compute_multi_band_spectrum(w, STATIONS, SR,
                                      stack_components=stack)
    s.compute_signal_to_noise_ratio()
    dist = np.array([12.0, 20.5, 33.1, 41.0, 18.2])
    s.set_Q_model(Q0=400.0, n=0.3)
    return s, dist


STEPS = [("fft", True, False), ("fft", False, False),
         ("bands", True, False), ("bands", False, False),
         ("bands", True, True)]


@pytest.mark.parametrize("method,stack,bands", STEPS)
def test_every_spectrum_step(method, stack, bands):
    t, dist = _run_steps(tspec, {"device": "cpu"}, method, stack, bands)
    j, _ = _run_steps(jspec, {}, method, stack, bands)
    for ph in ("noise", "p", "s"):
        _same_table(t.spectra[ph], j.spectra[ph])
    for ph in ("p", "s"):
        _same_table(t.snr[ph], j.snr[ph])
    np.testing.assert_array_equal(t.frequencies, j.frequencies)
    tts = {"P": dist / 6.0, "S": dist / 3.5}
    t.compute_correction_factor(dist, tts, STATIONS)
    j.compute_correction_factor(pd.Series(dist, index=STATIONS),
                                pd.DataFrame(tts, index=STATIONS))
    for col in ("geometry_p", "geometry_s"):
        _close(t.geometrical_factor[col], j.geometrical_factor[col].values)
    for ph in ("p", "s"):
        _same_table(t.attenuation_factor[ph], j.attenuation_factor[ph])
    t.update_Q_model(Q0=250.0, n=0.1)
    j.update_Q_model(Q0=250.0, n=0.1)
    _same_table(t.attenuation_factor["s"], j.attenuation_factor["s"])
    for s in (t, j):
        s.correct_geometrical_spreading()
        s.correct_attenuation()
        s.correct_attenuation()   # applied once
    for ph in ("p", "s"):
        _same_table(t.spectra[ph], j.spectra[ph])
    for ph in ("p", "s"):
        for s in (t, j):
            s.compute_network_average_spectrum(ph, snr_threshold=2.0,
                                               min_num_valid_channels=2)
        _same_table(t.average_spectrum, j.average_spectrum)
        _same_table(t.num_valid_channels, j.num_valid_channels)
        # the fit step on the same input: a least-squares fit amplifies
        # the steps' last-bit differences
        t.average_spectrum = tspec.SpectrumTable(
            j.average_spectrum.values, j.average_spectrum.index.values)
        fits = [s.fit_average_spectrum(model="boatwright" if bands
                                       else "brune", weighted=stack)
                for s in (t, j)]
        assert (fits[0] is None) == (fits[1] is None)
        if fits[1] is not None:
            _close([t.M0, t.fc, t.Mw, t.M0_err, t.fc_err],
                   [j.M0, j.fc, j.Mw, j.M0_err, j.fc_err])
    for op, kw in (("integrate", {}), ("differentiate", {"angular": True}),
                   ("integrate", {"average": True})):
        for s in (t, j):
            getattr(s, op)("p", **kw)
        _same_table(t.spectra["p"], j.spectra["p"])
        _same_table(t.average_spectrum, j.average_spectrum)


def test_resample_and_target_frequencies():
    t, _ = _run_steps(tspec, {"device": "cpu"}, "fft", True, False)
    j, _ = _run_steps(jspec, {}, "fft", True, False)
    for s in (t, j):
        s.set_target_frequencies(0.5, 40.0, 30)
        s.resample(s.frequencies, ["p", "S", "missing"])
    _same_table(t.spectra["p"], j.spectra["p"])
    _same_table(t.spectra["s"], j.spectra["s"])
    np.testing.assert_array_equal(t.frequencies, j.frequencies)
    assert t.frequencies.dtype == np.float32
    # the plots are ported (tests/test_torch_viz.py): the same lines as
    # the JAX package's
    pytest.importorskip("matplotlib")
    lines = [[(ln.get_label(), ln.get_xydata())
              for ln in s.plot_spectrum("p").axes[0].get_lines()]
             for s in (t, j)]
    assert [k for k, _ in lines[0]] == [k for k, _ in lines[1]]
    for (_, a), (_, b) in zip(*lines):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


def test_snr_based_weights_equal():
    rng = np.random.default_rng(2)
    for _ in range(20):
        snr = rng.uniform(0.0, 10.0, rng.integers(3, 15))
        thr = float(rng.uniform(1.0, 5.0))
        np.testing.assert_array_equal(
            tsrc.snr_based_weights(snr, thr, 3.0, 6),
            jsrc.snr_based_weights(snr, thr, 3.0, 6))


# ---------------------------------------------------------------------------
# tests/test_response.py's _mw_world, in both packages
# ---------------------------------------------------------------------------

def _mw_world(pkg):
    """Brune displacement pulses of moment M0 (P on Z, S on N) behind the
    two-pole response, in `pkg`'s classes ('jax' or 'torch'); returns
    (event, network, M0)."""
    fc, M0 = 5.0, 1.0e13
    lat, lon = [40.05, 40.10, 40.15], [30.05, 30.12, 30.08]
    if pkg == "jax":
        net = JNetwork.from_dataframe(pd.DataFrame({
            "stations": ["ST1", "ST2", "ST3"], "networks": ["XX"] * 3,
            "latitude": lat, "longitude": lon, "elevation_m": [0.0] * 3}))
        EventC, StreamC, TraceC, sx = JEvent, JStream, JTrace, jsx
    else:
        net = Network.from_arrays(["ST1", "ST2", "ST3"],
                                  networks=["XX"] * 3, latitude=lat,
                                  longitude=lon, elevation_m=np.zeros(3))
        EventC, StreamC, TraceC, sx = Event, Stream, Trace, tsx
    ev_lon, ev_lat, ev_dep = 30.08, 40.09, 8.0
    from seismic_bpmf_tpu_torch.utils.geo import compute_distances

    dist_km = compute_distances([ev_lon], [ev_lat], [ev_dep], lon, lat,
                                np.zeros(3))[0]
    n_win = 400
    mv = np.array([[3.0, 8.0]] * 3, np.float32)
    ev = EventC("2012-07-26T01:00:00", mv, ["ST1", "ST2", "ST3"],
                ["P", "S"], latitude=ev_lat, longitude=ev_lon, depth=ev_dep,
                sampling_rate=SR)
    ev.set_aux_data({"offset_P": 3.0, "offset_S": 8.0})
    corr_p, corr_s = magnitude_world.corrections(dist_km)
    resp = sx.ChannelResponse(
        network="XX", station="ST", location="00", channel="HHZ",
        sensitivity=2.0e8, sensitivity_frequency=5.0, input_units="M/S",
        poles=magnitude_world.POLES, zeros=magnitude_world.ZEROS,
        normalization_factor=magnitude_world.a0())
    n = 1600
    ev.traces = StreamC()
    for s, sta in enumerate(["ST1", "ST2", "ST3"]):
        for cp in "NEZ":
            d = np.zeros(n)
            if cp == "Z":
                d[250:250 + n_win] += magnitude_world.brune_pulse(
                    M0 / corr_p[s], fc, SR, n_win)
            if cp == "N":
                d[750:750 + n_win] += magnitude_world.brune_pulse(
                    M0 / corr_s[s], fc, SR, n_win)
            counts = magnitude_world.forward_counts(d, SR, 2.0e8)
            tr = TraceC(counts.astype(np.float32), station=sta,
                        network="XX", channel=f"HH{cp}", sampling_rate=SR)
            tr.stats.response = resp
            ev.traces += tr
    ev.duration = n / SR
    return ev, net, M0


MW_KW = dict(Q0=1e9, rho=2700.0, vp=6000.0, vs=3500.0, snr_threshold=2.0)
WIN_KW = dict(duration_sec=4.0, attach_response=True, taper_percentage=0.0,
              noise_window_sec=4.0, offset_phase={"P": 0.5, "S": 0.5},
              pre_filt=(0.2, 0.5, 45.0, 49.0))


def _window_close(got, want):
    assert set(got) == set(want)
    for ph in want:
        w = np.asarray(want[ph])
        assert got[ph].shape == w.shape and got[ph].dtype == np.float32
        assert np.abs(got[ph] - w).max() <= 1e-5 * np.abs(w).max(), ph


def test_array_mode_windows_and_magnitudes_on_the_mw_world():
    t_ev, t_net, M0 = _mw_world("torch")
    j_ev, j_net, _ = _mw_world("jax")
    t_win = tsrc.extract_windows(t_ev, device="cpu", **WIN_KW)
    j_win = jsrc.extract_windows(j_ev, **WIN_KW)
    _window_close(t_win, j_win)
    mw_inj = float(tsrc.moment_to_magnitude(M0))
    t_spec = tsrc.compute_moment_magnitude(t_ev, t_net, windows=t_win,
                                           device="cpu", **MW_KW)
    j_spec = jsrc.compute_moment_magnitude(j_ev, j_net, windows=j_win,
                                           **MW_KW)
    assert t_spec.fit_success and j_spec.fit_success
    assert abs(t_spec.Mw - j_spec.Mw) < 1e-4
    assert abs(t_spec.Mw - mw_inj) < 0.25
    assert t_ev.aux_data["Mw"] == t_spec.Mw
    t_star = tsrc.approximate_moment_magnitude(t_ev, t_net, windows=t_win,
                                               **MW_KW)
    j_star = jsrc.approximate_moment_magnitude(j_ev, j_net, windows=j_win,
                                               **MW_KW)
    assert abs(t_star - j_star) < 1e-4
    assert abs(t_star - mw_inj) < 0.3
    assert t_ev.aux_data["Mw_star"] == t_star


def test_unmatched_channels_zeroed_in_array_mode():
    """tests/test_response.py's partial coverage: a station without a
    response is zeroed out of the windows in both packages."""
    t_ev, _, _ = _mw_world("torch")
    j_ev, _, _ = _mw_world("jax")
    for ev in (t_ev, j_ev):
        for tr in ev.traces:
            if tr.stats.station == "ST2":
                tr.stats.response = None
    t_win = tsrc.extract_windows(t_ev, device="cpu", **WIN_KW)
    j_win = jsrc.extract_windows(j_ev, **WIN_KW)
    _window_close(t_win, j_win)
    for ph in ("noise", "p", "s"):
        assert np.all(t_win[ph][1] == 0.0) and np.any(t_win[ph][0] != 0.0)


# ---------------------------------------------------------------------------
# reader mode: miniSEED days and StationXML
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("magnitude_world")
    w = magnitude_world.build_world(str(root), n_sta=5, n_events=2,
                                    hours=0.1, spacing_sec=150.0)
    yield w
    shutil.rmtree(root, ignore_errors=True)


def _jax_twins(w):
    net = JNetwork.from_dataframe(pd.DataFrame({
        "stations": w.network.stations, "networks": w.network.networks,
        "latitude": w.network.latitude, "longitude": w.network.longitude,
        "elevation_m": w.network.elevation}))
    events = [JEvent(ev.origin_time, ev.moveouts_table(), ev.stations,
                     ev.phases, data_path=w.root, latitude=ev.latitude,
                     longitude=ev.longitude, depth=ev.depth,
                     sampling_rate=ev.sr, data_reader=jax_reader)
              for ev in w.events]
    return net, events


READER_KW = dict(duration_sec=4.0, attach_response=True,
                 taper_percentage=0.0, pre_filt=(0.2, 0.5, 45.0, 49.0))


def test_reader_mode_windows_and_magnitudes(world):
    j_net, j_events = _jax_twins(world)
    for t_ev, j_ev, mw in zip(world.events, j_events, world.mw):
        t_win = tsrc.extract_windows(t_ev, device="cpu", **READER_KW)
        j_win = jsrc.extract_windows(j_ev, **READER_KW)
        _window_close(t_win, j_win)
        t_spec = tsrc.compute_moment_magnitude(
            t_ev, world.network, windows=t_win, Q0=1e9, device="cpu")
        j_spec = jsrc.compute_moment_magnitude(j_ev, j_net, windows=j_win,
                                               Q0=1e9)
        assert t_spec.fit_success and j_spec.fit_success
        assert abs(t_spec.Mw - j_spec.Mw) < 1e-4
        assert abs(t_spec.Mw - mw) < 0.25
        t_star = tsrc.approximate_moment_magnitude(
            t_ev, world.network, windows=t_win, Q0=1e9)
        j_star = jsrc.approximate_moment_magnitude(
            j_ev, j_net, windows=j_win, Q0=1e9)
        assert abs(t_star - j_star) < 1e-4
        assert abs(t_star - mw) < 0.3


def test_compute_magnitudes_equal(world):
    """The JAX package's entry point as it runs by default: reader mode
    without responses (the counts are integrated), Mw* where the fit
    fails, None where the computation raises."""
    j_net, j_events = _jax_twins(world)
    got = twf.compute_magnitudes(world.events, world.network, device="cpu")
    want = jwf.compute_magnitudes(j_events, j_net)
    assert len(got) == len(want) == len(world.events)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert abs(g - w) < 1e-8 * max(1.0, abs(w))
    broken = Event(world.events[0].origin_time, np.zeros((1, 2)), ["NONE"],
                   ["P", "S"], data_path=world.root, sampling_rate=SR,
                   data_reader=world.events[0].data_reader)
    assert twf.compute_magnitudes([broken], world.network,
                                  device="cpu") == [None]
