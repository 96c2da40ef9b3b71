"""The port's picking (`ops/picks.py`, `Event.pick_PS_phases`,
`WaveformTransform`) against the JAX package's, on the CPU.

- `normalize_batch_np` is a copy: the same text and the same values.
- The device `normalize_batch` takes its window sums in float64; against
  the JAX one (float32) and against `normalize_batch_np` it agrees within
  rtol 1e-4, atol 1e-5 on x*10+3 data.
- `find_picks` and `get_picks` on the cases of tests/test_picks.py: the
  port's pandas-free table equals the JAX DataFrame value by value.
- `pick_PS_phases`, both routes, on a small synthetic event: the same picks
  as the JAX event's (the waveform-transform route exactly; the picker
  route within rtol 1e-4, its probabilities being two libraries' f32).
"""

import inspect

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from seismic_bpmf_tpu.data import Event as JEvent  # noqa: E402
from seismic_bpmf_tpu.data.stream import Stream as JStream  # noqa: E402
from seismic_bpmf_tpu.data.stream import Trace as JTrace  # noqa: E402
from seismic_bpmf_tpu.data.transform import (  # noqa: E402
    WaveformTransform as JTransform,
)
from seismic_bpmf_tpu.models import phasenet as jpn  # noqa: E402
from seismic_bpmf_tpu.ops import picks as jpicks  # noqa: E402
from seismic_bpmf_tpu_torch.data import (  # noqa: E402
    Event, Stream, Trace, WaveformTransform,
)
from seismic_bpmf_tpu_torch.models import phasenet as tpn  # noqa: E402
from seismic_bpmf_tpu_torch.ops import picks as tpicks  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def test_normalize_batch_np_is_the_jax_copy():
    assert inspect.getsource(tpicks.normalize_batch_np) == inspect.getsource(
        jpicks.normalize_batch_np)
    x = np.random.default_rng(0).normal(size=(2, 3, 7000)) * 10 + 3
    np.testing.assert_array_equal(tpicks.normalize_batch_np(x),
                                  jpicks.normalize_batch_np(x))


@pytest.mark.parametrize("n, window", [(12000, 3000), (7001, 1000)])
def test_normalize_batch_matches_jax_and_numpy(n, window):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 3, n)) * 10 + 3).astype(np.float32)
    x[1, 2, : n // 2] = 0.0                      # a dead half: std 0 -> 1
    got = tpicks.normalize_batch(x, window, device="cpu")
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jpicks.normalize_batch(x, window)),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(),
                               tpicks.normalize_batch_np(x, window),
                               rtol=RTOL, atol=ATOL)
    got64 = tpicks.normalize_batch(torch.from_numpy(x.astype(np.float64)),
                                   window)
    np.testing.assert_allclose(
        got64.numpy(), tpicks.normalize_batch_np(x.astype(np.float64),
                                                 window),
        rtol=1e-12, atol=1e-12)


def _bumps(n, spec, rng):
    t = np.arange(n)
    prob = np.zeros(n)
    for center, width, h in spec:
        prob += h * np.exp(-((t - center) ** 2) / (2 * width**2))
    return prob + 0.01 * rng.random(n)


@pytest.mark.parametrize("case", ["bumps", "empty", "day_scale"])
def test_find_picks_matches_jax(case):
    rng = np.random.default_rng(7)
    if case == "bumps":
        prob = _bumps(6000, [(500, 20, 0.9), (1500, 60, 0.6),
                             (1545, 15, 0.55), (4000, 35, 0.95)], rng)
    elif case == "empty":
        prob = np.zeros(100)
    else:
        prob = np.zeros(8_640_000 + 4000)
        prob[8_640_500: 8_643_500] = _bumps(3000, [(1500, 25.0, 0.9)],
                                            rng) - 0.01
    for got, want in zip(tpicks.find_picks(prob, 0.3),
                         jpicks.find_picks(prob, 0.3)):
        np.testing.assert_array_equal(got, want)


GET_PICKS_CASES = {
    "s_first_then_best_p_before_s": (
        {"ST1": {"P_picks": [200.0, 800.0], "P_probas": [0.4, 0.9],
                 "P_unc": [2.0, 3.0], "S_picks": [600.0, 300.0],
                 "S_probas": [0.8, 0.3], "S_unc": [5.0, 4.0]}},
        dict(buffer_length=50)),
    "buffer_filter_and_empty": (
        {"ST1": {"P_picks": [30.0], "P_probas": [0.9], "P_unc": [1.0],
                 "S_picks": [400.0], "S_probas": [0.7], "S_unc": [2.0]},
         "ST2": {f"{ph}_{c}": [] for ph in "PS"
                 for c in ("picks", "probas", "unc")}},
        dict(buffer_length=50)),
    "no_s_keeps_unconstrained_best_p": (
        {"ST1": {"P_picks": [200.0, 900.0], "P_probas": [0.2, 0.8],
                 "P_unc": [1.0, 2.0], "S_picks": [], "S_probas": [],
                 "S_unc": []}},
        dict(buffer_length=0)),
    "gaussian_prior": (
        {"ST1": {"P_picks": [100.0, 500.0], "P_probas": [0.5, 0.6],
                 "P_unc": [1.0, 1.0], "S_picks": [600.0, 1000.0],
                 "S_probas": [0.5, 0.6], "S_unc": [1.0, 1.0]},
         "ST2": {"P_picks": [100.0, 500.0], "P_probas": [0.5, 0.6],
                 "P_unc": [1.0, 1.0], "S_picks": [600.0, 1000.0],
                 "S_probas": [0.5, 0.6], "S_unc": [1.0, 1.0]}},
        dict(buffer_length=0, search_win_samp=50,
             prior_knowledge=pd.DataFrame({"P": [100.0], "S": [600.0]},
                                          index=["ST1"]))),
}


def _assert_table_equals_frame(table, frame):
    assert list(table.stations) == [str(s) for s in frame.index]
    assert list(table.columns) == list(frame.columns)
    for c in frame.columns:
        want = frame[c].to_numpy()
        assert table[c].dtype == want.dtype, c
        np.testing.assert_array_equal(table[c], want)


@pytest.mark.parametrize("case", list(GET_PICKS_CASES))
def test_get_picks_matches_jax(case):
    data, kw = GET_PICKS_CASES[case]
    rows = {sta: {k: np.asarray(v, float) for k, v in d.items()}
            for sta, d in data.items()}
    frame = pd.DataFrame.from_dict(rows, orient="index")
    frame.index.name = "stations"
    want = jpicks.get_picks(frame, **kw)
    _assert_table_equals_frame(tpicks.get_picks(tpicks.candidates(rows),
                                                **kw), want)
    # the JAX DataFrame itself, and a prior given as a mapping
    _assert_table_equals_frame(tpicks.get_picks(frame, **kw), want)
    if "prior_knowledge" in kw:
        prior = kw["prior_knowledge"]
        kw = dict(kw, prior_knowledge={s: (prior.loc[s, "P"],
                                           prior.loc[s, "S"])
                                       for s in prior.index})
        _assert_table_equals_frame(
            tpicks.get_picks(tpicks.candidates(rows), **kw), want)
    assert tpicks.get_picks(tpicks.candidates(rows), **kw).to_frame().equals(
        want)


# --------------------------------------------------------------------------
# WaveformTransform and Event.pick_PS_phases on a small synthetic event

SR, T0 = 25.0, 1343260800.0
STATIONS = ["A", "B", "C"]
N_DAY = 6000


def _day():
    """Probability series and waveforms of a 240 s window: P and S bumps
    per station after an origin at 100 s."""
    rng = np.random.default_rng(3)
    t = np.arange(N_DAY)
    probas = np.zeros((3, 2, N_DAY), np.float32)
    wave = 0.2 * rng.standard_normal((3, 3, N_DAY)).astype(np.float32)
    for s in range(3):
        for p, delay in enumerate((3.0 + s, 5.5 + 1.8 * s)):
            k = int((100.0 + delay) * SR)
            probas[s, p] = 0.9 * np.exp(-((t - k) ** 2) / (2 * 6.0**2))
            wave[s, 2 - 2 * p, k: k + 40] += 4.0 * np.hanning(40)
    return probas, wave


def test_waveform_transform_slice_matches_jax():
    probas, _ = _day()
    tt = WaveformTransform(probas, STATIONS, ["P", "S"],
                           np.datetime64("2012-07-26T00:00:00"), SR)
    jt = JTransform(probas, STATIONS, ["P", "S"],
                    np.datetime64("2012-07-26T00:00:00"), SR)
    for kw in (dict(duration=60.0), dict(num_samples=2000),
               dict(duration=60.0, stations=["C", "X", "A"],
                    components=["S"])):
        for start in ("2012-07-26T00:01:10.02", "2012-07-26T00:03:50"):
            a, b = tt.slice(start, **kw), jt.slice(start, **kw)
            np.testing.assert_array_equal(a.transform_arr, b.transform_arr)
            assert a.starttime == b.starttime and a.stations == b.stations
            assert a.components == b.components and a.sr == b.sr
    assert tt.get_np_array(["B"]).shape == (1, 2, N_DAY)


def _reader(cls_stream, cls_trace, wave):
    def reader(where, stations=None, channels=None, starttime=None,
               endtime=None, **kw):
        st = cls_stream()
        for s, sta in enumerate(STATIONS):
            for c, comp in enumerate("NEZ"):
                if ((stations is None or sta in stations)
                        and (channels is None or channels.endswith(comp))):
                    st += cls_trace(wave[s, c], station=sta, network="XX",
                                    channel=f"HH{comp}", sampling_rate=SR,
                                    starttime=T0)
        return st.slice(starttime, endtime)
    return reader


def _events(wave):
    mv = np.zeros((3, 2))
    kw = dict(sampling_rate=SR, latitude=0.0, longitude=0.0, depth=5.0)
    return (Event(T0 + 100.0, mv, STATIONS, ["P", "S"], "w", "",
                  data_reader=_reader(Stream, Trace, wave), **kw),
            JEvent(T0 + 100.0, mv, STATIONS, ["P", "S"], "w", "",
                   data_reader=_reader(JStream, JTrace, wave), **kw))


def _assert_picks_equal(table, frame, rtol=0.0):
    assert list(table.stations) == list(frame.index)
    assert list(table.columns) == list(frame.columns)
    for c in frame.columns:
        want = frame[c].to_numpy()
        if want.dtype.kind == "M":
            got = table[c].astype("int64")
            np.testing.assert_allclose(
                got[~np.isnat(table[c])],
                want.astype("datetime64[ns]").astype("int64")[
                    ~np.isnat(want)], rtol=0, atol=rtol * 60e9)  # of 60 s
            np.testing.assert_array_equal(np.isnat(table[c]), np.isnat(want))
        else:
            assert table[c].dtype == want.dtype == np.float32
            np.testing.assert_allclose(table[c], want, rtol=rtol)


def test_pick_ps_phases_waveform_transform_matches_jax():
    probas, wave = _day()
    start = np.datetime64(int(T0 * 1e9), "ns")
    tev, jev = _events(wave)
    table = tev.pick_PS_phases(
        60.0, waveform_transform=WaveformTransform(
            probas, STATIONS, ["P", "S"], start, SR))
    frame = jev.pick_PS_phases(
        60.0, waveform_transform=JTransform(probas, STATIONS, ["P", "S"],
                                            start, SR))
    _assert_picks_equal(table, frame)
    assert np.isfinite(table["P_picks"]).all()
    assert np.isfinite(table["S_picks"]).all()
    # the lazy DataFrame is the JAX one
    pd.testing.assert_frame_equal(tev.picks, frame)


def test_pick_ps_phases_picker_route_matches_jax():
    _, wave = _day()
    model, variables = jpn.init_phasenet(jax.random.PRNGKey(0))
    tmodel = tpn.PhaseNet()
    tmodel.load_state_dict(tpn.from_flax_variables(
        jax.tree.map(np.asarray, variables)))
    tev, jev = _events(wave)
    jpicker = jpn.make_picker(model, variables)
    # thresholds from the probabilities' quantiles: random weights pick
    # wherever their output is highest
    x = jev.read_waveforms(60.0, time_shifted=False,
                           offset_ot=20.0).waveforms_arr
    from scipy.signal import resample_poly

    pr = jpicker(resample_poly(x[:, [2, 0, 1]], 4, 1, axis=-1))
    thr = {f"threshold_{ph}": float(np.quantile(pr[:, p], 0.5))
           for p, ph in enumerate("PS")}
    frame = jev.pick_PS_phases(60.0, picker=jpicker, **thr)
    table = tev.pick_PS_phases(60.0, picker=tpn.make_picker(tmodel), **thr)
    for ph in "PS":
        assert np.isfinite(frame[f"{ph}_picks"].to_numpy()).any()
    _assert_picks_equal(table, frame, rtol=RTOL)


def test_pick_ps_phases_needs_a_picker_or_a_transform():
    tev, _ = _events(_day()[1])
    with pytest.raises(ValueError, match="picker"):
        tev.pick_PS_phases(60.0)
    assert not hasattr(tev, "picks")
