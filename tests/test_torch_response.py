"""The port's StationXML parser (`data/stationxml.py`) and response
removal (`ops/response.py`) against the JAX package's.

Parsed fields, transfer functions and inverse filters are numpy in both
packages and must be equal.  The deconvolution runs in float32 / complex64
in both (`torch.fft` here, a jitted XLA FFT there): the port's output
lies within 1e-5 of the JAX output's maximum.  tests/test_response.py's
physical checks (displacement and velocity recovered from counts, the
reader attaching responses) run again through the port.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seismic_bpmf_tpu.data import stationxml as jsx  # noqa: E402
from seismic_bpmf_tpu.data.stream import (  # noqa: E402
    Stream as JStream, Trace as JTrace,
)
from seismic_bpmf_tpu.ops import response as jresp  # noqa: E402

from seismic_bpmf_tpu_torch.data import (  # noqa: E402
    Stream, Trace, data_reader_mseed,
)
from seismic_bpmf_tpu_torch.data import stationxml as tsx  # noqa: E402
from seismic_bpmf_tpu_torch.data.mseed import write_mseed  # noqa: E402
from seismic_bpmf_tpu_torch.ops import response as tresp  # noqa: E402
from seismic_bpmf_tpu_torch.tools.magnitude_world import (  # noqa: E402
    NORM_FREQ, POLES, ZEROS, forward_counts, stationxml,
)

SR = 100.0
SENS = 2.0e8
PRE_FILT = (0.5, 1.0, 40.0, 45.0)
T0 = float(np.datetime64("2012-07-26T00:00:00", "s").astype(np.int64))


def _variant(name):
    """The world's StationXML, and variants that reach the parser's other
    branches: poles/zeros in Hz, input in nm/s, two stages in mixed
    conventions, a channel without a response."""
    xml = stationxml("TST1", SENS, channels=("HHZ", "HHN"))
    if name == "hertz":
        xml = xml.replace("LAPLACE (RADIANS/SECOND)", "LAPLACE (HERTZ)")
    elif name == "nm":
        xml = xml.replace("<InputUnits><Name>M/S</Name></InputUnits>\n"
                          "      <OutputUnits><Name>COUNTS",
                          "<InputUnits><Name>NM/S</Name></InputUnits>\n"
                          "      <OutputUnits><Name>COUNTS")
    elif name == "mixed":
        stage = xml[xml.index('<Stage number="1">'):
                    xml.index("</Stage>") + len("</Stage>")]
        second = stage.replace('number="1"', 'number="2"').replace(
            "LAPLACE (RADIANS/SECOND)", "LAPLACE (HERTZ)")
        xml = xml.replace(stage, stage + second)
    elif name == "no_response":
        start = xml.index("<Response>", xml.index('code="HHN"'))
        end = xml.index("</Response>", start) + len("</Response>")
        xml = xml[:start] + xml[end:]
    return xml


VARIANTS = ["radians", "hertz", "nm", "mixed", "no_response"]
FIELDS = ["network", "station", "location", "channel", "start_date",
          "end_date", "sensitivity", "sensitivity_frequency", "input_units",
          "normalization_factor", "pz_in_hertz"]


@pytest.mark.parametrize("name", VARIANTS)
def test_stationxml_fields_and_transfer_function(tmp_path, name):
    path = tmp_path / "XX.TST1.xml"
    path.write_text(_variant(name))
    t_inv = tsx.parse_stationxml(str(path))
    j_inv = jsx.parse_stationxml(str(path))
    assert len(t_inv) == len(j_inv) == (1 if name == "no_response" else 2)
    f = np.fft.rfftfreq(1024, d=1.0 / SR)
    for t, j in zip(t_inv.responses, j_inv.responses):
        for field in FIELDS:
            assert getattr(t, field) == getattr(j, field), field
        np.testing.assert_array_equal(t.poles, j.poles)
        np.testing.assert_array_equal(t.zeros, j.zeros)
        for output in ("DISP", "VEL", "ACC"):
            np.testing.assert_array_equal(t.transfer_function(f, output),
                                          j.transfer_function(f, output))
        assert t.covers(1.6e9) == j.covers(1.6e9) and not t.covers(0.0)
    if name == "radians":
        r = t_inv.get_response("XX", "TST1", "HHZ", "00")
        np.testing.assert_allclose(np.sort_complex(r.poles),
                                   np.sort_complex(POLES))
        h = r.transfer_function(np.array([NORM_FREQ]), output="VEL")
        assert np.abs(h[0]) == pytest.approx(SENS, rel=1e-6)


def test_read_inventory_and_attach(tmp_path):
    for sta, sens in (("TST1", SENS), ("TST2", 3e8)):
        (tmp_path / f"XX.{sta}.xml").write_text(stationxml(sta, sens))
    t_inv = tsx.read_inventory(str(tmp_path / "*.xml"))
    j_inv = jsx.read_inventory(str(tmp_path / "*.xml"))
    assert len(t_inv) == len(j_inv) == 6
    traces = [("TST1", "HHZ"), ("TST2", "HHN"), ("TST3", "HHZ")]
    t_st = Stream([Trace(np.zeros(10), station=s, network="XX", channel=c,
                         location="00", starttime=1.6e9) for s, c in traces])
    j_st = JStream([JTrace(np.zeros(10), station=s, network="XX", channel=c,
                           location="00", starttime=1.6e9)
                    for s, c in traces])
    assert t_inv.attach(t_st) == j_inv.attach(j_st) == 2
    for t, j in zip(t_st, j_st):
        if j.stats.response is None:
            assert t.stats.response is None
        else:
            assert t.stats.response.sensitivity == j.stats.response.sensitivity


def _response(module):
    return module.ChannelResponse(
        network="XX", station="TST1", location="00", channel="HHZ",
        sensitivity=SENS, sensitivity_frequency=NORM_FREQ,
        input_units="M/S", poles=POLES, zeros=ZEROS,
        normalization_factor=float(1.0 / np.abs(
            np.prod(2j * np.pi * NORM_FREQ - ZEROS)
            / np.prod(2j * np.pi * NORM_FREQ - POLES))),
    )


def test_taper_water_level_and_inverse_filter_equal():
    f = np.linspace(0.0, 50.0, 501)
    np.testing.assert_array_equal(
        tresp.cosine_sac_taper(f, (1.0, 2.0, 40.0, 48.0)),
        jresp.cosine_sac_taper(f, (1.0, 2.0, 40.0, 48.0)))
    spec = np.array([1.0, 1e-5, 0.0, 3.0 - 4.0j, -2e-4j], complex)
    for wl in (60.0, 20.0, None):
        np.testing.assert_array_equal(
            tresp.invert_spectrum_water_level(spec, wl),
            jresp.invert_spectrum_water_level(spec, wl))
    for output in ("DISP", "VEL", "ACC"):
        for pre_filt in (None, PRE_FILT):
            t_f, t_n = tresp.build_inverse_filter(
                _response(tsx), 1000, SR, output, pre_filt, 60.0)
            j_f, j_n = jresp.build_inverse_filter(
                _response(jsx), 1000, SR, output, pre_filt, 60.0)
            assert t_n == j_n == 2048 and t_f.dtype == np.complex64
            np.testing.assert_array_equal(t_f, j_f)


def _bandlimited_disp(rng, n, f_lo=2.0, f_hi=10.0):
    from scipy.signal import butter, sosfilt

    sos = butter(4, [f_lo, f_hi], btype="band", fs=SR, output="sos")
    return 1e-6 * sosfilt(sos, rng.normal(size=n)).astype(np.float64)


@pytest.mark.parametrize("output", ["DISP", "VEL"])
def test_remove_response_arr_within_1e5_of_the_jax_output(output):
    """(2 stations, 3 channels) of counts, one channel without a
    response (it comes back unchanged)."""
    rng = np.random.default_rng(31)
    counts = np.stack([forward_counts(_bandlimited_disp(rng, 3000), SR, SENS)
                       for _ in range(6)]).reshape(2, 3, 3000)
    t_resp = [_response(tsx)] * 6
    j_resp = [_response(jsx)] * 6
    t_resp[4] = j_resp[4] = None
    got = tresp.remove_response_arr(counts, t_resp, SR, output=output,
                                    pre_filt=PRE_FILT, device="cpu")
    want = np.asarray(jresp.remove_response_arr(
        counts, j_resp, SR, output=output, pre_filt=PRE_FILT))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got[1, 1], counts[1, 1].astype(np.float32))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert tresp.apply_spectral_filter.launches == 0  # CPU runs


def test_remove_response_stream_within_1e5_of_the_jax_output():
    rng = np.random.default_rng(32)
    counts = forward_counts(_bandlimited_disp(rng, 2048), SR, SENS)
    t_st = Stream([Trace(counts, station="TST1", network="XX",
                         channel="HHZ", location="00", sampling_rate=SR,
                         starttime=1.6e9),
                   Trace(counts, station="TST9", channel="HHZ",
                         sampling_rate=SR, starttime=1.6e9)])
    j_st = JStream([JTrace(counts, station="TST1", network="XX",
                           channel="HHZ", location="00", sampling_rate=SR,
                           starttime=1.6e9),
                    JTrace(counts, station="TST9", channel="HHZ",
                           sampling_rate=SR, starttime=1.6e9)])
    n_t = tresp.remove_response_stream(t_st, tsx.Inventory([_response(tsx)]),
                                       output="VEL", pre_filt=PRE_FILT,
                                       device="cpu")
    n_j = jresp.remove_response_stream(j_st, jsx.Inventory([_response(jsx)]),
                                       output="VEL", pre_filt=PRE_FILT)
    assert n_t == n_j == 1
    want = np.asarray(j_st[0].data)
    assert np.abs(t_st[0].data - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(t_st[1].data, j_st[1].data)


def test_recover_displacement_and_velocity():
    """tests/test_response.py's recoveries through the port: counts of a
    known band-limited motion come back as that motion."""
    rng = np.random.default_rng(31)
    n = 4096
    disp = _bandlimited_disp(rng, n)
    rec = tresp.remove_response_arr(
        forward_counts(disp, SR, SENS)[None, :], [_response(tsx)], SR,
        output="DISP", pre_filt=(0.5, 1.0, 40.0, 45.0), water_level_db=60.0,
        device="cpu")[0]
    sl = slice(200, n - 200)
    assert (np.linalg.norm(rec[sl] - disp[sl])
            / np.linalg.norm(disp[sl])) < 0.02

    n = 2048
    disp = _bandlimited_disp(rng, n)
    f = np.fft.rfftfreq(n, d=1.0 / SR)
    vel = np.fft.irfft(np.fft.rfft(disp) * 2j * np.pi * f, n)
    st = Stream([Trace(forward_counts(disp, SR, SENS).astype(np.float32),
                       station="TST1", network="XX", channel="HHZ",
                       location="00", sampling_rate=SR, starttime=1.6e9)])
    assert tresp.remove_response_stream(
        st, tsx.Inventory([_response(tsx)]), output="VEL",
        pre_filt=(0.5, 1.0, 40.0, 45.0), device="cpu") == 1
    sl = slice(200, n - 200)
    assert (np.linalg.norm(st[0].data[sl] - vel[sl])
            / np.linalg.norm(vel[sl])) < 0.05


def _reader_folder(tmp_path, resp_dir="resp"):
    day = tmp_path / "2012" / "208"
    day.mkdir(parents=True)
    tr = Trace(np.random.default_rng(3).normal(size=2000).astype(np.float32)
               * 100, station="TST1", network="XX", channel="HHZ",
               location="00", sampling_rate=SR, starttime=T0)
    write_mseed(Stream([tr]), str(day / "XX.TST1.00.HHZ_20120726.mseed"),
                encoding="FLOAT32")
    resp = tmp_path / resp_dir
    resp.mkdir(parents=True)
    (resp / "XX.TST1.xml").write_text(stationxml("TST1", SENS))
    return resp / "XX.TST1.xml"


READ = dict(network="XX", stations=["TST1"],
            starttime=np.datetime64("2012-07-26T00:00:00"),
            endtime=np.datetime64("2012-07-26T00:00:10"),
            attach_response=True)


def test_mseed_reader_attaches_response(tmp_path):
    xml = _reader_folder(tmp_path)
    st = data_reader_mseed(str(tmp_path), **READ)
    assert len(st) == 1
    assert st[0].stats.response.station == "TST1"
    assert st[0].stats.response.sensitivity == SENS
    # the parsed folder is reused until a file changes
    assert data_reader_mseed(str(tmp_path), **READ)[0].stats.response is \
        st[0].stats.response
    xml.write_text(stationxml("TST1", 3.0e8) + "\n")
    assert data_reader_mseed(
        str(tmp_path), **READ)[0].stats.response.sensitivity == 3.0e8


def test_mseed_reader_reads_a_resp_folder_beside_the_root(tmp_path):
    _reader_folder(tmp_path / "data", resp_dir="../resp")
    st = data_reader_mseed(str(tmp_path / "data"), **READ)
    assert st[0].stats.response.channel == "HHZ"


def test_mseed_reader_without_responses_raises(tmp_path):
    xml = _reader_folder(tmp_path)
    os.remove(xml)
    with pytest.raises(FileNotFoundError, match="attach_response"):
        data_reader_mseed(str(tmp_path), **READ)
