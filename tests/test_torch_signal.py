"""The port's device preprocessing (`ops/signal.py`) against the JAX
package's, on the cases of tests/test_signal.py, on the CPU.

Both run in float32; the port's arithmetic differs in order only (its
detrend takes sum((t - t_mean)^2) in closed form, the FFTs are two
libraries'), so values agree within atol 1e-5 on unit-scale traces.  The
port's float64 run of the same function stands within 1e-5 too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scipy.signal import butter, sosfiltfilt  # noqa: E402

from seismic_bpmf_tpu.ops import signal as jsig  # noqa: E402
from seismic_bpmf_tpu_torch.ops import signal as tsig  # noqa: E402

ATOL = 1e-5


def _both(name, x, **kw):
    """(port f32, JAX f32, port f64) of one function on one input."""
    got = getattr(tsig, name)(x, device="cpu", **kw).numpy()
    want = np.asarray(getattr(jsig, name)(x, **kw))
    got64 = getattr(tsig, name)(torch.from_numpy(x.astype(np.float64)),
                                **kw).numpy()
    assert got.dtype == np.float32 and got64.dtype == np.float64
    return got, want, got64


def test_detrend_matches_jax():
    rng = np.random.default_rng(0)
    t = np.arange(1000, dtype=np.float32)
    x = 3.0 + 0.01 * t + rng.normal(size=1000).astype(np.float32)
    got, want, got64 = _both("detrend_linear", x[None, :])
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got64, want, atol=ATOL)
    assert abs(np.polyfit(t, got[0], 1)[0]) < 1e-6
    assert abs(got[0].mean()) < 1e-4


def test_bandpass_matches_jax_and_filtfilt():
    rng = np.random.default_rng(1)
    sr, n = 100.0, 8192
    x = rng.normal(size=(2, n)).astype(np.float32)
    kw = dict(sr=sr, freqmin=2.0, freqmax=12.0, order=4)
    got, want, got64 = _both("bandpass_zerophase", x, **kw)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got64, want, atol=ATOL)
    sos = butter(4, [2.0, 12.0], btype="bandpass", fs=sr, output="sos")
    ref = sosfiltfilt(sos, x, axis=-1)
    sl = slice(500, n - 500)
    for i in range(2):
        assert np.corrcoef(got[i, sl], ref[i, sl])[0, 1] > 0.98


def test_bandpass_stopband_attenuation():
    sr, n = 100.0, 4096
    t = np.arange(n) / sr
    kw = dict(sr=sr, freqmin=2, freqmax=12)
    sl = slice(200, n - 200)
    for f, check in ((5.0, lambda y, x: np.std(y) > 0.9 * np.std(x)),
                     (40.0, lambda y, x: np.std(y) < 1e-3 * np.std(x))):
        x = np.sin(2 * np.pi * f * t).astype(np.float32)[None]
        got, want, _ = _both("bandpass_zerophase", x, **kw)
        np.testing.assert_allclose(got, want, atol=ATOL)
        assert check(got[0, sl], x[0, sl])


def test_resample_matches_jax():
    sr, n = 100.0, 4000
    t = np.arange(n) / sr
    x = np.sin(2 * np.pi * 5.0 * t).astype(np.float32)[None]
    got, want, got64 = _both("resample_fourier", x, n_out=1000)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got64, want, atol=ATOL)
    t4 = np.arange(1000) / 25.0
    np.testing.assert_allclose(got[0, 50:950],
                               np.sin(2 * np.pi * 5.0 * t4)[50:950],
                               atol=0.02)


@pytest.mark.parametrize("target_sr", [None, 25.0])
def test_preprocess_batch_matches_jax(target_sr):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 3, 10000)).astype(np.float32)
    got, want, got64 = _both("preprocess_batch", x, sr=100.0, freqmin=2.0,
                             freqmax=12.0, target_sr=target_sr)
    assert got.shape == want.shape == (
        (3, 3, 2500) if target_sr else (3, 3, 10000))
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got64, want, atol=ATOL)


def test_tukey_taper_and_butter_match_jax():
    np.testing.assert_array_equal(tsig.tukey_taper(1000, 0.05),
                                  jsig.tukey_taper(1000, 0.05))
    f = np.fft.rfftfreq(512, d=0.01)
    np.testing.assert_array_equal(
        tsig._butter_mag2(f, 2.0, 12.0, 4).astype(np.float32),
        jsig._butter_mag2(f, 2.0, 12.0, 4))
