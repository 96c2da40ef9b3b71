"""Device preprocessing (detrend, taper, bandpass, resample) on `torch.fft`.

Counterpart of `seismic_bpmf_tpu.ops.signal`: once a day of raw data is on
the card it is detrended, tapered, zero-phase bandpassed and resampled
there, and feeds the picker or the beamformer without a host round trip.

The zero-phase bandpass multiplies the spectrum by the squared Butterworth
magnitude response |H(f)|^2, the frequency-domain twin of scipy's
forward-backward `sosfiltfilt` (the same amplitude response, both
zero-phase).  Resampling is Fourier-domain (scipy.signal.resample
semantics without its Nyquist-bin split, as the JAX package does).

A numpy input goes to `device` as float32 (the package rule: CUDA unless
'cpu' is asked for); a tensor stays where it is, in its own float dtype,
so the same functions run the float64 reference on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device


def _float_tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.to(torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        resolve_device(device))


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host constant in `like`'s dtype on its device."""
    return torch.from_numpy(np.asarray(a)).to(device=like.device,
                                              dtype=like.dtype)


def detrend_linear(x, device=None) -> torch.Tensor:
    """Remove each trace's least-squares line along the last axis."""
    x = _float_tensor(x, device)
    n = x.shape[-1]
    t = torch.arange(n, device=x.device, dtype=x.dtype) - (n - 1) / 2.0
    t_var = n * (n * n - 1.0) / 12.0          # sum((t - t_mean)^2), exact
    x_mean = x.mean(dim=-1, keepdim=True)
    slope = ((t * (x - x_mean)).sum(dim=-1, keepdim=True)) / t_var
    return x - x_mean - slope * t


def tukey_taper(n: int, alpha: float = 0.01) -> np.ndarray:
    """Tukey window (host-built constant, float32)."""
    from scipy.signal.windows import tukey

    return tukey(n, alpha=alpha).astype(np.float32)


def _butter_mag2(freqs, freqmin, freqmax, order):
    """Squared magnitude response of an analog Butterworth bandpass
    (float64; cast to the data's dtype, for f32 the JAX package's
    `astype(float32)` of the same values)."""
    f = np.maximum(np.abs(freqs), 1e-12)
    hp = 1.0 / (1.0 + (freqmin / f) ** (2 * order))
    lp = 1.0 / (1.0 + (f / freqmax) ** (2 * order))
    return hp * lp


def bandpass_zerophase(x, *, sr: float, freqmin: float, freqmax: float,
                       order: int = 4, taper_alpha: float = 0.01,
                       device=None) -> torch.Tensor:
    """Zero-phase Butterworth-magnitude bandpass along the last axis:
    detrend, Tukey taper, |H|^2 on the rfft spectrum."""
    x = detrend_linear(x, device)
    n = x.shape[-1]
    x = x * _const(tukey_taper(n, taper_alpha), x)
    h2 = _const(_butter_mag2(np.fft.rfftfreq(n, d=1.0 / sr), freqmin,
                             freqmax, order), x)
    return torch.fft.irfft(torch.fft.rfft(x, dim=-1) * h2, n=n, dim=-1)


def resample_fourier(x, n_out: int, device=None) -> torch.Tensor:
    """Fourier-domain resampling to `n_out` samples along the last axis."""
    x = _float_tensor(x, device)
    n = x.shape[-1]
    xf = torch.fft.rfft(x, dim=-1)
    n_keep = min(n, n_out) // 2 + 1
    out_f = torch.zeros(x.shape[:-1] + (n_out // 2 + 1,), dtype=xf.dtype,
                        device=x.device)
    out_f[..., :n_keep] = xf[..., :n_keep]
    return torch.fft.irfft(out_f, n=n_out, dim=-1) * (n_out / n)


def preprocess_batch(x, sr: float, freqmin: float, freqmax: float,
                     target_sr: float = None, order: int = 4,
                     device=None) -> torch.Tensor:
    """Detrend + taper + zero-phase bandpass + (optional) Fourier
    resampling of (n_sta, n_comp, n_samples) raw waveforms, on the device.
    Returns the traces at `target_sr` (or `sr` if None)."""
    x = bandpass_zerophase(x, sr=sr, freqmin=freqmin, freqmax=freqmax,
                           order=order, device=device)
    if target_sr is not None and target_sr != sr:
        x = resample_fourier(x, int(round(x.shape[-1] * target_sr / sr)))
    return x
