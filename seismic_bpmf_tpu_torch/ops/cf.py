"""Characteristic functions, as plain torch ops on the device.

Counterpart of `seismic_bpmf_tpu.ops.cf`:
  - `envelope`: modulus of the analytic signal, an FFT Hilbert transform
    in f32 (`torch.fft`), BPMF/template_search.py:1598-1617;
  - `saturated_envelopes`: MAD-standardized, clipped envelopes and the
    per-station count of available components
    (BPMF/template_search.py:1525-1570), the backprojection features;
  - `kurtosis`: running kurtosis over a trailing window (BPMF/libc.c:11-53);
  - `scalar_kurtosis`: the matched filter's CC sanity check.

A numpy input goes to `device` (the package rule: CUDA unless 'cpu' is
asked for); a tensor stays where it is.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .thresholds import _nanmedian


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        resolve_device(device))


def envelope(traces, device=None) -> torch.Tensor:
    """|analytic signal| along the last axis, f32."""
    x = _f32(traces, device)
    n = x.shape[-1]
    h = np.zeros(n, dtype=np.float32)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1 : n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1 : (n + 1) // 2] = 2.0
    xf = torch.fft.fft(x, dim=-1)
    xf *= torch.from_numpy(h).to(x.device)
    return torch.fft.ifft(xf, dim=-1).abs()


def saturated_envelopes(traces, anomaly_threshold: float = 1.0e-11,
                        max_dynamic_range: float = 1.0e5, device=None):
    """MAD-standardized, saturated envelopes (n_sta, n_comp, n_samp) f32
    and the per-station count of good components (n_sta,) int32, on the
    device.  A channel more than half zero, or with a MAD below
    `anomaly_threshold`, gives zeros and does not count."""
    env = envelope(traces, device)
    n_samp = env.shape[-1]
    missing = env == 0.0
    n_missing = missing.sum(dim=-1)
    env_nan = torch.where(missing, torch.full_like(env, float("nan")), env)
    med = _nanmedian(env_nan)
    mad = _nanmedian(torch.abs(env_nan - med))
    del env_nan
    std = (env - med) / mad
    std = torch.where(missing, torch.zeros_like(std), std)
    std = torch.clamp(std, max=max_dynamic_range)
    bad = (n_missing > n_samp / 2) | (mad[..., 0] < anomaly_threshold)
    std = torch.where(bad[..., None], torch.zeros_like(std), std)
    availability = (~bad).sum(dim=-1).to(torch.int32)
    return std, availability


def kurtosis(signal, w: int, device=None) -> torch.Tensor:
    """Running kurtosis over a trailing window of `w` samples: kurto[n]
    uses samples [n-w, n); 0 for n < w or where the window variance is
    <= 1e-6.  The JAX package's f32 arithmetic: window sums of the raw
    moments added in window order, then the moment formulas."""
    x = _f32(signal, device)
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    # kurtosis is shift-invariant: remove the trace mean first
    x2d = x2d - x2d.mean(dim=-1, keepdim=True)
    n = x2d.shape[-1]

    def wsum(p):
        acc = p[:, : n - w + 1].clone()
        for j in range(1, w):
            acc += p[:, j : n - w + 1 + j]
        return acc

    x2 = x2d * x2d
    s1, s2, s3, s4 = (wsum(p) for p in (x2d, x2, x2 * x2d, x2 * x2))
    wf = float(w)
    mu = s1 / wf
    m2 = s2 / wf - mu**2
    m4 = s4 / wf - 4.0 * mu * s3 / wf + 6.0 * mu**2 * s2 / wf - 3.0 * mu**4
    coeff = 1.0 / ((wf - 2.0) * (wf - 3.0))
    k = coeff * ((wf**2 - 1.0) * m4 / torch.clamp(m2, min=1e-30) ** 2
                 - 3.0 * (wf - 1.0) ** 2)
    k = torch.where(m2 > 1e-6, k, torch.zeros_like(k))
    out = torch.zeros_like(x2d)
    out[:, w:] = k[:, : n - w]
    return out.reshape(shape)


def scalar_kurtosis(x):
    """Excess kurtosis of a 1-D series (used for the CC sanity check,
    BPMF/similarity_search.py:633-642 via scipy.stats.kurtosis)."""
    from scipy.stats import kurtosis as scipy_kurtosis

    return float(scipy_kurtosis(np.asarray(x)))
