"""Instrument-response deconvolution (frequency domain, on the device).

Counterpart of `seismic_bpmf_tpu.ops.response`.  The reference removes
responses through obspy's `Trace.remove_response` (BPMF/spectrum.py:
1600-1619: cosine `pre_filt` band taper + water-level spectrum inversion
+ unit conversion to displacement).  The inverse filter is built on the
host in numpy from a `data.stationxml.ChannelResponse` (poles/zeros, a few
dozen scalars), as in the JAX package; the O(n log n) work (rfft,
spectrum multiply, irfft) runs on the device of the call with
`torch.fft`, batched over channels, in float32/complex64 as the JAX
package's jitted program runs it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device

__all__ = [
    "cosine_sac_taper",
    "invert_spectrum_water_level",
    "build_inverse_filter",
    "apply_spectral_filter",
    "remove_response_arr",
    "remove_response_stream",
]


def cosine_sac_taper(freqs: np.ndarray, flimits) -> np.ndarray:
    """SAC-style cosine band taper over (f1, f2, f3, f4): zero outside
    [f1, f4], one inside [f2, f3], cosine ramps between (the obspy
    `pre_filt` convention used by the reference's window extraction,
    BPMF/spectrum.py:1602-1607)."""
    f1, f2, f3, f4 = map(float, flimits)
    f = np.asarray(freqs, float)
    taper = np.zeros_like(f)
    if f2 > f1:
        left = (f1 <= f) & (f <= f2)
        taper[left] = 0.5 * (
            1.0 + np.cos(np.pi * (f2 - f[left]) / (f2 - f1))
        )
    if f4 > f3:
        right = (f3 <= f) & (f <= f4)
        taper[right] = 0.5 * (
            1.0 + np.cos(np.pi * (f[right] - f3) / (f4 - f3))
        )
    taper[(f2 <= f) & (f <= f3)] = 1.0
    return taper


def invert_spectrum_water_level(
    spec: np.ndarray, water_level_db: Optional[float] = 60.0
) -> np.ndarray:
    """1/spec with obspy's water-level regularization: spectrum values
    whose modulus falls below ``max|spec| * 10**(-wl/20)`` are raised to
    that level (phase preserved; exact zeros get the level with zero
    phase) before inversion."""
    spec = np.asarray(spec, complex).copy()
    if water_level_db is not None:
        absspec = np.abs(spec)
        swamp = absspec.max() * 10.0 ** (-float(water_level_db) / 20.0)
        low = absspec < swamp
        zero = absspec == 0.0
        fix = low & ~zero
        spec[fix] = swamp * spec[fix] / absspec[fix]
        spec[zero] = swamp
    out = np.zeros_like(spec)
    nz = spec != 0.0
    out[nz] = 1.0 / spec[nz]
    return out


def build_inverse_filter(
    response,
    n_samples: int,
    sr: float,
    output: str = "DISP",
    pre_filt: Optional[Sequence[float]] = None,
    water_level_db: Optional[float] = 60.0,
) -> Tuple[np.ndarray, int]:
    """Inverse instrument filter sampled on the rfft grid.

    Returns (complex64 filter of length nfft//2+1, nfft) with nfft the
    zero-padded FFT length (next power of two >= 2 * n_samples, matching
    obspy's `_npts2nfft` padding so the deconvolution's circular wrap
    falls in the pad)."""
    nfft = 1
    while nfft < 2 * int(n_samples):
        nfft *= 2
    freqs = np.fft.rfftfreq(nfft, d=1.0 / sr)
    h = response.transfer_function(freqs, output=output)
    inv = invert_spectrum_water_level(h, water_level_db)
    if pre_filt is not None:
        inv = inv * cosine_sac_taper(freqs, pre_filt)
    return inv.astype(np.complex64), nfft


def apply_spectral_filter(x, filt, nfft: int, device=None) -> torch.Tensor:
    """rfft -> multiply -> irfft over the trailing axis in float32 /
    complex64 on `device` (CUDA unless 'cpu' is asked for); `filt`
    broadcasts against the leading axes of `x`.  Counts its calls on a
    CUDA device in `apply_spectral_filter.launches`."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    filt = torch.from_numpy(np.ascontiguousarray(filt, np.complex64)).to(dev)
    n_out = x.shape[-1]
    spec = torch.fft.rfft(x, n=nfft, dim=-1)
    y = torch.fft.irfft(spec * filt, n=nfft, dim=-1)[..., :n_out]
    if dev.type == "cuda":
        apply_spectral_filter.launches += 1
    return y


apply_spectral_filter.launches = 0


def remove_response_arr(
    arr: np.ndarray,
    responses,
    sr: float,
    output: str = "DISP",
    pre_filt: Optional[Sequence[float]] = None,
    water_level_db: Optional[float] = 60.0,
    device=None,
) -> np.ndarray:
    """Batched deconvolution of an (..., n_channels, n_samples) array.

    `responses` is a flat sequence of `ChannelResponse` (or None) of
    length n_channels x leading dims, in C order; channels without a
    response come back unchanged.  The filters run on `device` (CUDA
    unless 'cpu' is asked for); the result is a float32 host array."""
    arr = np.asarray(arr, np.float32)
    lead = arr.shape[:-1]
    n = arr.shape[-1]
    flat = arr.reshape(-1, n)
    responses = list(responses)
    if len(responses) != flat.shape[0]:
        raise ValueError(
            f"{flat.shape[0]} channels but {len(responses)} responses"
        )
    nfft = None
    built = []
    for r in responses:
        if r is None:
            built.append(None)
            continue
        f, nfft = build_inverse_filter(
            r, n, sr, output=output, pre_filt=pre_filt,
            water_level_db=water_level_db,
        )
        built.append(f)
    if nfft is None:
        return arr
    unity = np.zeros(nfft // 2 + 1, np.complex64)
    bank = np.stack([f if f is not None else unity for f in built])
    out = apply_spectral_filter(flat, bank, nfft, device=device).cpu().numpy()
    for i, f in enumerate(built):
        if f is None:
            out[i] = flat[i]
    return out.reshape(*lead, n)


def remove_response_stream(
    stream,
    inventory=None,
    output: str = "DISP",
    pre_filt: Optional[Sequence[float]] = None,
    water_level_db: Optional[float] = 60.0,
    device=None,
) -> int:
    """Deconvolve every trace in a Stream in place using
    ``tr.stats.response`` (attaching from `inventory` first when given).
    Returns the number of traces deconvolved; traces without a response
    are left untouched."""
    if inventory is not None:
        inventory.attach(stream)
    n_done = 0
    for tr in stream:
        r = tr.stats.response
        if r is None:
            continue
        filt, nfft = build_inverse_filter(
            r, len(tr.data), tr.stats.sampling_rate, output=output,
            pre_filt=pre_filt, water_level_db=water_level_db,
        )
        tr.data = apply_spectral_filter(
            tr.data[None, :], filt[None, :], nfft, device=device
        )[0].cpu().numpy()
        n_done += 1
    return n_done
