"""Displacement spectra and moment magnitudes.

Counterpart of `seismic_bpmf_tpu.source.spectrum` (reference parity:
BPMF/spectrum.py).  The source-parameter chain:

  windows -> displacement spectra (FFT or octave filter bank)
          -> SNR gating vs a noise window
          -> geometrical-spreading + frequency-dependent-Q corrections
          -> masked network-average spectrum
          -> Brune/Boatwright fit -> (M0, fc) -> Mw, stress drop

Without pandas: each spectrum is a `SpectrumTable`, a (rows x frequencies)
float64 array with its row labels and its frequency vector, whose
`to_frame()` builds the JAX package's DataFrame (pandas imported there).
The tapered FFT of `compute_spectrum` runs in float64 on the device of the
call; the octave filter bank (scipy `sosfilt`) and the fit (scipy
`curve_fit`) stay on the host, as in the JAX package.  Station geometry
comes from the numpy `Network`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..ops.picks import PickTable
from ..utils.observe import logger


# ---------------------------------------------------------------------------
# source models and conversions (BPMF/spectrum.py:1180-1287)
# ---------------------------------------------------------------------------

def brune(freqs, omega0, fc, log=False):
    """Brune (1970) displacement spectrum model."""
    if log:
        return np.log10(omega0) - np.log10(1.0 + (freqs / fc) ** 2)
    return omega0 / (1.0 + (freqs / fc) ** 2)


def boatwright(freqs, omega0, fc, log=False):
    """Boatwright (1980) displacement spectrum model."""
    if log:
        return np.log10(omega0) - 0.5 * np.log10(1.0 + (freqs / fc) ** 4)
    return omega0 / np.sqrt(1.0 + (freqs / fc) ** 4)


def magnitude_to_moment(Mw):
    """Mw -> M0 [N.m] (Hanks & Kanamori 1979)."""
    return 10.0 ** (1.5 * np.asarray(Mw) + 9.1)


def moment_to_magnitude(M0):
    """M0 [N.m] -> Mw."""
    return 2.0 / 3.0 * (np.log10(np.asarray(M0)) - 9.1)


def fc_circular_crack(Mw, stress_drop_Pa=1.0e6, phase="p",
                      vs_m_per_s=3500.0, vr_vs_ratio=0.9):
    """Corner frequency of an Eshelby circular crack
    (BPMF/spectrum.py:1206-1247)."""
    phase = phase.lower()
    assert phase in ("p", "s")
    M0 = magnitude_to_moment(Mw)
    radius = ((7.0 / 16.0) * (M0 / stress_drop_Pa)) ** (1.0 / 3.0)
    constant = 2.23 if phase == "p" else 1.47
    vr = vr_vs_ratio * vs_m_per_s
    return (constant * vr) / (2.0 * np.pi * radius)


def stress_drop_circular_crack(Mw, fc, phase="p", vs_m_per_s=3500.0,
                               vr_vs_ratio=0.9):
    """Stress drop of an Eshelby circular crack
    (BPMF/spectrum.py:1249-1287)."""
    phase = phase.lower()
    assert phase in ("p", "s")
    M0 = magnitude_to_moment(Mw)
    constant = 2.23 if phase == "p" else 1.47
    vr = vr_vs_ratio * vs_m_per_s
    radius = constant * vr / (2.0 * np.pi * fc)
    return 7.0 / 16.0 * M0 / radius**3


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

class SpectrumTable:
    """Values on a frequency grid, without pandas.

    `values` is (n_rows, n_freq) with row labels `rows` (the JAX
    package's DataFrame, index=rows, columns=frequencies), or (n_freq,)
    with `rows` None (its Series, index=frequencies).  `to_frame()` builds
    that DataFrame or Series (pandas imported there)."""

    def __init__(self, values, frequencies, rows=None):
        self.values = np.asarray(values)
        self.frequencies = np.asarray(frequencies)
        self.rows = None if rows is None else np.asarray(rows).astype("U")

    @property
    def shape(self):
        return self.values.shape

    def __len__(self) -> int:
        return len(self.values)

    def to_frame(self):
        import pandas as pd

        if self.rows is None:
            return pd.Series(self.values, index=self.frequencies)
        return pd.DataFrame(self.values, index=list(self.rows),
                            columns=self.frequencies)


class Spectrum:
    """Per-phase displacement spectra of one event across a network.

    Spectra are stored as {phase: SpectrumTable(rows=stations or
    channels)}; phases typically ('noise', 'p', 's').
    """

    def __init__(self, event=None, network=None):
        self.event = event
        self.network = network
        self.spectra: Dict[str, SpectrumTable] = {}
        self.snr: Dict[str, SpectrumTable] = {}
        self.correction_flags: Dict[str, Dict[str, bool]] = {}

    # ------------------------------------------------------------------
    # spectra computation
    # ------------------------------------------------------------------
    def _finish_rows(self, amp, stations, components, stack):
        """(n_sta, n_comp, n_freq) per-channel amplitudes -> row block.

        stack=True: RSS over components (one row per station, the
        reference's `multi_component_spectrum=True`); stack=False: one row
        per channel labeled '<sta>.<comp>' (the reference default),
        remembering each row's station for the corrections.
        """
        stations = list(stations)
        if stack:
            rows = stations
            out = np.sqrt(np.sum(np.asarray(amp) ** 2, axis=1))
            self._row_station = np.asarray(stations).astype("U")
        else:
            components = list(components)[: amp.shape[1]]
            rows = [f"{s}.{c}" for s in stations for c in components]
            out = np.asarray(amp)[:, : len(components)].reshape(
                len(rows), -1
            )
            self._row_station = np.asarray(
                [s for s in stations for _ in components]).astype("U")
        return out, rows

    def _per_station(self, values: np.ndarray,
                     stations: np.ndarray) -> np.ndarray:
        """Expand a station-indexed correction (rows in `stations` order)
        onto spectrum rows (identity for stacked spectra, broadcast for
        per-channel rows)."""
        rows = getattr(self, "_row_station", None)
        if rows is None:  # spectra set directly with station-indexed rows
            return values
        index = {s: i for i, s in enumerate(stations)}
        return values[[index[s] for s in rows]]

    def compute_spectrum(
        self,
        windows: Dict[str, np.ndarray],
        stations: Sequence[str],
        sampling_rate: float,
        phases: Sequence[str] = ("noise", "p", "s"),
        taper_pct: float = 5.0,
        stack_components: bool = True,
        components: Sequence[str] = ("N", "E", "Z"),
        device=None,
    ):
        """Amplitude spectra via tapered FFT, in float64 on `device`
        (CUDA unless 'cpu' is asked for).

        windows[phase] : (n_stations, n_components, n_samples) displacement
        windows.  `stack_components=True` RSS-combines components into one
        per-station spectrum (reference `multi_component_spectrum=True`);
        False keeps one row per channel (the reference default).
        Reference parity: BPMF/spectrum.py:507-599.
        """
        from scipy.signal.windows import tukey

        dev = resolve_device(device)
        for phase in phases:
            x = torch.from_numpy(
                np.asarray(windows[phase], np.float64)).to(dev)
            n = x.shape[-1]
            taper = torch.from_numpy(tukey(n, alpha=taper_pct / 100.0)).to(
                dev)
            xf = torch.fft.rfft(x * taper, dim=-1)
            freqs = np.fft.rfftfreq(n, d=1.0 / sampling_rate)
            # displacement amplitude spectral density
            amp = (2.0 * xf.abs() / sampling_rate / n
                   * sampling_rate).cpu().numpy()
            vals, rows = self._finish_rows(
                amp, stations, components, stack_components
            )
            self.spectra[phase] = SpectrumTable(vals, freqs, rows)
        self.frequencies = np.asarray(self.spectra[phases[0]].frequencies,
                                      dtype=float)
        return self.spectra

    def compute_multi_band_spectrum(
        self,
        windows: Dict[str, np.ndarray],
        stations: Sequence[str],
        sampling_rate: float,
        phases: Sequence[str] = ("noise", "p", "s"),
        bands_per_octave: int = 2,
        fmin: float = 0.5,
        fmax: Optional[float] = None,
        stack_components: bool = True,
        components: Sequence[str] = ("N", "E", "Z"),
    ):
        """Octave-filter-bank spectra (Al-Ismail et al. 2022 approach), on
        the host with scipy.

        More robust than the raw FFT at low SNR; reference parity:
        BPMF/spectrum.py:387-505 (`stack_components` maps to the
        reference's `multi_component_spectrum`).
        """
        from scipy.signal import butter, sosfilt

        if fmax is None:
            fmax = 0.45 * sampling_rate
        if getattr(self, "frequency_bands", None) is not None:
            # explicit band edges set via set_frequency_bands (reference
            # parity: BPMF/spectrum.py:889-906)
            edges = [tuple(v) for v in self.frequency_bands.values()]
            centers = np.array([0.5 * (lo + hi) for lo, hi in edges])
        else:
            n_bands = int(np.ceil(np.log2(fmax / fmin) * bands_per_octave))
            centers = fmin * 2.0 ** (np.arange(n_bands) / bands_per_octave)
            centers = centers[centers < fmax]
            half = 2 ** (0.5 / bands_per_octave)
            edges = [(c / half, min(c * half, 0.499 * sampling_rate))
                     for c in centers]
        for phase in phases:
            x = np.asarray(windows[phase], np.float64)
            n_sta, n_comp = x.shape[0], x.shape[1]
            amp = np.zeros((n_sta, n_comp, len(centers)))
            for b, fc_band in enumerate(centers):
                lo, hi = edges[b]
                hi = min(hi, 0.499 * sampling_rate)
                sos = butter(4, [lo, hi], btype="bandpass",
                             fs=sampling_rate, output="sos")
                xf = sosfilt(sos, x, axis=-1)
                # peak amplitude in the band, normalized to spectral
                # density by the bandwidth
                amp[:, :, b] = np.max(np.abs(xf), axis=-1) / (hi - lo)
            vals, rows = self._finish_rows(
                amp, stations, components, stack_components
            )
            self.spectra[phase] = SpectrumTable(vals, centers, rows)
        self.frequencies = centers
        return self.spectra

    def set_target_frequencies(self, freq_min: float, freq_max: float,
                               num_points: int):
        """Log-spaced target frequency grid (reference parity:
        BPMF/spectrum.py:920-941)."""
        self.frequencies = np.logspace(
            np.log10(freq_min), np.log10(freq_max), num_points
        )

    def resample(self, new_frequencies, phase):
        """Interpolate the phase spectra onto `new_frequencies` in place,
        zeroing bins above each spectrum's original bandwidth (reference
        parity: BPMF/spectrum.py:851-887)."""
        new_frequencies = np.asarray(new_frequencies, np.float64)
        phases = [phase] if isinstance(phase, str) else list(phase)
        resampled_any = False
        for ph in phases:
            ph = ph.lower()
            if ph not in getattr(self, "spectra", {}):
                logger.warning("no %s spectrum to resample", ph)
                continue
            resampled_any = True
            spec = self.spectra[ph]
            old_freqs = np.asarray(spec.frequencies, np.float64)
            # 0.99: guard against rounding at the original band edge
            outside = new_frequencies >= 0.99 * old_freqs.max()
            vals = np.stack([
                np.interp(new_frequencies, old_freqs, np.abs(row))
                for row in spec.values
            ])
            vals[:, outside] = 0.0
            self.spectra[ph] = SpectrumTable(vals, new_frequencies,
                                             spec.rows)
        if resampled_any:
            # only re-point the frequency grid when something actually
            # moved onto it, else it desyncs from the stored spectra
            self.frequencies = new_frequencies.astype(np.float32)

    def set_frequency_bands(self, frequency_bands: Dict):
        """Explicit multiband edges {name: (freq_lo, freq_hi)} used by
        `compute_multi_band_spectrum` instead of the octave ladder
        (reference parity: BPMF/spectrum.py:889-906)."""
        self.frequency_bands = frequency_bands

    def compute_signal_to_noise_ratio(
        self, phases: Sequence[str] = ("p", "s"), noise_phase: str = "noise"
    ):
        """Per-frequency SNR vs the noise-window spectrum
        (BPMF/spectrum.py:601-648)."""
        noise = self.spectra[noise_phase].values
        noise = np.where(noise == 0.0, np.nan, noise)
        for phase in phases:
            sig = self.spectra[phase]
            self.snr[phase] = SpectrumTable(sig.values / noise,
                                            sig.frequencies, sig.rows)
        return self.snr

    # ------------------------------------------------------------------
    # propagation corrections (BPMF/spectrum.py:97-256)
    # ------------------------------------------------------------------
    def set_Q_model(self, Q0: float = 300.0, n: float = 0.0,
                    Q_phase_prefactor: Optional[Dict[str, float]] = None):
        """Frequency-dependent attenuation Q(f) = Q0 * f**n."""
        self.Q0 = Q0
        self.Q_exponent = n
        self.Q_phase_prefactor = Q_phase_prefactor or {"p": 1.0, "s": 1.0}

    def _Q_of_f(self, freqs):
        return self.Q0 * np.maximum(np.asarray(freqs, float), 1e-3) ** (
            self.Q_exponent
        )

    def compute_correction_factor(
        self,
        source_receiver_dist_km,
        travel_times: Dict[str, np.ndarray],
        stations: Sequence[str],
        rho_source: float = 2700.0,
        rho_receiver: float = 2700.0,
        vp_source: float = 6000.0,
        vp_receiver: float = 6000.0,
        vs_source: float = 3500.0,
        vs_receiver: float = 3500.0,
        radiation_S: float = np.sqrt(2.0 / 5.0),
        radiation_P: float = np.sqrt(4.0 / 15.0),
    ):
        """Geometrical-spreading factor (converts displacement spectral
        amplitude to seismic moment) and attenuation factor per station:

          corr = 4 pi sqrt(rho_r rho_s) sqrt(v_r) v_s^(5/2) r / radiation
          att(f) = exp(pi tt f / Q(f))

        `source_receiver_dist_km` and `travel_times` ({'P': s, 'S': s})
        are arrays in `stations` order (the JAX package takes them as a
        station-indexed Series and DataFrame).  Reference parity:
        BPMF/spectrum.py:97-200.
        """
        stations = np.asarray(stations).astype("U")
        dist = np.asarray(source_receiver_dist_km, np.float64)
        # keep the geometry inputs so update_Q_model can refresh the
        # attenuation factor without re-passing them
        self._corr_inputs = dict(
            source_receiver_dist_km=dist, travel_times=travel_times,
            stations=stations, rho_source=rho_source,
            rho_receiver=rho_receiver, vp_source=vp_source,
            vp_receiver=vp_receiver, vs_source=vs_source,
            vs_receiver=vs_receiver, radiation_S=radiation_S,
            radiation_P=radiation_P,
        )
        geom = {}
        att: Dict[str, SpectrumTable] = {}
        freqs = self.frequencies
        for phase, v_s, v_r, rad in (
            ("p", vp_source, vp_receiver, radiation_P),
            ("s", vs_source, vs_receiver, radiation_S),
        ):
            corr = (
                4.0 * np.pi
                * np.sqrt(rho_receiver) * np.sqrt(rho_source)
                * np.sqrt(v_r) * v_s ** 2.5
                * (1000.0 * dist)
                / rad
            )
            geom[f"geometry_{phase}"] = corr
            if hasattr(self, "Q0"):
                q = (self._Q_of_f(freqs)
                     * self.Q_phase_prefactor.get(phase, 1.0))
                tts = np.asarray(travel_times[phase.upper()], np.float64)
                att[phase] = SpectrumTable(
                    np.exp(np.pi * tts[:, None] * freqs[None, :] / q[None, :]),
                    freqs, stations,
                )
        self.geometrical_factor = PickTable(stations, geom)
        self.attenuation_factor = att

    def update_Q_model(self, Q0: float, n: float = 0.0,
                       Q_phase_prefactor: Optional[Dict[str, float]] = None):
        """Change the attenuation model and refresh the attenuation
        factor (reference parity: BPMF/spectrum.py `update_Q_model` /
        `update_attenuation_factor`).  Requires a prior
        `compute_correction_factor` call; spectra already corrected with
        the old model are NOT rewound (same as the reference)."""
        self.set_Q_model(Q0=Q0, n=n, Q_phase_prefactor=Q_phase_prefactor)
        if hasattr(self, "_corr_inputs"):
            self.compute_correction_factor(**self._corr_inputs)

    update_attenuation_factor = update_Q_model

    def correct_geometrical_spreading(self, phases=("p", "s")):
        for phase in phases:
            flags = self.correction_flags.setdefault(phase, {})
            if flags.get("geometry", False):
                continue
            g = self._per_station(
                self.geometrical_factor[f"geometry_{phase}"],
                self.geometrical_factor.stations,
            )
            spec = self.spectra[phase]
            self.spectra[phase] = SpectrumTable(
                spec.values * g[:, None], spec.frequencies, spec.rows)
            flags["geometry"] = True

    def correct_attenuation(self, phases=("p", "s")):
        for phase in phases:
            flags = self.correction_flags.setdefault(phase, {})
            if flags.get("attenuation", False):
                continue
            att = self.attenuation_factor[phase]
            spec = self.spectra[phase]
            if not np.array_equal(att.frequencies, spec.frequencies):
                raise ValueError(
                    f"the {phase} spectra and the attenuation factor lie on "
                    "different frequency grids; call "
                    "compute_correction_factor after changing the grid"
                )
            self.spectra[phase] = SpectrumTable(
                spec.values * self._per_station(att.values, att.rows),
                spec.frequencies, spec.rows,
            )
            flags["attenuation"] = True

    # ------------------------------------------------------------------
    # network average + fitting
    # ------------------------------------------------------------------
    def compute_network_average_spectrum(
        self, phase: str, snr_threshold: float = 3.0,
        min_num_valid_channels: int = 3,
    ):
        """SNR-masked log-average spectrum (BPMF/spectrum.py:258-385)."""
        spec = self.spectra[phase]
        if phase in self.snr:
            mask = self.snr[phase].values >= snr_threshold
        else:
            mask = np.ones(spec.shape, dtype=bool)
        mask = mask & (spec.values > 0)
        count = mask.sum(axis=0)
        # explicit all-masked handling: log/nanmean only over frequencies
        # with at least one valid channel (no empty-slice warnings)
        avg = np.full(spec.shape[1], np.nan)
        live = count > 0
        if live.any():
            with np.errstate(invalid="ignore", divide="ignore"):
                logs = np.where(mask[:, live], np.log(spec.values[:, live]),
                                np.nan)
            avg[live] = np.exp(np.nanmean(logs, axis=0))
        avg[count < min_num_valid_channels] = np.nan
        self.average_spectrum = SpectrumTable(avg, spec.frequencies)
        self.num_valid_channels = SpectrumTable(count, spec.frequencies)
        return self.average_spectrum

    def plot_spectrum(self, phase: str, ax=None, figsize=(8, 6), **kwargs):
        """Log-log per-channel amplitude spectra for one phase
        (reference parity: BPMF/spectrum.py `plot_spectrum`)."""
        from ..viz.plots import _plt

        if ax is None:
            fig, ax = _plt().subplots(figsize=figsize)
        else:
            fig = ax.get_figure()
        spec = self.spectra[phase.lower()]
        for row, values in zip(spec.rows, spec.values):
            ax.loglog(spec.frequencies, values, lw=0.7, label=str(row),
                      **kwargs)
        ax.set_xlabel("Frequency (Hz)")
        ax.set_ylabel("Amplitude spectrum")
        ax.legend(fontsize=6, ncol=2, loc="lower left")
        return fig

    def plot_average_spectrum(self, ax=None, figsize=(8, 6), **kwargs):
        """Log-log network-average spectrum with the model fit overlaid
        when available (reference parity: BPMF/spectrum.py
        `plot_average_spectrum`)."""
        from ..viz.plots import _plt

        if ax is None:
            fig, ax = _plt().subplots(figsize=figsize)
        else:
            fig = ax.get_figure()
        avg = self.average_spectrum
        ax.loglog(avg.frequencies, avg.values, color="k", lw=1.2,
                  label="network average", **kwargs)
        if getattr(self, "fit_success", False):
            f = np.asarray(avg.frequencies, np.float64)
            model = getattr(self, "model_name", "brune")
            fn = brune if model == "brune" else boatwright
            ax.loglog(f, fn(f, self.M0, self.fc), "--", color="C3",
                      label=f"{model} fit (fc={self.fc:.2f} Hz)")
        ax.set_xlabel("Frequency (Hz)")
        ax.set_ylabel("Amplitude spectrum")
        ax.legend(loc="lower left")
        return fig

    def _scale(self, phase: str, average: bool, angular: bool, op):
        phase = phase.lower()
        table = self.average_spectrum if average else self.spectra[phase]
        f = np.asarray(table.frequencies, np.float64)
        scale = (2.0 * np.pi * f) if angular else f
        with np.errstate(divide="ignore", invalid="ignore"):
            out = SpectrumTable(op(table.values, scale), table.frequencies,
                                table.rows)
        if average:
            self.average_spectrum = out
        else:
            self.spectra[phase] = out

    def integrate(self, phase: str, average: bool = False,
                  angular: bool = False):
        """Integrate the amplitude spectrum in place: divide by frequency
        (reference parity: BPMF/spectrum.py:650-688, which divides by f;
        `angular=True` uses the physically standard 2*pi*f instead)."""
        self._scale(phase, average, angular, np.divide)

    def differentiate(self, phase: str, average: bool = False,
                      angular: bool = False):
        """Differentiate the amplitude spectrum in place: multiply by
        frequency (reference parity: BPMF/spectrum.py:689-727)."""
        self._scale(phase, average, angular, np.multiply)

    def fit_average_spectrum(
        self,
        model: str = "brune",
        min_fraction_valid_points: float = 0.5,
        min_fraction_valid_points_below_fc: float = 0.10,
        weighted: bool = False,
    ):
        """Least-squares (log-domain) fit of (omega0, fc) with the
        reference's validity gates (BPMF/spectrum.py:729-849):

        - enough valid (SNR-passing) frequency points overall;
        - after the fit, enough valid points BELOW the fitted corner
          frequency (otherwise the low-frequency plateau — hence M0 —
          is unconstrained);
        - first guesses: omega0 from the lowest valid frequency, fc from
          the circular-crack relation at that moment;
        - optional sigmoid weighting by the per-frequency valid-channel
          count (`weighted=True`).
        """
        from scipy.optimize import curve_fit

        avg = self.average_spectrum
        valid = ~np.isnan(avg.values) & (avg.values > 0)
        freqs = np.asarray(avg.frequencies, float)[valid]
        amps = avg.values[valid]
        self.fit_success = False
        if valid.sum() < max(3, min_fraction_valid_points * len(avg)):
            return None
        model_fn = brune if model == "brune" else boatwright
        self.model_name = model
        w0_guess = float(amps[0])
        fc_guess = float(
            fc_circular_crack(moment_to_magnitude(max(w0_guess, 1e-30)))
        )
        fc_guess = float(np.clip(fc_guess, freqs[0], freqs[-1]))
        sigma = None
        if weighted and hasattr(self, "num_valid_channels"):
            nvc = self.num_valid_channels.values.astype(float)[valid]
            z = (nvc - nvc.mean()) / max(nvc.mean(), 1e-30)
            sigma = 1.0 + np.exp(-z)  # inverse sigmoid weights
        try:
            popt, pcov = curve_fit(
                lambda f, w0, fc: model_fn(f, w0, fc, log=True),
                freqs,
                np.log10(amps),
                p0=[w0_guess, fc_guess],
                sigma=sigma,
                bounds=([0.0, freqs[0] / 10.0],
                        [np.inf, max(freqs[-1] * 10.0, 1e3 * fc_guess)]),
                maxfev=10000,
            )
        except (RuntimeError, ValueError):
            return None
        # low-frequency plateau gate: the fitted fc must leave enough
        # valid points below it for M0 to be constrained
        frac_below = float(np.sum(freqs < popt[1])) / float(len(avg))
        if frac_below < min_fraction_valid_points_below_fc:
            return None
        self.M0 = float(popt[0])
        self.fc = float(popt[1])
        perr = np.sqrt(np.diag(pcov))
        self.M0_err = float(perr[0])
        self.fc_err = float(perr[1])
        self.Mw = float(moment_to_magnitude(self.M0))
        self.fit_success = True
        return self.M0, self.fc


# ---------------------------------------------------------------------------
# workflow functions (BPMF/spectrum.py:1500-2009)
# ---------------------------------------------------------------------------

def _condition_window_arr(
    event,
    duration_sec: float,
    attach_response: bool,
    integrate_to_displacement,
    taper_percentage: float,
    water_level_db: float,
    pre_filt,
    device=None,
):
    """Detrend (constant + linear), cosine-taper, and convert the event's
    current traces to displacement — by instrument-response deconvolution
    on `device` when responses are attached, by time integration otherwise
    (reference post-processing: BPMF/spectrum.py:1600-1619)."""
    from scipy.signal.windows import tukey

    from ..ops.response import remove_response_arr

    sr = event.sr
    arr = np.asarray(event.waveforms_arr, np.float64)
    n = arr.shape[-1]
    t = np.arange(n) - (n - 1) / 2.0
    arr = arr - arr.mean(axis=-1, keepdims=True)
    slope = (arr * t).sum(axis=-1, keepdims=True) / (t * t).sum()
    arr = arr - slope * t
    # obspy taper(p, type='cosine') ramps over p of the trace at each end
    arr = arr * tukey(n, min(2.0 * taper_percentage, 1.0))

    resp_map = {}
    for tr in event.traces:
        if getattr(tr.stats, "response", None) is not None:
            resp_map[(tr.stats.station, tr.stats.component)] = (
                tr.stats.response
            )
    aliases = getattr(event, "component_aliases", None) or {}
    if attach_response and resp_map:
        if pre_filt is None:
            fnyq = sr / 2.0
            pre_filt = [1.0 / duration_sec, 1.05 / duration_sec,
                        0.95 * fnyq, 0.98 * fnyq]
        responses = []
        for sta in event.stations:
            for c in event.components:
                r = resp_map.get((sta, c))
                if r is None:
                    for alias in aliases.get(c, [c]):
                        r = resp_map.get((sta, alias))
                        if r is not None:
                            break
                responses.append(r)
        arr = np.asarray(
            remove_response_arr(
                arr.astype(np.float32), responses, sr, output="DISP",
                pre_filt=pre_filt, water_level_db=water_level_db,
                device=device,
            ),
            np.float64,
        )
        # channels with NO matched response would stay raw counts while
        # the rest are deconvolved to meters — an ~1e8 unit mismatch that
        # silently pollutes the network-average spectrum.  Zero them out
        # instead (they then fail the SNR gates and drop from the fit)
        # and say so.  Reference behavior: obspy remove_response raises
        # on a missing response, failing the whole event.
        pairs = [(s, c) for s in event.stations for c in event.components]
        missing = [pairs[i] for i, r in enumerate(responses) if r is None]
        if missing:
            logger.warning(
                "no instrument response for %s — zeroing those channels "
                "out of the spectral windows", missing,
            )
            arr3 = arr.reshape(len(event.stations),
                               len(event.components), -1)
            for sta, c in missing:
                arr3[list(event.stations).index(sta),
                     list(event.components).index(c)] = 0.0
    elif integrate_to_displacement or integrate_to_displacement is None:
        arr = np.cumsum(arr, axis=-1) / sr
        arr = arr - arr.mean(axis=-1, keepdims=True)
    return arr.astype(np.float32)


def extract_windows(
    event,
    duration_sec: Optional[float] = None,
    offset_ot_sec_noise: Optional[float] = None,
    attach_response: bool = False,
    phase_on_comp_p: Optional[Dict[str, str]] = None,
    phase_on_comp_s: Optional[Dict[str, str]] = None,
    offset_phase: Optional[Dict[str, float]] = None,
    integrate_to_displacement=None,
    taper_percentage: float = 0.25,
    water_level_db: float = 60.0,
    pre_filt=None,
    data_reader=None,
    phase_window_sec: Optional[Dict[str, float]] = None,
    noise_window_sec: float = 5.0,
    device=None,
    **reader_kwargs,
):
    """Extract {'noise', 'p', 's'} displacement windows for one event.

    Faithful to the reference's three-stage extraction
    (BPMF/spectrum.py:1500-1619): the noise window is a fixed absolute
    window starting `offset_ot_sec_noise` seconds after the origin time
    (negative = before, ending before the first P arrival); the P and S
    windows are positioned **per station** at
    ``origin_time + moveout_phase(station) - offset_phase[phase]``.  Each
    window is detrended, cosine-tapered, and converted to displacement —
    via instrument-response deconvolution (`ops.response`, on `device`:
    CUDA unless 'cpu' is asked for) when `attach_response` and responses
    are available, else by integrating the (velocity) traces.

    Two modes:
      - reader mode (the event has a `data_reader`, the production path):
        three `Event.read_waveforms` calls exactly like the reference;
      - array mode (pre-read traces only): windows are sliced from the
        already-loaded traces using the same per-station arrival-time
        formula relative to the recorded read offsets.

    Returns float32 arrays keyed by phase, shape (n_stations,
    n_components, n_samples), all with the same sample count (the spectra
    share one frequency grid, like the reference's common `duration_sec`).
    """
    from ..data.events import DEFAULT_PHASE_ON_COMP
    from ..utils.time import sec_to_samp

    device = resolve_device(device)
    phase_window_sec = phase_window_sec or {"p": 3.0, "s": 5.0}
    if duration_sec is None:
        duration_sec = max(phase_window_sec.values())
    if offset_ot_sec_noise is None:
        offset_ot_sec_noise = -(duration_sec + 1.0)
    phase_on_comp_p = phase_on_comp_p or {
        c: "P" for c in ("N", "1", "E", "2", "Z")
    }
    phase_on_comp_s = phase_on_comp_s or {
        c: "S" for c in ("N", "1", "E", "2", "Z")
    }
    offset_phase = dict(offset_phase or {"P": 0.5, "S": 0.5})
    reader = data_reader or getattr(event, "data_reader", None)

    def cond():
        return _condition_window_arr(
            event, duration_sec, attach_response, integrate_to_displacement,
            taper_percentage, water_level_db, pre_filt, device=device,
        )

    if reader is not None:
        windows = {}
        event.read_waveforms(
            duration_sec, time_shifted=False,
            offset_ot=-offset_ot_sec_noise, data_reader=reader,
            attach_response=attach_response, **reader_kwargs,
        )
        windows["noise"] = cond()
        for key, phase_on_comp in (("p", phase_on_comp_p),
                                   ("s", phase_on_comp_s)):
            event.read_waveforms(
                duration_sec, phase_on_comp=phase_on_comp,
                offset_phase=offset_phase, time_shifted=True,
                data_reader=reader, attach_response=attach_response,
                **reader_kwargs,
            )
            windows[key] = cond()
        return windows

    # array mode: slice per-station windows from the pre-read traces
    sr = event.sr
    arr = cond()
    n = arr.shape[-1]
    n_win = min(int(sec_to_samp(duration_sec, sr=sr)), n)
    n_noise = min(int(sec_to_samp(noise_window_sec, sr=sr)), n)
    aux = getattr(event, "aux_data", {}) or {}
    mv = event.moveouts_table()
    col = {p.upper(): i for i, p in enumerate(event.phases)}

    def arrival_in_trace(s, comp, target_phase):
        """Seconds into the (station s, comp) trace of `target_phase`'s
        arrival, from the read's recorded alignment (the trace starts at
        ``arrival(ph_c) - offset_{ph_c}`` after a time-shifted read)."""
        ph_c = str(
            aux.get(f"phase_on_comp{comp}",
                    DEFAULT_PHASE_ON_COMP.get(comp, "P"))
        ).upper()
        off_c = float(aux.get(f"offset_{ph_c}", 1.0))
        d_mv = 0.0
        if target_phase in col and ph_c in col:
            d_mv = float(mv[s, col[target_phase]]) - float(mv[s, col[ph_c]])
        return off_c + d_mv

    n_sta, n_comp = arr.shape[0], arr.shape[1]
    out = {
        "noise": np.zeros((n_sta, n_comp, n_noise), np.float32),
        "p": np.zeros((n_sta, n_comp, n_win), np.float32),
        "s": np.zeros((n_sta, n_comp, n_win), np.float32),
    }
    for s in range(len(event.stations)):
        for c, comp in enumerate(event.components):
            starts = {}
            for ph in ("P", "S"):
                t_arr = arrival_in_trace(s, comp, ph)
                starts[ph] = int(
                    sec_to_samp(t_arr - offset_phase[ph], sr=sr)
                )
            first = min(starts.values())
            i0 = max(0, min(first, n) - n_noise)
            out["noise"][s, c] = arr[s, c, i0 : i0 + n_noise]
            for key, ph in (("p", "P"), ("s", "S")):
                i0 = int(np.clip(starts[ph], 0, n - n_win))
                out[key][s, c] = arr[s, c, i0 : i0 + n_win]
    n_min = min(w.shape[-1] for w in out.values())
    return {k: v[..., :n_min] for k, v in out.items()}


def _geometry(event, network, stations, vp: float, vs: float):
    """Hypocentral distances (km) of `stations` and their straight-ray
    P/S travel times (s), in `stations` order."""
    from ..utils.geo import compute_distances

    idx = network.stations_idx(stations)
    dist = compute_distances(
        [event.longitude], [event.latitude], [event.depth],
        network.longitude[idx], network.latitude[idx], network.depth[idx],
    )[0]
    return dist, {"P": dist / (vp / 1000.0), "S": dist / (vs / 1000.0)}


def compute_moment_magnitude(
    event,
    network,
    windows: Optional[Dict[str, np.ndarray]] = None,
    method: str = "regular",
    model: str = "brune",
    Q0: float = 300.0,
    Q_exponent: float = 0.0,
    rho: float = 2700.0,
    vp: float = 6000.0,
    vs: float = 3500.0,
    snr_threshold: float = 3.0,
    device=None,
):
    """Full Mw workflow on one event (BPMF/spectrum.py:1622-2009).

    Returns the `Spectrum` instance (with .Mw/.M0/.fc when the fit
    succeeds) and stores Mw in the event's aux_data.  The windows (when
    not given) and the FFT spectra are computed on `device` (CUDA unless
    'cpu' is asked for).
    """
    if windows is None:
        windows = extract_windows(event, device=device)
    stations = list(event.stations)
    spec = Spectrum(event=event, network=network)
    if method == "regular":
        spec.compute_spectrum(windows, stations, event.sr, device=device)
    else:
        spec.compute_multi_band_spectrum(windows, stations, event.sr)
    spec.compute_signal_to_noise_ratio()
    # source-receiver distances + travel times for corrections
    dist, tts = _geometry(event, network, stations, vp, vs)
    spec.set_Q_model(Q0=Q0, n=Q_exponent)
    spec.compute_correction_factor(
        dist, tts, stations, rho_source=rho, rho_receiver=rho,
        vp_source=vp, vp_receiver=vp, vs_source=vs, vs_receiver=vs,
    )
    spec.correct_geometrical_spreading()
    spec.correct_attenuation()
    Mws = []
    for phase in ("p", "s"):
        spec.compute_network_average_spectrum(
            phase, snr_threshold=snr_threshold
        )
        fit = spec.fit_average_spectrum(model=model)
        if fit is not None:
            Mws.append(spec.Mw)
    if Mws:
        Mw = float(np.mean(Mws))
        event.set_aux_data({"Mw": Mw})
        spec.Mw = Mw
    return spec


def snr_based_weights(snr, snr_threshold, weight_max: float = 3.0,
                      max_num_bad_measurements: int = 6):
    """Station weights from peak SNR (BPMF/spectrum.py:1290-1339).

    Weights equal the SNR clipped at ``1.001 * snr_threshold`` and at
    ``weight_max``.  With enough good channels every sub-threshold channel
    gets weight 0; otherwise the best `max_num_bad_measurements` channels
    are kept so a (degraded) estimate is still possible.
    """
    snr = np.asarray(snr, np.float64)
    weights = np.minimum(
        np.minimum(snr, 1.001 * snr_threshold), weight_max
    )
    if np.sum(snr >= snr_threshold) >= max_num_bad_measurements:
        weights = np.where(snr < snr_threshold, 0.0, weights)
    else:
        order = np.argsort(snr)
        if len(order) > max_num_bad_measurements:
            weights[order[:-max_num_bad_measurements]] = 0.0
    return weights


def approximate_moment_magnitude(
    event,
    network,
    windows: Optional[Dict[str, np.ndarray]] = None,
    snr_threshold: float = 2.0,
    num_averaging_bands: int = 1,
    low_snr_freq_min_hz: float = 2.0,
    weight_max: float = 3.0,
    max_num_bad_measurements: int = 6,
    phases: Sequence[str] = ("s",),
    fmin: float = 0.5,
    bands_per_octave: int = 2,
    Q0: float = 300.0,
    Q_exponent: float = 0.0,
    rho: float = 2700.0,
    vp: float = 6000.0,
    vs: float = 3500.0,
    device=None,
):
    """Mw* from the low-frequency plateau without spectral fitting.

    Applies the same propagation corrections as the full chain, then
    measures log10(M0) station by station — the lowest
    `num_averaging_bands` SNR-valid bands when any exist, else the
    SNR-weighted log-mean over bands above `low_snr_freq_min_hz` — and
    averages the per-station logs with `snr_based_weights` times inverse
    interquartile-clipped source distance.  Reference parity:
    BPMF/spectrum.py:1341-1496 (the SNR/distance-weighted lowest-band
    Mw*).  `device` serves `extract_windows` when no windows are given.
    """
    from ..utils.geo import compute_distances

    if windows is None:
        windows = extract_windows(event, device=device)
    stations = list(event.stations)
    s = Spectrum(event=event, network=network)
    # the reference's Mw* consumes octave multi-band spectra (robust at
    # low SNR and naturally band-limited above the deconvolution
    # high-pass), not the raw FFT (BPMF/spectrum.py:1341-1412 docstring)
    s.compute_multi_band_spectrum(
        windows, stations, event.sr, fmin=fmin,
        bands_per_octave=bands_per_octave,
    )
    s.compute_signal_to_noise_ratio()
    dist, tts = _geometry(event, network, stations, vp, vs)
    s.set_Q_model(Q0=Q0, n=Q_exponent)
    s.compute_correction_factor(
        dist, tts, stations, rho_source=rho, rho_receiver=rho,
        vp_source=vp, vp_receiver=vp, vs_source=vs, vs_receiver=vs,
    )
    s.correct_geometrical_spreading()
    s.correct_attenuation()
    # inverse interquartile-clipped EPICENTRAL distance weights (shared by
    # all phases; reference BPMF/spectrum.py:1474-1482 uses
    # source_receiver_epicentral_dist, not the hypocentral distance that
    # drives the travel-time corrections)
    idx = network.stations_idx(stations)
    epi = compute_distances(
        [event.longitude], [event.latitude], [0.0],
        network.longitude[idx], network.latitude[idx], np.zeros(len(idx)),
    )[0]
    d_clip = np.clip(epi, np.percentile(epi, 25.0),
                     np.percentile(epi, 75.0))
    dist_w = 1.0 / d_clip

    mws = {}
    for ph in phases:
        disp = s.spectra[ph]
        snr = s.snr[ph]
        freqs = np.asarray(disp.frequencies, np.float64)
        measured = np.zeros(len(disp), np.float64)
        m_snr = np.zeros(len(disp), np.float64)
        for j in range(len(disp)):
            d_row = disp.values[j].astype(np.float64)
            s_row = np.nan_to_num(snr.values[j].astype(np.float64))
            ok = np.isfinite(d_row) & (d_row > 0)
            valid = ok & (s_row > snr_threshold)
            if valid.any():
                # lowest valid bands reflect the physical seismic moment
                sel = np.flatnonzero(valid)[:num_averaging_bands]
                measured[j] = float(np.median(d_row[sel]))
                m_snr[j] = snr_threshold
            else:
                hf = ok & (freqs > low_snr_freq_min_hz)
                if not hf.any():
                    continue
                w_ = s_row[hf]
                sum_ = w_.sum() or 1.0
                measured[j] = 10.0 ** (
                    (w_ * np.log10(d_row[hf])).sum() / sum_
                )
                m_snr[j] = (w_ * s_row[hf]).sum() / sum_
        m_snr[measured == 0.0] = 0.0
        weights = snr_based_weights(
            m_snr, snr_threshold, weight_max=weight_max,
            max_num_bad_measurements=max_num_bad_measurements,
        )
        weights = weights * s._per_station(dist_w, stations)
        usable = (weights > 0) & (measured > 0)
        if not usable.any():
            continue
        log10_m0 = (
            (weights[usable] * np.log10(measured[usable])).sum()
            / weights[usable].sum()
        )
        mws[ph] = float(moment_to_magnitude(10.0 ** log10_m0))
    if not mws:
        return None
    Mw = mws.get("s", float(np.mean(list(mws.values()))))
    event.set_aux_data({"Mw_star": Mw})
    return Mw
