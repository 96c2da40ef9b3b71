"""A miniSEED + StationXML world with events of known moment, for the
magnitude path (`data_reader_mseed` -> `extract_windows` with response
removal -> `compute_moment_magnitude` / `approximate_moment_magnitude`).

The tutorial network's width: stations x 3 components (HHN, HHE, HHZ) at
100 Hz, one INT32 miniSEED file per channel in the reader's folder layout
``root/YYYY/JJJ/XX.STA.00.HH?_<date>.mseed``, and one StationXML per
station under ``root/resp/`` carrying the two-pole velocity response of
tests/test_response.py (`POLES`, `ZEROS`, `NORM_FREQ`) with its own
sensitivity.  The stations ring the network's centre at 40-55 km; the
events lie within 6 km of it, 5-12 km deep, one every `spacing_sec`, so
that the S arrival comes more than a 4 s window after the P arrival at
every station.  Each event is a Brune pulse of moment M0 and corner
frequency `fc_circular_crack(Mw, STRESS_DROP_PA)`, built as
tests/test_response.py's `_mw_world` builds one (P on Z, S on N, the
radiation and rho/v corrections of `compute_moment_magnitude`), placed
where the reader's time-shifted windows start, at straight-ray P/S times
(6.0 / 3.5 km/s), and forward-modelled to counts through the station's
response by its own transfer function (not the code under test), over
seeded Gaussian noise.  Everything is drawn from `seed`.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List

import numpy as np

from ..data import Event, Network, Stream, Trace, data_reader_mseed
from ..data.mseed import write_mseed
from ..source.spectrum import fc_circular_crack, magnitude_to_moment
from ..utils.geo import compute_distances
from ..utils.time import epoch_from_utc, sec_to_samp, utc_from_epoch

T0_EPOCH = 1343260800.0        # 2012-07-26T00:00:00
POLES = np.array([-4.44 + 4.44j, -4.44 - 4.44j])
ZEROS = np.array([0.0 + 0.0j, 0.0 + 0.0j])
NORM_FREQ = 5.0
RHO, VP, VS = 2700.0, 6000.0, 3500.0
RAD_P, RAD_S = np.sqrt(4.0 / 15.0), np.sqrt(2.0 / 5.0)
CENTRE = (30.5, 40.5)          # lon, lat
KM_PER_DEG = 111.19
WINDOW_SEC = 4.0               # the windows `extract_windows` reads
OFFSET_SEC = 0.5               # their start before each arrival
SR = 100.0
NOISE_COUNTS = 2.0             # the noise's standard deviation
RECORD_LENGTH = 4096           # bytes a miniSEED record
# the reference fit's gate needs fc >= 0.1 of Nyquist (5 Hz at 100 Hz);
# at 1 MPa the events above Mw ~2.9 fall below it, at 20 MPa none does
STRESS_DROP_PA = 20.0e6


def a0() -> float:
    """Normalization so |pz(NORM_FREQ)| == 1."""
    s = 2j * np.pi * NORM_FREQ
    return float(1.0 / np.abs(np.prod(s - ZEROS) / np.prod(s - POLES)))


def stationxml(station: str, sensitivity: float, network: str = "XX",
               channels=("HHN", "HHE", "HHZ")) -> str:
    """One station's StationXML: each channel the two-pole velocity
    response at `sensitivity` counts/(m/s)."""
    pz = "".join(
        f'<Zero number="{i}"><Real>{float(z.real)!r}</Real>'
        f"<Imaginary>{float(z.imag)!r}</Imaginary></Zero>"
        for i, z in enumerate(ZEROS)) + "".join(
        f'<Pole number="{i}"><Real>{float(p.real)!r}</Real>'
        f"<Imaginary>{float(p.imag)!r}</Imaginary></Pole>"
        for i, p in enumerate(POLES))
    cha = "".join(f"""
   <Channel code="{c}" locationCode="00" startDate="2010-01-01T00:00:00">
    <Response>
     <InstrumentSensitivity>
      <Value>{float(sensitivity)!r}</Value><Frequency>{NORM_FREQ!r}</Frequency>
      <InputUnits><Name>M/S</Name></InputUnits>
      <OutputUnits><Name>COUNTS</Name></OutputUnits>
     </InstrumentSensitivity>
     <Stage number="1">
      <PolesZeros>
       <InputUnits><Name>M/S</Name></InputUnits>
       <OutputUnits><Name>V</Name></OutputUnits>
       <PzTransferFunctionType>LAPLACE (RADIANS/SECOND)</PzTransferFunctionType>
       <NormalizationFactor>{a0()!r}</NormalizationFactor>
       <NormalizationFrequency>{NORM_FREQ!r}</NormalizationFrequency>
       {pz}
      </PolesZeros>
     </Stage>
    </Response>
   </Channel>""" for c in channels)
    return f"""<?xml version="1.0" encoding="UTF-8"?>
<FDSNStationXML xmlns="http://www.fdsn.org/xml/station/1" schemaVersion="1.1">
 <Network code="{network}">
  <Station code="{station}">{cha}
  </Station>
 </Network>
</FDSNStationXML>
"""


def forward_counts(disp: np.ndarray, sr: float,
                   sensitivity: float) -> np.ndarray:
    """Displacement (m) -> counts through the two-pole response, by its
    own transfer function (zero-padded FFT along the last axis)."""
    n = disp.shape[-1]
    nfft = 1
    while nfft < 2 * n:
        nfft *= 2
    s = 2j * np.pi * np.fft.rfftfreq(nfft, d=1.0 / sr)
    with np.errstate(divide="ignore", invalid="ignore"):
        h_vel = a0() * sensitivity * (
            np.prod([s - z for z in ZEROS], axis=0)
            / np.prod([s - p for p in POLES], axis=0))
    h_vel[~np.isfinite(h_vel)] = 0.0
    return np.fft.irfft(np.fft.rfft(disp, nfft) * h_vel * s, nfft)[..., :n]


def brune_pulse(omega0: float, fc: float, sr: float,
                n_win: int) -> np.ndarray:
    """Real window whose displacement spectrum 2|X_k|/n equals
    omega0 / (1 + (f/fc)^2), centred in the window (_mw_world's pulse)."""
    f = np.fft.rfftfreq(n_win, d=1.0 / sr)
    xk = omega0 / (1.0 + (f / fc) ** 2) * n_win / 2.0
    xk = xk * np.exp(-2j * np.pi * f * (n_win / 2) / sr)
    return np.fft.irfft(xk, n_win)


def corrections(dist_km: np.ndarray) -> tuple:
    """(P, S) factors from displacement spectral amplitude to moment, as
    `Spectrum.compute_correction_factor` computes them."""
    r_m = 1000.0 * np.asarray(dist_km)
    base = 4.0 * np.pi * np.sqrt(RHO) * np.sqrt(RHO) * r_m
    return (base * np.sqrt(VP) * VP ** 2.5 / RAD_P,
            base * np.sqrt(VS) * VS ** 2.5 / RAD_S)


@dataclass
class MagnitudeWorld:
    root: str
    network: Network
    events: List[Event]       # each reads through data_reader_mseed
    mw: np.ndarray            # the injected moment magnitudes
    files: List[str]          # the miniSEED files, one per channel
    n_samples: int            # samples in each file
    write_sec: float          # host seconds to write the files


def _window_start(t_epoch: float, sr: float) -> int:
    """The file sample at which the reader's window from `t_epoch` starts
    (`Event.read_waveforms` passes datetime64[ns] to the reader, whose
    `Trace.slice` snaps with `sec_to_samp`)."""
    t = epoch_from_utc(utc_from_epoch(t_epoch))
    return int(sec_to_samp(t - T0_EPOCH, sr=sr))


def build_world(root: str, n_sta: int = 10, n_events: int = 12,
                hours: float = 6.0, spacing_sec: float = 1800.0,
                seed: int = 21) -> MagnitudeWorld:
    """Write the world's files under `root` (created) and return its
    network and events."""
    rng = np.random.default_rng(seed)
    n = int(round(hours * 3600.0 * SR))
    stations = [f"MW{i:02d}" for i in range(n_sta)]
    az = 2.0 * np.pi * (np.arange(n_sta) + rng.uniform(-0.3, 0.3, n_sta)) \
        / n_sta
    r_km = rng.uniform(40.0, 55.0, n_sta)
    lon = CENTRE[0] + r_km * np.cos(az) / (
        KM_PER_DEG * np.cos(np.radians(CENTRE[1])))
    lat = CENTRE[1] + r_km * np.sin(az) / KM_PER_DEG
    network = Network.from_arrays(stations, networks=["XX"] * n_sta,
                                  latitude=lat, longitude=lon,
                                  elevation_m=np.zeros(n_sta))
    sens = rng.uniform(1e8, 4e8, n_sta)
    mw = rng.permutation(np.linspace(2.0, 3.5, n_events))
    e_az = rng.uniform(0.0, 2.0 * np.pi, n_events)
    e_r = 6.0 * np.sqrt(rng.uniform(0.0, 1.0, n_events))
    e_lon = CENTRE[0] + e_r * np.cos(e_az) / (
        KM_PER_DEG * np.cos(np.radians(CENTRE[1])))
    e_lat = CENTRE[1] + e_r * np.sin(e_az) / KM_PER_DEG
    e_dep = rng.uniform(5.0, 12.0, n_events)
    ot = (T0_EPOCH + spacing_sec / 2.0 + spacing_sec * np.arange(n_events)
          + rng.uniform(0.0, 1.0, n_events))
    if ot[-1] + 60.0 > T0_EPOCH + n / SR:
        raise ValueError(f"{n_events} events do not fit in {hours} h")

    # channels N, E, Z of each station, in counts
    counts = rng.standard_normal((n_sta, 3, n), np.float32) * NOISE_COUNTS
    n_win = int(round(WINDOW_SEC * SR))
    pad = n_win // 2
    events = []
    dist = compute_distances(e_lon, e_lat, e_dep, lon, lat,
                             network.depth)           # (n_events, n_sta)
    for e in range(n_events):
        m0 = float(magnitude_to_moment(mw[e]))
        fc = float(fc_circular_crack(mw[e], STRESS_DROP_PA))
        corr_p, corr_s = corrections(dist[e])
        mv = np.stack([dist[e] / (VP / 1000.0), dist[e] / (VS / 1000.0)], 1)
        for s in range(n_sta):
            for c, ph, corr in ((2, 0, corr_p[s]), (0, 1, corr_s[s])):
                i0 = _window_start(ot[e] + mv[s, ph] - OFFSET_SEC, SR)
                seg = np.zeros(n_win + 2 * pad)
                seg[pad: pad + n_win] = brune_pulse(m0 / corr, fc, SR, n_win)
                counts[s, c, i0 - pad: i0 + n_win + pad] += forward_counts(
                    seg, SR, sens[s])
        events.append(Event(
            utc_from_epoch(ot[e]), mv, stations, ["P", "S"],
            data_path=root, latitude=float(e_lat[e]),
            longitude=float(e_lon[e]), depth=float(e_dep[e]),
            sampling_rate=SR, data_reader=data_reader_mseed))

    t0 = time.perf_counter()
    day = os.path.join(root, "2012", "208")
    resp = os.path.join(root, "resp")
    os.makedirs(day, exist_ok=True)
    os.makedirs(resp, exist_ok=True)
    files = []
    for s, sta in enumerate(stations):
        with open(os.path.join(resp, f"XX.{sta}.xml"), "w") as f:
            f.write(stationxml(sta, float(sens[s])))
        for c, comp in enumerate("NEZ"):
            path = os.path.join(day, f"XX.{sta}.00.HH{comp}_20120726.mseed")
            tr = Trace(counts[s, c], station=sta, network="XX",
                       channel=f"HH{comp}", location="00",
                       sampling_rate=SR, starttime=T0_EPOCH)
            write_mseed(Stream([tr]), path, encoding="INT32",
                        record_length=RECORD_LENGTH)
            files.append(path)
    return MagnitudeWorld(root=root, network=network, events=events, mw=mw,
                          files=files, n_samples=n,
                          write_sec=time.perf_counter() - t0)
