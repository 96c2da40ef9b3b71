"""The year bank's world: BASELINE config 4 as the JAX package's
`scripts/year_scan.py` defines it (`build_world` :31-74, `build_bank`
:77-107), through `seismic_bpmf_tpu_torch/tools/year_world.py` (frozen
here from commit 8978ca3), with the bank made of distinct templates.

Kept from the tool: 10 stations x 3 components (N, E, Z) at 25 Hz on the
script's coordinates, days of `day_sec` s stamped 2012-07-26, Gaussian
noise of 0.05, bursts of peak 4 and 1.5 s, P on Z and S on N and E,
templates of 8 s read 1 s before P and 2 s before S, `Config(
template_len_sec=8, n_dev_mf_threshold=8, data_buffer_sec=0)`.

Changed (the configuration's `assumed`): the script copies two events'
templates 1024 times; here every template is cut from an event of its own,
with its own source (so its own moveouts, straight rays at 6.0 / 3.4 km/s
from a point drawn under the network, referred to 2 s before its first P)
and its own waveform (a burst band-limited to `band_hz` drawn for each
channel).  A template is its event's signal plus the noise of the record
it was cut from.  The script serves one day; here a pool of days is drawn,
and each holds `events_per_template` repeats of every template's event at
origins drawn from the seed, one in each equal part of the day, so every
template detects that many events a day (the script's 2,048 a day at two).

Large arrays are drawn on `device` by a `torch.Generator` seeded with the
run's seed; the sources and origins come from numpy's `default_rng`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from seismic_bpmf_tpu_torch.config import Config
from seismic_bpmf_tpu_torch.data import Network, TemplateGroup

from .pool import DayPool, device_normal, to_host

T0_EPOCH = 1343260800.0   # 2012-07-26T00:00:00
DATE = "2012-07-26"
KM_PER_DEG = 111.19
VP_KM_S, VS_KM_S = 6.0, 3.4


@dataclass
class YearWorld:
    sizes: dict
    cfg: Config
    network: Network
    bank: TemplateGroup
    templates: np.ndarray     # (n_tp, n_sta, 3, L) float32, as handed in
    moveouts: np.ndarray      # (n_tp, n_sta, 3) int32 samples
    origins: list             # per pool day, (n_tp, k) int64 origin lags
    pool: DayPool
    scan_args: dict = field(default_factory=dict)
    problem: dict = field(default_factory=dict)


def _geometry(sizes: dict, rng) -> tuple:
    """Station coordinates (the script's) and each template's moveouts:
    (n_tp, n_sta, 3) int samples, P on Z, S on N and E, each less its
    phase's read offset; and (n_tp, n_sta, 2) P and S moveouts in s."""
    n_sta, n_tp = sizes["n_stations"], sizes["n_templates"]
    sr = float(sizes["sampling_rate_hz"])
    lat = 40.0 + 0.05 * np.arange(n_sta)
    lon = 30.0 + 0.05 * np.arange(n_sta)
    cos0 = np.cos(np.radians(lat[0]))
    sx = (lon - lon[0]) * KM_PER_DEG * cos0
    sy = (lat - lat[0]) * KM_PER_DEG
    margin = 5.0
    ex = rng.uniform(sx.min() - margin, sx.max() + margin, n_tp)
    ey = rng.uniform(sy.min() - margin, sy.max() + margin, n_tp)
    ez = rng.uniform(*sizes["source_depth_km"], n_tp)
    d = np.sqrt((ex[:, None] - sx[None]) ** 2 + (ey[:, None] - sy[None]) ** 2
                + ez[:, None] ** 2)
    lead = float(sizes["lead_sec"])
    ref = (d / VP_KM_S).min(axis=1, keepdims=True) - lead
    p_s = d / VP_KM_S - ref
    s_s = d / VS_KM_S - ref
    off_p = int(round(sizes["offset_p_sec"] * sr))
    off_s = int(round(sizes["offset_s_sec"] * sr))
    mv = np.empty((n_tp, n_sta, 3), np.int32)
    mv[:, :, 2] = np.round(p_s * sr).astype(np.int32) - off_p
    mv[:, :, :2] = (np.round(s_s * sr).astype(np.int32) - off_s)[..., None]
    locations = np.column_stack([lon[0] + ex / (KM_PER_DEG * cos0),
                                 lat[0] + ey / KM_PER_DEG, ez])
    return lat, lon, mv, np.stack([p_s, s_s], axis=2), locations


def _signals(sizes: dict, gen, device):
    """(n_tp, n_sta, 3, L) float32 device tensor: each channel's burst at
    its phase's read offset, zeros elsewhere."""
    import torch

    n_sta, n_tp = sizes["n_stations"], sizes["n_templates"]
    sr = float(sizes["sampling_rate_hz"])
    L = int(round(sizes["template_len_sec"] * sr))
    n_w = int(sizes["wavelet_sec"] * sr)
    b = device_normal(gen, (n_tp, n_sta, 3, n_w), device)
    spec = torch.fft.rfft(b, dim=-1)
    f = torch.fft.rfftfreq(n_w, d=1.0 / sr).to(device)
    lo, hi = sizes["band_hz"]
    spec *= ((f >= lo) & (f <= hi)).to(spec.dtype)
    b = torch.fft.irfft(spec, n=n_w, dim=-1)
    b *= torch.hann_window(n_w, periodic=False, device=device)
    b *= float(sizes["amplitude"]) / b.abs().amax(dim=-1, keepdim=True)
    sig = torch.zeros((n_tp, n_sta, 3, L), dtype=torch.float32,
                      device=device)
    off_p = int(round(sizes["offset_p_sec"] * sr))
    off_s = int(round(sizes["offset_s_sec"] * sr))
    sig[:, :, 2, off_p:off_p + n_w] = b[:, :, 2]
    sig[:, :, :2, off_s:off_s + n_w] = b[:, :, :2]
    return sig


def draw_origins(rng, n_tp: int, k: int, lo: int, hi: int,
                 gap: int) -> np.ndarray:
    """(n_tp, k) origin lags, one in each of k equal parts of [lo, hi),
    at least `gap` from the part's ends."""
    seg = (hi - lo) // k
    if seg <= 2 * gap:
        raise ValueError("the day is too short for its events")
    return (lo + seg * np.arange(k)[None, :]
            + rng.integers(gap, seg - gap, size=(n_tp, k)))


def build(sizes: dict, traffic: dict, seed: int, device) -> YearWorld:
    """The world of `sizes` (the configuration's) and `traffic` (its
    `pool_days` and `events_per_template`), drawn from `seed`."""
    import torch

    n_sta, n_tp = sizes["n_stations"], sizes["n_templates"]
    sr = float(sizes["sampling_rate_hz"])
    day_sec = float(sizes["day_sec"])
    n = int(round(day_sec * sr))
    L = int(round(sizes["template_len_sec"] * sr))
    rng = np.random.default_rng([seed, 22])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    lat, lon, mv, mv_sec, locations = _geometry(sizes, rng)
    sig = _signals(sizes, gen, device)
    templates = sig + device_normal(gen, sig.shape, device,
                                    float(sizes["noise"]))
    names = [f"S{i}" for i in range(n_sta)]
    network = Network.from_arrays(names, networks=["XX"] * n_sta,
                                  latitude=lat, longitude=lon,
                                  elevation_m=np.zeros(n_sta))
    tpl_host = to_host(templates)
    bank = TemplateGroup.from_arrays(
        tpl_host, mv, list(range(n_tp)), names, sampling_rate=sr,
        moveouts_sec=mv_sec.astype(np.float32), locations=locations,
        origin_times=[T0_EPOCH] * n_tp, network=network)
    del templates

    k = int(traffic["events_per_template"])
    n_ch = n_sta * 3
    lo = int(sizes["edge_sec"] * sr)
    hi = n - int(mv.max()) - L - lo
    gap = int(2 * 10 * sizes["scan_kwargs"]["minimum_interevent_time"] * sr)
    rows = sig.reshape(n_tp, 1, n_ch, L)
    mv_dev = torch.from_numpy(mv.reshape(n_tp, 1, n_ch).astype(np.int64)).to(
        device)
    ch_base = (torch.arange(n_ch, device=device) * n).view(1, 1, n_ch, 1)
    taps = torch.arange(L, device=device).view(1, 1, 1, L)
    days, origins = [], []
    for _ in range(int(traffic["pool_days"])):
        o = draw_origins(rng, n_tp, k, lo, hi, gap)
        origins.append(o)
        day = device_normal(gen, (n_ch * n,), device, float(sizes["noise"]))
        start = torch.from_numpy(o[:, :, None]).to(device) + mv_dev
        idx = ch_base + start[..., None] + taps          # (n_tp, k, n_ch, L)
        day.index_add_(0, idx.reshape(-1),
                       rows.expand(n_tp, k, n_ch, L).reshape(-1))
        days.append(to_host(day).reshape(n_sta, 3, n))
        del day, idx, start
    del sig, rows

    cfg = Config(data_buffer_sec=0.0, sampling_rate_hz=sr,
                 template_len_sec=float(sizes["template_len_sec"]),
                 n_dev_mf_threshold=float(sizes["n_dev_mf_threshold"]))
    pool = DayPool(days, names, sr, DATE, T0_EPOCH, day_sec)
    scan = dict(sizes["scan_kwargs"])
    # the extraction cut: `max_memory_gb` over one template's CC row
    row_gb = 4.0 * int(day_sec * sr) / 1024.0 ** 3
    scan["max_memory_gb"] = (int(sizes["extraction_chunk"]) + 0.5) * row_gb
    scan_args = dict(template_group=bank, cfg=cfg, stage="mf",
                     template_chunk=int(sizes["template_chunk"]),
                     rng=np.random.default_rng([seed, 23]), device=device,
                     **scan)
    has_data = np.any(tpl_host != 0.0, axis=-1)
    n_pairs = int(has_data.sum())
    problem = dict(kind="mf", n_templates=n_tp, n_channels=n_ch, L=L,
                   n_samples=n, n_lags=n - L + 1, n_pairs=n_pairs)
    return YearWorld(sizes=sizes, cfg=cfg, network=network, bank=bank,
                     templates=tpl_host, moveouts=mv, origins=origins,
                     pool=pool, scan_args=scan_args, problem=problem)
