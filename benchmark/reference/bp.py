"""The plain reference of the backprojection campaign day, and the
comparison that decides `correct` for a BP cell.

It imports nothing of the program.  From the world's raw inputs (each pool
day as float32 samples, the travel times in float32 seconds) it works out
again what the program derives: the moveouts in samples (BPMF's rounding,
floor(|t sr| + 0.2), less each source's first arrival), the
closest-station source weights (the stations whose P moveout is at most
the k-th smallest, ties kept, over their count), the phase weights (P on
Z, S on N and E), the features (float64 envelopes by an FFT Hilbert
transform, less their median, over their median absolute deviation,
clipped at 1e5) and the beam in float64: for source i and lag t,
sum over stations s and phases p of w_src[i, s] g[s, p, t + mv[i, s, p]],
with g the phase-folded features; a lag at which any used channel reads
past the day gives 0 for that source ('strict').  The max beam at a lag is
its largest value over the sources, and the argmax the first source that
reaches it.

`precision="bf16"` is the control: the features rounded to bf16 and the
beam summed in float32.
"""

from __future__ import annotations

import numpy as np

NAMES = ("beam_gap", "argmax_gap", "missed")


def tt_to_samples(tt: np.ndarray, sr: float) -> np.ndarray:
    t = np.asarray(tt, np.float32)
    v = np.abs(t * np.float32(sr)) + np.float32(0.2)
    return (np.sign(t) * np.floor(v)).astype(np.int64)


def moveouts_of(tt: np.ndarray, sr: float) -> np.ndarray:
    """(n_src, n_sta, 2) float32 travel times (s) -> int64 moveouts in
    samples relative to each source's first arrival."""
    mv = tt_to_samples(tt, sr)
    return mv - mv.min(axis=(1, 2), keepdims=True)


def closest_station_weights(mv: np.ndarray, k: int) -> np.ndarray:
    """(n_src, n_sta) float32 weights of the stations whose P moveout is
    at most the k-th smallest (ties kept), over their count."""
    n_src, n_sta = mv.shape[:2]
    w = np.ones((n_src, n_sta), np.float32)
    kk = min(n_sta, k)
    if 0 < kk < n_sta:
        p = mv[:, :, 0]
        cutoff = np.max(np.partition(p, kk - 1)[:, :kk], axis=1,
                        keepdims=True)
        w[p > cutoff] = 0.0
    norm = w.sum(axis=1, keepdims=True)
    norm[norm == 0.0] = 1.0
    return w / norm


def _median(x, dim=-1):
    """numpy's median along `dim` (the mean of the two middle values)."""
    s, _ = x.sort(dim=dim)
    n = s.shape[dim]
    return (s.select(dim, (n - 1) // 2) + s.select(dim, n // 2)) * 0.5


def features(day: np.ndarray, device, dtype):
    """(n_sta, 3, n) float32 day -> standardized envelopes on `device`."""
    import torch

    x = torch.from_numpy(np.asarray(day, np.float32)).to(device,
                                                        torch.float64)
    n = x.shape[-1]
    h = torch.zeros(n, dtype=torch.float64, device=device)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1:(n + 1) // 2] = 2.0
    env = torch.fft.ifft(torch.fft.fft(x, dim=-1) * h, dim=-1).abs()
    del x
    med = _median(env)[..., None]
    mad = _median((env - med).abs())[..., None]
    std = ((env - med) / mad).clamp(max=1.0e5)
    bad = (env == 0).sum(-1, keepdim=True) > n / 2
    std = torch.where(bad | (mad < 1.0e-11), torch.zeros_like(std), std)
    if dtype == "bf16":
        return std.to(torch.float32).to(torch.bfloat16).to(torch.float32)
    return std


def keywords(world, traffic: dict) -> dict:
    """The scan's keywords: the configuration's, under the mix's."""
    return {**world.sizes["scan_kwargs"], **traffic.get("engine", {})}


class Reference:
    """The reference of one world on `device` (plain torch ops), with the
    scan's keywords `kw` (the configuration's where None)."""

    def __init__(self, world, device, precision: str = "f64", kw=None):
        import torch

        self.torch = torch
        self.world = world
        self.device = torch.device(device)
        self.precision = precision
        self.dtype = torch.float32 if precision == "bf16" else torch.float64
        sr = float(world.sizes["sampling_rate_hz"])
        mv = moveouts_of(world.tt, sr)
        kw = world.sizes["scan_kwargs"] if kw is None else kw
        w = closest_station_weights(mv, kw["num_closest_stations"])
        n_src = mv.shape[0]
        used = w != 0.0
        c = int(used.sum(axis=1).max())
        # each source's used stations, padded with weight 0
        order = np.argsort(~used, axis=1, kind="stable")[:, :c]
        self.sta = torch.from_numpy(order.astype(np.int64)).to(self.device)
        self.w = torch.from_numpy(np.take_along_axis(w, order, 1)).to(
            self.device, self.dtype)
        self.mv = torch.from_numpy(np.take_along_axis(
            mv, order[..., None], 1)).to(self.device)      # (n_src, c, 2)
        self.reach = torch.from_numpy(np.where(
            np.take_along_axis(used, order, 1)[..., None],
            np.take_along_axis(mv, order[..., None], 1), 0).reshape(
                n_src, -1).max(axis=1)).to(self.device)
        self._g: dict = {}

    def folded(self, k: int):
        """Pool day `k`'s phase-folded features, (n_sta * 2, n): P the Z
        envelope, S the sum of the N and E envelopes."""
        if k not in self._g:
            f = features(self.world.pool.days[k], self.device,
                         self.precision)
            g = self.torch.stack([f[:, 2], f[:, 0] + f[:, 1]], dim=1)
            self._g[k] = g.reshape(-1, g.shape[-1]).to(self.dtype)
        return self._g[k]

    def beam_at(self, k: int, lags: np.ndarray, pick=None):
        """(max, first argmax) of the beam at `lags`, and the beam of
        source `pick[j]` at `lags[j]` where `pick` is given."""
        torch = self.torch
        g = self.folded(k).reshape(-1)
        n = self.folded(k).shape[1]
        t = torch.from_numpy(np.asarray(lags, np.int64)).to(self.device)
        m = len(lags)
        best = torch.full((m,), -float("inf"), dtype=self.dtype,
                          device=self.device)
        arg = torch.zeros(m, dtype=torch.int64, device=self.device)
        if pick is not None:
            pick = torch.from_numpy(np.asarray(pick, np.int64)).to(
                self.device)
            picked = torch.zeros(m, dtype=self.dtype, device=self.device)
        n_src, c = self.sta.shape
        block = max(1, 2 ** 26 // max(1, c * 2 * m))
        cols = torch.arange(m, device=self.device)
        for s0 in range(0, n_src, block):
            sta = self.sta[s0:s0 + block]
            row = sta[..., None] * 2 + torch.arange(2, device=self.device)
            col = (self.mv[s0:s0 + block][..., None] + t).clamp(max=n - 1)
            b = (g[row[..., None] * n + col]
                 * self.w[s0:s0 + block, :, None, None]).sum(dim=(1, 2))
            ok = (self.reach[s0:s0 + block, None] + t) < n
            b = torch.where(ok, b, torch.zeros_like(b))         # (b, m)
            v, i = b.max(dim=0)
            better = v > best
            best = torch.where(better, v, best)
            arg = torch.where(better, i + s0, arg)
            if pick is not None:
                mine = (pick >= s0) & (pick < s0 + b.shape[0])
                j = (pick - s0).clamp(0, b.shape[0] - 1)
                picked = torch.where(mine, b[j, cols], picked)
        return best, arg, (picked if pick is not None else None)


def sample_plan(world, seed: int, day: int, n_windows: int,
                window_lags: int) -> list:
    """The first lags of the beam windows compared on campaign day `day`:
    `n_windows` drawn from the seed, one at the day's last lags and one
    around each planted event's beam peak."""
    n = world.problem["n_samples"]
    rng = np.random.default_rng([seed, 32, day])
    k = day % len(world.pool)
    last = n - window_lags
    starts = [int(s) for s in rng.integers(0, last + 1, size=n_windows)]
    starts.append(last)
    samp = tt_to_samples(world.tt, float(world.sizes["sampling_rate_hz"]))
    for o, src in world.events[k]:
        peak = o + int(samp[src].min())
        starts.append(int(min(max(peak - window_lags // 2, 0), last)))
    return starts


def compare(world, traffic: dict, record, device, check: dict) -> dict:
    """The numbers of a BP cell on each checked day: the widest gap of the
    program's max beam from the reference's (`beam_gap`) and of the
    reference's max from its beam at the program's argmax (`argmax_gap`),
    over the sampled windows of the checked days and every detection's
    lag; the planted events with no detection within 2 samples of their
    peak at a source within one lattice spacing (`missed`).
    {day: {name: value}}."""
    ref = Reference(world, device, kw=keywords(world, traffic))
    samp = tt_to_samples(world.tt, float(world.sizes["sampling_rate_hz"]))
    per_day = {}
    for i in record.days:
        k = i % len(world.pool)
        peaks, sources = record.peaks.get(i, (np.zeros(0, int),
                                             np.zeros(0, int)))
        lags = [np.asarray(peaks, np.int64)]
        for s in sample_plan(world, record.seed, i, check["beam_windows"],
                             check["beam_window_lags"]):
            lags.append(np.arange(s, s + check["beam_window_lags"]))
        lags = np.unique(np.concatenate(lags))
        gaps = {"beam_gap": 0.0, "argmax_gap": 0.0}
        if i not in record.beams:
            gaps = {"beam_gap": float("inf"), "argmax_gap": float("inf")}
        elif len(lags):
            maxbeam, argmax = record.beams[i]
            got = np.asarray(maxbeam)[lags].astype(np.float64)
            src = np.asarray(argmax)[lags].astype(np.int64)
            best, _, col = ref.beam_at(k, lags, pick=src)
            want = best.double().cpu().numpy()
            col = col.double().cpu().numpy()
            gaps["beam_gap"] = float(np.max(np.abs(got - want)))
            gaps["argmax_gap"] = float(np.max(want - col))
        missed = 0
        for o, src in world.events[k]:
            peak = o + int(samp[src].min())
            near = np.all(np.abs(world.src_km[np.asarray(sources, np.int64)]
                                 - world.src_km[src])
                          <= world.spacing + 1e-9, axis=1) \
                if len(sources) else np.zeros(0, bool)
            hit = (np.abs(np.asarray(peaks) - peak) <= 2) & near
            missed += int(not np.any(hit))
        per_day[i] = {**gaps, "missed": missed}
    return per_day


def control(world, traffic: dict, seed: int, days, device,
            check: dict) -> dict:
    """What the control puts in the program's place on `days` of the
    world a run with `seed` draws: the beam from bf16 features summed in
    float32.  For each day, as the window records them: `beams`, the max
    beam and its first argmax at the lags such a run samples and at each
    planted event's peak (NaN and -1 elsewhere, where `compare` does not
    read); `peaks`, a detection at each planted event's peak and source.
    `compare` judges them."""
    ctl = Reference(world, device, precision="bf16",
                    kw=keywords(world, traffic))
    samp = tt_to_samples(world.tt, float(world.sizes["sampling_rate_hz"]))
    n = world.problem["n_samples"]
    width = check["beam_window_lags"]
    out = {}
    for i in days:
        k = i % len(world.pool)
        peaks = np.asarray([o + int(samp[src].min())
                            for o, src in world.events[k]], np.int64)
        sources = np.asarray([src for _, src in world.events[k]], np.int64)
        lags = np.unique(np.concatenate([peaks] + [
            np.arange(s, s + width)
            for s in sample_plan(world, seed, i, check["beam_windows"],
                                 width)]))
        best, arg, _ = ctl.beam_at(k, lags)
        maxbeam = np.full(n, np.nan, np.float32)
        argmax = np.full(n, -1, np.int64)
        maxbeam[lags] = best.cpu().numpy()
        argmax[lags] = arg.cpu().numpy()
        out[i] = {"beams": (maxbeam, argmax), "peaks": (peaks, sources)}
    return out
