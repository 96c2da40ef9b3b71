"""Time-dependent detection thresholds and candidate extraction.

Counterpart of `seismic_bpmf_tpu/ops/thresholds.py` (the matched-filter
part): the 'rms' threshold of BPMF/libc.c:516-673 with its cyclic
500-sample Gaussian zero-fill and "delay-the-jump" smoothing, the 'mad'
threshold of BPMF/similarity_search.py:1079-1113, the batched threshold +
two-stage top-k candidate extraction of the day scan, and the
backprojection threshold (median + N MAD, BPMF/template_search.py:1418-1487).
These were XLA programs in the JAX package; here they are plain torch ops on the
device of the CC tensor they are given.  Where a noise table is not
passed, it is drawn from an explicit `numpy.random.Generator` (`rng`).
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch

from .._device import resolve_device
from ..utils.observe import GLOBAL_TIMER
from .reference import GAUSSIAN_SAMPLE_LEN

CANDIDATE_BLOCK = 512
L2_SUB = 32        # level-2 narrowing sub-block (samples)
L2_KEEP = 512      # level-2 sub-blocks kept before the final top-k


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _noise(rng, size: int) -> np.ndarray:
    rng = np.random.default_rng() if rng is None else rng
    return rng.normal(size=int(size)).astype(np.float32)


def _window_sums(x, win: int, shift: int):
    """Sums of x over windows [i*shift, i*shift + win) (direct f32)."""
    return x.unfold(-1, win, shift).sum(-1)


def _tdt_rms(ts, gauss, num_dev: float, *, win: int, shift: int, n_win: int):
    n = ts.shape[0]
    dev = ts.device
    # global center/dev over non-zero samples of the first (n // win) windows
    n_glob = (n // win) * win
    head = ts[:n_glob]
    nz = head != 0.0
    n_nz = torch.clamp(nz.sum(), min=1).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    center = torch.where(nz, head, zero).sum() / n_nz
    sd = torch.sqrt(torch.where(nz, (head - center) ** 2, zero).sum() / n_nz)

    # fill zeros with cyclic scaled Gaussian noise
    idx = torch.arange(n, device=dev) % GAUSSIAN_SAMPLE_LEN
    idx = torch.clamp(idx, max=gauss.shape[0] - 1)
    fill = center + gauss[idx] * sd
    ts = torch.where(ts == 0.0, fill, ts)

    # sliding mean + num_dev * std over n_win windows at stride `shift`
    n_need = (n_win - 1) * shift + win
    ts_w = ts[:n_need]
    s1 = _window_sums(ts_w, win, shift)[:n_win]
    s2 = _window_sums(ts_w * ts_w, win, shift)[:n_win]
    mean = s1 / win
    var = torch.clamp(s2 / win - mean * mean, min=0.0)
    thr_win = mean + num_dev * torch.sqrt(var)

    # "delay the jump" smoothing as two pairwise maxima (libc.c:631-651)
    thr1 = torch.cat([thr_win[:1], torch.maximum(thr_win[1:], thr_win[:-1])])
    thr2 = torch.cat([torch.maximum(thr1[:-1], thr1[1:]), thr1[-1:]])

    # step-wise expansion to full length
    i = torch.arange(n, device=dev)
    out = thr2[torch.clamp(i // shift, 0, n_win - 1)]
    out = torch.where(i < shift, thr2[0], out)
    out = torch.where(i >= n - shift, thr2[n_win - 1], out)
    return out


def _median(x):
    """Median over the last axis, midpoint of the two middle values."""
    s, _ = torch.sort(x, dim=-1)
    m = x.shape[-1]
    if m % 2:
        return s[..., m // 2]
    return (s[..., m // 2 - 1] + s[..., m // 2]) * 0.5


def _nanmedian(x):
    """Median of the non-NaN entries along the last axis, kept as a
    length-1 axis: the midpoint of the two middle values for an even
    count (numpy's), NaN for a row without values.  NaN sorts last."""
    s, _ = torch.sort(x, dim=-1)
    nv = (~torch.isnan(x)).sum(dim=-1, keepdim=True)
    lo = torch.clamp((nv - 1) // 2, min=0)
    return (s.gather(-1, lo) + s.gather(-1, nv // 2)) * 0.5


def _tdt_mad(ts, noise, num_dev: float, *, window: int, shift: int,
             n_win: int):
    """Median + num_dev * MAD threshold; the k-th zero sample is filled
    with noise[k] (the reference's ``white_noise[:n_zeros]``)."""
    n = ts.shape[0]
    zeros = ts == 0.0
    ts_nan = torch.where(zeros, torch.full_like(ts, float("nan")), ts)
    center = _nanmedian(ts_nan)
    mad = _nanmedian(torch.abs(ts_nan - center))
    rank = torch.cumsum(zeros.to(torch.int64), 0) - 1
    fill = noise[torch.clamp(rank, 0, noise.shape[0] - 1)] * mad + center
    ts = torch.where(zeros, fill, ts)

    w = ts.unfold(0, window, shift)[:n_win]
    med = _median(w)
    thr = med + num_dev * _median(torch.abs(w - med[:, None]))
    thr = torch.cat([thr[:1], torch.maximum(thr[1:], thr[:-1])])
    thr = torch.cat([torch.maximum(thr[:-1], thr[1:]), thr[-1:]])

    half = window // 2
    mid_len = n - window
    t = torch.arange(mid_len, device=ts.device) + half
    mid = thr[torch.clamp(t // shift, max=n_win - 1)]
    return torch.cat([mid[:1].expand(half), mid,
                      mid[mid_len - 1 :].expand(window - half)])


def _rms_geometry(n: int, sliding_window_samp: int, overlap: float):
    swin = min(int(sliding_window_samp), int(n))
    win = 2 * (swin // 2)
    shift = max(int((1.0 - overlap) * swin), 1)
    return win, shift, (n - (win - shift)) // shift


def _mad_geometry(n: int, sliding_window_samp: int, overlap: float):
    window = min(int(sliding_window_samp), int(n))
    shift = max(int((1.0 - overlap) * window), 1)
    return window, shift, max(int((n - window) // shift) + 1, 1)


def time_dependent_threshold(time_series, sliding_window_samp: int,
                             num_dev: float, overlap: float = 0.66,
                             threshold_type: str = "rms", white_noise=None,
                             rng=None, device=None):
    """Time-dependent detection threshold of a CC series, as a tensor on
    the series' device (a numpy series goes to `device`).

    Matches `ops.reference.time_dependent_threshold`."""
    dev = (time_series.device if isinstance(time_series, torch.Tensor)
           else resolve_device(device))
    ts = _f32(time_series, dev)
    n = ts.shape[0]
    threshold_type = threshold_type.lower()
    if threshold_type == "rms":
        win, shift, n_win = _rms_geometry(n, sliding_window_samp, overlap)
        if white_noise is None:
            white_noise = _noise(rng, GAUSSIAN_SAMPLE_LEN)
        gauss = _f32(white_noise, dev)[:GAUSSIAN_SAMPLE_LEN]
        return _tdt_rms(ts, gauss, float(num_dev), win=win, shift=shift,
                        n_win=n_win)
    if threshold_type == "mad":
        window, shift, n_win = _mad_geometry(n, sliding_window_samp, overlap)
        if white_noise is None:
            # one noise sample per zero entry; size for all zeros
            white_noise = _noise(rng, n)
        return _tdt_mad(ts, _f32(white_noise, dev), float(num_dev),
                        window=window, shift=shift, n_win=n_win)
    raise ValueError(
        f"threshold_type must be 'rms' or 'mad', got {threshold_type!r}"
    )


def bp_detection_threshold(maxbeam, window: int, overlap: float = 0.75,
                           num_dev: float = 15.0, device=None):
    """Running median + num_dev * MAD of the max beam in strided windows,
    linearly interpolated between the window centres (flat beyond the
    first and last), as a tensor on the beam's device (a numpy beam goes
    to `device`).  Matches `ops.reference.bp_detection_threshold`
    (BPMF/template_search.py:1418-1487); the MAD has scipy's default
    scale 1."""
    dev = (maxbeam.device if isinstance(maxbeam, torch.Tensor)
           else resolve_device(device))
    x = _f32(maxbeam, dev)
    n = x.shape[0]
    window = min(int(window), int(n))
    shift = max(int((1.0 - overlap) * window), 1)
    n_windows = max(int((n - window) // shift) + 1, 1)
    # NaN past the end: windows cut by the data end hold fewer values
    x_pad = torch.cat([x, torch.full((window,), float("nan"), device=dev)])
    w = x_pad.unfold(0, window, shift)[1 : n_windows + 1]
    med = _nanmedian(w)
    thr = (med + float(num_dev) * _nanmedian(torch.abs(w - med)))[:, 0]
    starts = torch.arange(1, n_windows + 1, device=dev) * shift
    centers = (starts + torch.clamp(starts + window, max=n)) / 2.0
    xp = torch.cat([torch.zeros(1, device=dev), centers.float(),
                    torch.full((1,), float(n), device=dev)])
    fp = torch.cat([thr[:1], thr, thr[-1:]])
    # np.interp / jnp.interp
    t = torch.arange(n, dtype=torch.float32, device=dev)
    i = torch.clamp(torch.searchsorted(xp, t, right=True), 1, xp.shape[0] - 1)
    dx = xp[i] - xp[i - 1]
    flat = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(flat, fp[i - 1],
                    fp[i - 1] + ((t - xp[i - 1])
                                 / torch.where(flat, torch.ones_like(dx), dx))
                    * (fp[i] - fp[i - 1]))
    f = torch.where(t < xp[0], fp[0], f)
    return torch.where(t > xp[-1], fp[-1], f)


def _cc_kurtosis(cc):
    """4th-moment excess kurtosis of the CC series (sanity check)."""
    mu = cc.mean()
    d = cc - mu
    m2 = (d * d).mean()
    m4 = (d**4).mean()
    return torch.where(m2 > 0, m4 / (m2 * m2) - 3.0, torch.zeros_like(m2))


def _candidate_extract_one_stage(cc, thr, k: int, margin: float = 0.0):
    """Top-k lags by threshold excess over the full series."""
    excess = cc - thr + margin
    _, idx = torch.topk(excess, k)
    n_above = (excess > 0.0).sum()
    return idx, cc[idx], thr[idx], n_above, _cc_kurtosis(cc)


def _candidate_extract_two_stage(cc, thr, k: int, k_blocks: int,
                                 margin: float = 0.0):
    """Two-stage extraction: count above-threshold samples per
    CANDIDATE_BLOCK-sample block, keep the `k_blocks` fullest blocks and
    take the top k lags inside them.  Exact whenever at most `k_blocks`
    blocks hold candidates; `blocks_hit` reports when that bound fails.

    Returns (idx, cc_vals, thr_vals, n_above, kurto, blocks_hit)."""
    block = CANDIDATE_BLOCK
    n = cc.shape[0]
    n_blocks = -(-n // block)
    excess = cc - thr + margin
    excess_p = torch.nn.functional.pad(
        excess, (0, n_blocks * block - n), value=float("-inf"))
    eb = excess_p.reshape(n_blocks, block)
    counts = (eb > 0.0).sum(-1)
    n_above = counts.sum()
    blocks_hit = (counts > 0).sum()
    _, bidx = torch.topk(counts.to(torch.float32), min(k_blocks, n_blocks))
    flat = eb[bidx].reshape(-1)
    _, pos = torch.topk(flat, min(k, flat.shape[0]))
    idx = bidx[pos // block] * block + pos % block
    idx = torch.clamp(idx, max=n - 1)  # padded lanes are never candidates
    return (idx, cc[idx], thr[idx], n_above, _cc_kurtosis(cc), blocks_hit)


def _rms_cov_len(n: int, win: int, shift: int, n_win: int) -> int:
    """Length of the block-summed prefix pass: covers every threshold
    window AND every whole `win` block of the global center/dev stats."""
    return max((n_win - 1) * shift + win, (n // win) * win)


def _batch_candidates_rms_fused(cc, g_tiled, num_dev: float, caps,
                                margin: float, *, win: int, shift: int,
                                n_win: int, k: int, k_blocks: int, G: int,
                                n: int, pack: bool = False):
    """Batched rms threshold + hierarchical top-k extraction.

    Same algorithm as the JAX package's `_batch_candidates_rms_fused`:
    window statistics from G-sample block sums (G = gcd(win, shift)) with
    the zero-fill applied analytically per block, the threshold kept as
    its (n_win,) window table, one fused compare/count/moments pass over
    512-sample blocks, then narrowing 512-blocks -> 32-sample sub-blocks
    -> a final sort.  The returned set equals {i: cc[i] > thr[i] - margin}
    whenever n_above <= k and at most k_blocks blocks (and L2_KEEP
    sub-blocks of them) hold candidates; otherwise `blocks_hit` exceeds
    k_blocks and the caller falls back."""
    dev = cc.device
    n_tp = cc.shape[0]
    r, s = win // G, shift // G
    ninf = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)

    # ---- pass 1: G-block partial sums -> window thresholds ----
    n_glob = (n // win) * win
    n_cov = _rms_cov_len(n, win, shift, n_win)
    nb1 = n_cov // G
    xh = cc[:, :n_cov].reshape(n_tp, nb1, G)
    g_full = g_tiled[:n_cov].reshape(nb1, G)
    zf = (xh == 0.0).to(torch.float32)
    b_x = xh.sum(-1)
    b_x2 = (xh * xh).sum(-1)
    b_z = zf.sum(-1)
    b_zg = (zf * g_full).sum(-1)
    b_zg2 = (zf * (g_full * g_full)).sum(-1)
    del zf

    kg = n_glob // G
    n_nz = torch.clamp(float(n_glob) - b_z[:, :kg].sum(1), min=1.0)
    center = b_x[:, :kg].sum(1) / n_nz
    sd = torch.sqrt(torch.clamp(
        b_x2[:, :kg].sum(1) / n_nz - center * center, min=0.0))
    c, d = center[:, None], sd[:, None]

    # filled-series block sums (fill = center + gauss * dev at zeros)
    fb1 = b_x + c * b_z + d * b_zg
    fb2 = b_x2 + c * c * b_z + 2.0 * c * d * b_zg + d * d * b_zg2

    # window i = blocks [i*s, i*s + r)
    wsel = (torch.arange(n_win, device=dev)[:, None] * s
            + torch.arange(r, device=dev)[None, :])
    s1 = fb1[:, wsel].sum(-1)
    s2 = fb2[:, wsel].sum(-1)
    mean = s1 / win
    var = torch.clamp(s2 / win - mean * mean, min=0.0)
    thr_w = mean + num_dev * torch.sqrt(var)
    thr1 = torch.cat([thr_w[:, :1],
                      torch.maximum(thr_w[:, 1:], thr_w[:, :-1])], dim=1)
    thr2 = torch.cat([torch.maximum(thr1[:, :-1], thr1[:, 1:]),
                      thr1[:, -1:]], dim=1)
    thr2 = torch.minimum(thr2, caps[:, None])  # per-row absolute CC cap

    # ---- pass 2: fused compare + count + moments over 512-blocks ----
    Bc = CANDIDATE_BLOCK
    nbc = -(-n // Bc)
    xb = torch.nn.functional.pad(cc, (0, nbc * Bc - n)).reshape(n_tp, nbc,
                                                                Bc)
    ib = (torch.arange(nbc, device=dev)[:, None] * Bc
          + torch.arange(Bc, device=dev)[None, :])
    valid = ib < n
    jb = torch.where(ib >= n - shift, n_win - 1,
                     torch.clamp(ib // shift, max=n_win - 1))
    excess = torch.where(valid[None], xb - thr2[:, jb] + margin, ninf)
    counts = (excess > 0.0).sum(-1)          # (n_tp, nbc)
    del excess
    n_above = counts.sum(-1)
    blocks_hit = (counts > 0).sum(-1)

    # raw power sums for the kurtosis (the pad is 0 and adds nothing)
    x2 = xb * xb
    m1 = xb.sum((1, 2))
    m2r = x2.sum((1, 2))
    m3r = (x2 * xb).sum((1, 2))
    m4r = (x2 * x2).sum((1, 2))
    del x2
    mu = m1 / n
    m2c = torch.clamp(m2r / n - mu * mu, min=0.0)
    m4c = (m4r - 4.0 * mu * m3r + 6.0 * mu * mu * m2r) / n - 3.0 * mu**4
    kurto = torch.where(m2c > 0, m4c / (m2c * m2c) - 3.0,
                        torch.zeros_like(m2c))

    # ---- narrowing: top blocks by count -> top sub-blocks -> sort ----
    kb = min(k_blocks, nbc)
    _, bidx = torch.topk(counts.to(torch.float32), kb, dim=1)
    blk_x = torch.gather(xb, 1, bidx[:, :, None].expand(-1, -1, Bc))
    i0 = bidx * Bc
    qs = i0 // shift
    t_lo = torch.gather(thr2, 1, torch.clamp(qs, max=n_win - 1))
    t_hi = torch.gather(thr2, 1, torch.clamp(qs + 1, max=n_win - 1))
    t_tail = thr2[:, -1][:, None, None]
    i_sel = i0[:, :, None] + torch.arange(Bc, device=dev)
    bnd = ((qs + 1) * shift)[:, :, None]
    thr_sel = torch.where(
        i_sel >= n - shift, t_tail,
        torch.where(i_sel >= bnd, t_hi[:, :, None], t_lo[:, :, None]),
    )
    exc_sel = torch.where(i_sel < n, blk_x - thr_sel + margin, ninf)

    n_sub = Bc // L2_SUB
    counts2 = (exc_sel.reshape(n_tp, kb * n_sub, L2_SUB) > 0.0).sum(-1)
    sub_hit = (counts2 > 0).sum(-1)
    l2 = min(L2_KEEP, kb * n_sub)
    _, sidx = torch.topk(counts2.to(torch.float32), l2, dim=1)

    def _sub_take(a):
        return torch.gather(
            a.reshape(n_tp, kb * n_sub, L2_SUB), 1,
            sidx[:, :, None].expand(-1, -1, L2_SUB),
        ).reshape(n_tp, l2 * L2_SUB)

    exc_l2 = _sub_take(exc_sel)
    cc_l2 = _sub_take(blk_x)
    thr_l2 = _sub_take(thr_sel)
    base = (torch.gather(bidx, 1, sidx // n_sub) * Bc
            + (sidx % n_sub) * L2_SUB)
    gidx_l2 = (base[:, :, None]
               + torch.arange(L2_SUB, device=dev)).reshape(n_tp, l2 * L2_SUB)

    kk = min(k, l2 * L2_SUB)
    order = torch.argsort(-exc_l2, dim=-1, stable=True)[:, :kk]
    idx = torch.clamp(torch.gather(gidx_l2, 1, order), max=n - 1)
    cc_v = torch.gather(cc_l2, 1, order)
    thr_v = torch.gather(thr_l2, 1, order)

    # a level-2 overflow invalidates the extraction like a level-1 one
    blocks_hit = torch.where(
        sub_hit > l2, torch.maximum(blocks_hit, k_blocks + 1 + sub_hit),
        blocks_hit,
    )
    if pack:
        # one f32 array [idx | cc | thr | n_above kurto blocks_hit]:
        # exact while idx < 2^24 (RmsExtractionPlan.can_pack)
        aux = torch.stack([n_above.to(torch.float32), kurto,
                           blocks_hit.to(torch.float32)], dim=1)
        return torch.cat([idx.to(torch.float32), cc_v, thr_v, aux], dim=1)
    return idx, cc_v, thr_v, n_above, kurto, blocks_hit


class RmsExtractionPlan:
    """Constants of the fused rms threshold + candidate extraction: the
    window geometry and the cyclic Gaussian fill tiled to the covered
    length on the device (made once, reused every day of a campaign)."""

    def __init__(self, n: int, sliding_window_samp: int,
                 overlap: float = 0.66, white_noise=None, k: int = 1024,
                 k_blocks: int = 256, device=None, rng=None):
        self.device = resolve_device(device)
        n = int(n)
        self.win, self.shift, n_win = _rms_geometry(
            n, sliding_window_samp, overlap)
        self.n_win = n_win if self.shift else 0
        self.n, self.k, self.k_blocks = n, int(k), int(k_blocks)
        # the 3-value threshold select assumes a 512-sample block spans
        # at most one window boundary
        self.supported = (self.n_win >= 1 and self.win > 0
                          and self.shift >= CANDIDATE_BLOCK)
        if white_noise is None:
            white_noise = _noise(rng, GAUSSIAN_SAMPLE_LEN)
        self.white_noise = np.asarray(
            white_noise, np.float32)[:GAUSSIAN_SAMPLE_LEN]
        if self.supported:
            self.G = math.gcd(self.win, self.shift)
            n_cov = _rms_cov_len(n, self.win, self.shift, self.n_win)
            self.g_tiled = torch.from_numpy(
                np.resize(self.white_noise, n_cov)).to(self.device)
        else:
            self.G, self.g_tiled = 1, None

    @property
    def can_pack(self) -> bool:
        """True when the single-f32-array packing is exact: candidate
        indices (< n) must be integers below 2^24."""
        return self.n < 2 ** 24

    def extract(self, cc, caps, num_dev, margin=0.0, pack=False):
        """Fused threshold + extraction of a (n_tp, n) CC stack.  Returns
        (idx, cc_vals, thr_vals, n_above, kurto, blocks_hit) tensors, or
        with ``pack=True`` one (n_tp, 3k+3) f32 tensor (see `unpack`)."""
        if pack and not self.can_pack:
            raise ValueError(
                f"pack=True is exact only for series shorter than 2^24 "
                f"samples (n={self.n}); use pack=False"
            )
        cc = _f32(cc, self.device)
        return _batch_candidates_rms_fused(
            cc, self.g_tiled, float(num_dev), _f32(caps, self.device),
            float(margin), win=self.win, shift=self.shift, n_win=self.n_win,
            k=self.k, k_blocks=self.k_blocks, G=self.G, n=self.n, pack=pack,
        )

    def unpack(self, packed):
        """Host-side inverse of ``extract(pack=True)`` -> the 6-tuple
        (idx, cc_vals, thr_vals, n_above, kurto, blocks_hit) as numpy."""
        a = packed.cpu().numpy() if isinstance(packed, torch.Tensor) \
            else np.asarray(packed)
        kk = (a.shape[1] - 3) // 3
        return (a[:, :kk].astype(np.int64), a[:, kk:2 * kk],
                a[:, 2 * kk:3 * kk], a[:, 3 * kk].astype(np.int64),
                a[:, 3 * kk + 1], a[:, 3 * kk + 2].astype(np.int64))


_RMS_PLAN_CACHE: dict = {}


def _rms_plan(n, sliding_window_samp, overlap, white_noise, k, k_blocks,
              device=None, rng=None):
    """Cached `RmsExtractionPlan` (true LRU over 8 geometries).  A plan
    made without a noise table is cached under the key None and keeps the
    table it drew.  A build is an `rms_plan` stage."""
    dev = resolve_device(device)
    wn = (np.asarray(white_noise, np.float32)[:GAUSSIAN_SAMPLE_LEN]
          if white_noise is not None else None)
    key = (int(n), int(sliding_window_samp), float(overlap), int(k),
           int(k_blocks), str(dev),
           zlib.crc32(wn.tobytes()) if wn is not None else None)
    plan = _RMS_PLAN_CACHE.get(key)
    if plan is not None:
        _RMS_PLAN_CACHE[key] = _RMS_PLAN_CACHE.pop(key)
    else:
        if len(_RMS_PLAN_CACHE) >= 8:
            _RMS_PLAN_CACHE.pop(next(iter(_RMS_PLAN_CACHE)))
        with GLOBAL_TIMER.stage("rms_plan"):
            plan = RmsExtractionPlan(n, sliding_window_samp, overlap=overlap,
                                     white_noise=wn, k=k, k_blocks=k_blocks,
                                     device=dev, rng=rng)
        _RMS_PLAN_CACHE[key] = plan
    return plan


def batch_candidates(cc, caps, sliding_window_samp: int, num_dev: float,
                     overlap: float = 0.66, white_noise=None, k: int = 1024,
                     k_blocks: int = 256, threshold_type: str = "rms",
                     margin: float = 0.0, fused: bool = True, rng=None):
    """Thresholds + top-k candidate extraction for a (n_tp, n) CC stack
    on its device.  Returns (idx, cc_vals, thr_vals, n_above, kurto,
    blocks_hit) tensors with a leading template axis; per row the same as
    `time_dependent_threshold` + `detect_candidates`, exact when
    n_above <= k and blocks_hit <= k_blocks.

    `margin` widens the comparison to ``cc > thr - margin`` (the returned
    thresholds stay the true ones).  `fused=True` takes the rms path
    through `RmsExtractionPlan`; 'mad' always runs row by row."""
    ts = cc if isinstance(cc, torch.Tensor) else _f32(cc, resolve_device())
    ts = ts.to(torch.float32)
    dev = ts.device
    n = ts.shape[-1]
    threshold_type = threshold_type.lower()
    if threshold_type == "rms":
        win, shift, n_win = _rms_geometry(n, sliding_window_samp, overlap)
        n_noise = GAUSSIAN_SAMPLE_LEN
    elif threshold_type == "mad":
        win, shift, n_win = _mad_geometry(n, sliding_window_samp, overlap)
        n_noise = int(n)
    else:
        raise ValueError(
            f"threshold_type must be 'rms' or 'mad', got {threshold_type!r}"
        )
    if white_noise is None:
        white_noise = _noise(rng, n_noise)
    caps = _f32(caps, dev)
    if threshold_type == "rms" and fused:
        plan = _rms_plan(n, sliding_window_samp, overlap, white_noise, k,
                         k_blocks, device=dev)
        if plan.supported:
            return plan.extract(ts, caps, num_dev, margin)
    gauss = _f32(white_noise, dev)[:n_noise]
    rows = []
    for x, cap in zip(ts, caps):
        if threshold_type == "rms":
            thr = _tdt_rms(x, gauss, float(num_dev), win=win, shift=shift,
                           n_win=n_win)
        else:
            thr = _tdt_mad(x, gauss, float(num_dev), window=win,
                           shift=shift, n_win=n_win)
        rows.append(_candidate_extract_two_stage(
            x, torch.minimum(thr, cap), k, k_blocks, margin=margin))
    return tuple(torch.stack(parts) for parts in zip(*rows))


def detect_candidates(cc, threshold, k: int = 2048, margin: float = 0.0):
    """Top-k lags by threshold excess of one CC series, computed on its
    device, so only O(k) values reach the host.  Returns (indices,
    cc values, threshold values) as numpy, n_above and the kurtosis;
    entries beyond `n_above` are below threshold."""
    dev = cc.device if isinstance(cc, torch.Tensor) else resolve_device()
    cc = _f32(cc, dev)
    threshold = _f32(threshold, dev)
    k = min(k, cc.shape[0])
    idx, cc_vals, thr_vals, n_above, kurto = _candidate_extract_one_stage(
        cc, threshold, k, float(margin))
    return (idx.cpu().numpy(), cc_vals.cpu().numpy(),
            thr_vals.cpu().numpy(), int(n_above), float(kurto))


def time_dependent_threshold_pd(network_response, window: int,
                                num_dev: float = 15.0) -> np.ndarray:
    """The notebooks' host version of the BP detection threshold
    (BPMF/template_search.py:1490-1517): a trailing-window running median
    plus `num_dev` MADs, shifted by one sample so that each value uses
    strictly past samples.  pandas' rolling windows, imported here; the
    device pipeline uses `bp_detection_threshold`."""
    import pandas as pd
    from scipy.stats import median_abs_deviation

    s = pd.Series(np.asarray(network_response, np.float64))
    r = s.rolling(window=int(window))
    run_med = r.median().shift(1)
    run_mad = r.apply(median_abs_deviation, raw=True).shift(1)
    return (run_med + num_dev * run_mad).values
