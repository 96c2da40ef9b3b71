"""The plain reference of the matched-filter campaign day, and the
comparison that decides `correct` for an MF cell.

It imports nothing of the program.  From the world's raw inputs (each pool
day as float32 samples, the templates, their moveouts) it works out again
what the program derives: the RMS-normalized day (float32, as the day is
handed to the scan), its bf16 rounding for the `screen` rung, the
channel weights ('simple' weights, the validity rule, normalized to sum 1),
the demeaned templates over their norms, and the network-summed normalized
CC in float64: per template, the weight-summed Pearson CC of every
channel's demeaned template against the data window that starts at
lag + moveout; a window of variance <= 1e-10, or one that leaves the day,
gives 0.

`precision="bf16"` is the control: the same CC with the day and the
scaled template rows rounded to bf16 and the sums taken in float32.
"""

from __future__ import annotations

import types

import numpy as np

NAMES = ("cc_gap", "det_cc_gap", "missed")


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bf16 (ties to even), as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def normalized_day(day: np.ndarray) -> np.ndarray:
    """(n_sta, 3, n) float32 -> each channel over its float32 standard
    deviation (1 where that is 0), float32."""
    arr = np.asarray(day, np.float32)
    norm = np.std(arr, axis=-1, keepdims=True)
    norm[norm == 0.0] = 1.0
    return arr / norm


def channel_weights(templates: np.ndarray, min_channels: int,
                    min_stations: int) -> np.ndarray:
    """(n_tp, n_sta, 3) float32: 1 on each channel with data, 0 for a
    template with fewer than `min_channels` channels or `min_stations`
    stations, each template's weights over their sum."""
    w = np.any(templates != 0.0, axis=-1).astype(np.float32)
    invalid = ((np.sum(w != 0.0, axis=(1, 2)) < min_channels)
               | (np.sum(np.sum(w, axis=2) > 0.0, axis=1) < min_stations))
    w[invalid] = 0.0
    norm = w.sum(axis=(1, 2), keepdims=True)
    norm[norm == 0.0] = 1.0
    return w / norm


def keywords(world, traffic: dict) -> dict:
    """The scan's keywords: the configuration's, under the mix's."""
    return {**world.sizes["scan_kwargs"], **traffic.get("engine", {})}


def scans_bf16(world, traffic: dict) -> bool:
    """Whether the scan runs on the bf16 day: the `screen` rung, which
    `scan_days` takes where the mix names none."""
    return keywords(world, traffic).get("precision", "screen") == "screen"


class Reference:
    """The reference of one world on `device` (plain torch ops), with the
    scan's keywords `kw` (the configuration's where None)."""

    def __init__(self, world, device, precision: str = "f64", kw=None):
        import torch

        self.torch = torch
        self.world = world
        self.device = torch.device(device)
        self.precision = precision
        kw = world.sizes["scan_kwargs"] if kw is None else kw
        tpl = np.asarray(world.templates, np.float64)
        n_tp, n_sta, n_c, L = tpl.shape
        self.n_ch, self.L = n_sta * n_c, L
        w = channel_weights(world.templates, kw["min_channels"],
                            kw["min_stations"]).astype(np.float64)
        dm = tpl - tpl.mean(axis=-1, keepdims=True)
        norm = np.sqrt((dm ** 2).sum(-1))
        scale = np.where(norm > 0, w / np.maximum(norm, 1e-30), 0.0)
        rows = (dm * scale[..., None]).reshape(n_tp, self.n_ch, L)
        if precision == "bf16":
            rows = bf16_round(rows.astype(np.float32))
        self.dtype = torch.float64 if precision == "f64" else torch.float32
        self.rows = torch.from_numpy(np.ascontiguousarray(rows)).to(
            self.device, self.dtype)
        self.mv = torch.from_numpy(
            world.moveouts.reshape(n_tp, self.n_ch).astype(np.int64)).to(
                self.device)
        self._days: dict = {}

    def day(self, k: int, bf16: bool):
        """Pool day `k` normalized (and rounded to bf16), (n_ch, n)."""
        key = (k, bf16)
        if key not in self._days:
            x = normalized_day(self.world.pool.days[k])
            if bf16 or self.precision == "bf16":
                x = bf16_round(x)
            self._days[key] = self.torch.from_numpy(
                x.reshape(self.n_ch, -1)).to(self.device, self.dtype)
        return self._days[key]

    def cc_at(self, day, tids: np.ndarray, lags: np.ndarray,
              block: int = 2048) -> np.ndarray:
        """Network CC of template `tids[i]` at lag `lags[i]` on `day`."""
        torch = self.torch
        n = day.shape[1]
        L = self.L
        taps = torch.arange(L, device=self.device)
        ch = torch.arange(self.n_ch, device=self.device)[None, :, None]
        out = []
        for s in range(0, len(tids), block):
            t = torch.from_numpy(np.asarray(tids[s:s + block], np.int64)).to(
                self.device)
            lag = torch.from_numpy(np.asarray(lags[s:s + block], np.int64)).to(
                self.device)
            start = lag[:, None] + self.mv[t]                    # (m, n_ch)
            valid = (start >= 0) & (start + L <= n)
            idx = start.clamp(0, max(n - L, 0))[..., None] + taps
            x = day[ch, idx]                                     # (m, n_ch, L)
            r1 = x.sum(-1)
            r2 = (x * x).sum(-1)
            var = r2 - r1 * r1 / L
            y = torch.where(var > 1e-10, torch.rsqrt(var.clamp(min=1e-30)),
                            torch.zeros_like(var))
            corr = (x * self.rows[t]).sum(-1)
            out.append(((corr * y) * valid).sum(-1).double().cpu().numpy())
        return np.concatenate(out) if out else np.zeros(0)


def sample_plan(world, seed: int, day: int, n_templates: int,
                n_windows_lags: int) -> list:
    """The (template, first lag) of the CC windows compared on campaign
    day `day`: `n_templates` templates drawn from the seed, each with a
    window at a drawn lag, one at the day's last lags (windows leaving the
    day) and one around its first event of the day."""
    p = world.problem
    rng = np.random.default_rng([seed, 31, day])
    k = day % len(world.pool)
    w = n_windows_lags
    last = p["n_lags"] - w
    plan = []
    for t in rng.choice(p["n_templates"], n_templates, replace=False):
        o = int(world.origins[k][t, 0])
        plan += [(int(t), int(rng.integers(0, last + 1))), (int(t), last),
                 (int(t), int(min(max(o - w // 2, 0), last)))]
    return plan


def event_lag(ev, t0_epoch: float, sr: float) -> int:
    return int(round((ev.origin_time_epoch - t0_epoch) * sr))


def compare(world, traffic: dict, record, device, check: dict) -> dict:
    """The numbers of an MF cell on each checked day: the widest gap of the
    sampled CC windows from the reference (`cc_gap`), of every detection's
    CC from the reference at its lag on the float32 day (`det_cc_gap`),
    and the planted events with no detection of their template at their
    lag (`missed`).  {day: {name: value}}."""
    ref = Reference(world, device, kw=keywords(world, traffic))
    screen = scans_bf16(world, traffic)
    sr = float(world.sizes["sampling_rate_hz"])
    t0 = world.pool.t0_epoch
    per_day = {}
    for i in record.days:
        k = i % len(world.pool)
        gap = float("inf") if not record.cc.get(i) else 0.0
        for t, start, vals in record.cc.get(i, []):
            lags = np.arange(start, start + len(vals))
            want = ref.cc_at(ref.day(k, screen), np.full(len(lags), t), lags)
            gap = max(gap, float(np.max(np.abs(
                np.asarray(vals, np.float64) - want))))
        tids, lags, ccs, found = [], [], [], set()
        for evs in record.detections.get(i, {}).values():
            for ev in evs:
                t = int(ev.aux_data["tid"])
                lag = event_lag(ev, t0, sr)
                tids.append(t)
                lags.append(lag)
                ccs.append(float(ev.aux_data["cc"]))
                found.add((t, lag))
        det_gap = 0.0
        if tids:
            want = ref.cc_at(ref.day(k, False), np.asarray(tids),
                             np.asarray(lags))
            det_gap = float(np.max(np.abs(np.asarray(ccs) - want)))
        o = world.origins[k]
        missed = sum((t, int(o[t, j])) not in found
                     for t in range(o.shape[0]) for j in range(o.shape[1]))
        per_day[i] = {"cc_gap": gap, "det_cc_gap": det_gap,
                      "missed": missed}
    return per_day


def control(world, traffic: dict, seed: int, days, device,
            check: dict) -> dict:
    """What the control puts in the program's place on `days` of the
    world a run with `seed` draws: the reference from bf16 operands with
    float32 sums, one precision below the float32 of every CC the
    configuration hands out.  For each day, as the window records them:
    `cc`, the CC windows such a run samples, [(template, first lag,
    values)]; `detections`, one at each planted event's lag with the
    control's CC there, {template: [event]}.  `compare` judges them."""
    ctl = Reference(world, device, precision="bf16",
                    kw=keywords(world, traffic))
    sr = float(world.sizes["sampling_rate_hz"])
    t0 = world.pool.t0_epoch
    width = check["cc_window_lags"]
    out = {}
    for i in days:
        k = i % len(world.pool)
        day = ctl.day(k, True)
        cc = []
        for t, start in sample_plan(world, seed, i, check["cc_templates"],
                                    width):
            lags = np.arange(start, start + width)
            cc.append((t, start, ctl.cc_at(day, np.full(width, t), lags)))
        o = world.origins[k]
        tids = np.repeat(np.arange(o.shape[0]), o.shape[1])
        lags = o.reshape(-1)
        dets: dict = {}
        for t, lag, v in zip(tids, lags, ctl.cc_at(day, tids, lags)):
            dets.setdefault(int(t), []).append(types.SimpleNamespace(
                origin_time_epoch=t0 + int(lag) / sr,
                aux_data={"tid": int(t), "cc": float(v)}))
        out[i] = {"cc": cc, "detections": dets}
    return out
