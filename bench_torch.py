"""Benchmark program of the PyTorch port: the counterpart of `bench.py`.

    python3 bench_torch.py [--device cpu] [mode flags]
    python3 -m seismic_bpmf_tpu_torch [--device cpu] bench [mode flags]

Default run = parity gate of the kernels the headline uses against the
float64 oracles, then the headline matched-filter day-scan throughput,
then the extras (each a `#` line on stderr, all of them written to the
file named by --extras); the headline's JSON line is printed last.

Headline metric: matched-filter throughput in GMAC/s (templates x
channels x lags x template samples / wall time) for bench.py's tutorial
day (1 day @ 25 Hz = 2.16 M samples, 10 stations x 3 components,
200-sample templates, 128 templates), the data resident on the card,
through `ops.mf.MatchedFilterPlan`.  Completion is forced by fetching a
small decimated slice of the CC (the full CC stays on the card).

Other modes (each prints its own JSON line):
  --check           parity gate of every kernel (#1 both designs, #2, #3)
  --bp [--n-src N]  beamforming throughput (Gpoints/s) on the smooth
                    lattice (`tools/lattice.py`); --n-src 1000000
                    --n-sta 128 is BASELINE config 5 as bench.py runs it
  --phasenet        PhaseNet day inference on the card (s/day)

Each JSON line has bench.py's keys and metric names: {"metric", "value",
"unit", "vs_baseline"}.  The unit names the card and its power limit
(nvidia-smi); `vs_baseline` divides by bench.py's CPU constants.  The
rungs keep the JAX package's names: 'highest' runs kernel #1's
'highest' build (csrc/mf.cu, its partials summed outside the tensor
cores), 'high' kernel #2 (bf16 parts), 'default' kernel #1's default build
(csrc/mf.cu: four TF32 products by `wgmma`, f32 class, where the JAX
package's 'default' is one bf16 pass);
every BP rung runs kernel #3 in f32.

Everything runs on the card unless --device cpu is given, which runs the
kernels' plain PyTorch versions (figures of the CPU, not of a card).
Without a card the run prints its JSON line with value 0.0 and exits 1.
A failed or crashed parity rung, a crashed mode and a crashed extra each
end the run with exit code 1 (an extra after the headline's line).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from seismic_bpmf_tpu_torch import _build
from seismic_bpmf_tpu_torch._device import resolve_device
from seismic_bpmf_tpu_torch.models.phasenet import (
    init_phasenet, phasenet_probas_device,
)
from seismic_bpmf_tpu_torch.ops import bp, mf
from seismic_bpmf_tpu_torch.ops import reference as port_reference
from seismic_bpmf_tpu_torch.ops.thresholds import RmsExtractionPlan
from seismic_bpmf_tpu_torch.tools.lattice import (
    closest_weights, smooth_grid_moveouts,
)
from seismic_bpmf_tpu_torch.utils.observe import bp_bound_ms, mf_bound_ms

# bench.py's constants: reference-style single-core CPU throughputs
CPU_BASELINE_GMACS = 2.0     # normalized CC, GMAC/s
CPU_BASELINE_GPTS = 0.02     # beamforming, Gpoints/s

N_STA, N_COMP, L_MF, N_TP = 10, 3, 200, 128
DAY_SAMPLES = 2_160_000               # 1 day @ 25 Hz
MF_TOL = 5e-6                         # every MF rung against the oracle
BP_TOL = {"highest": 2e-5, "high": 2e-4}
BP_CHUNK_SAMPLES = 16 * 1024          # bench.py's 16 time blocks of 1,024
EXTRAS_FILE = "BENCH_TORCH_EXTRAS.json"

# the kernel behind each MF rung: (wrapper, what it is)
MF_KERNELS = {
    "highest": (mf.mf_cc_highest, "kernel #1 csrc/mf.cu 'highest' build, "
                                  "four TF32 products by wgmma, partials "
                                  "summed outside the tensor cores"),
    "high": (mf.mf_cc_split, "kernel #2 csrc/mf_split.cu, three bf16 "
                             "products"),
    "default": (mf.mf_cc, "kernel #1 csrc/mf.cu default build, four TF32 "
                          "products by wgmma (f32 class; one bf16 pass in "
                          "the JAX package)"),
}


def card_label(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; on the
    CPU, a label that says no card ran."""
    if dev.type != "cuda":
        return "cpu (plain PyTorch versions, no card)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        out = f"{torch.cuda.get_device_name(dev)}, power limit not read"
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _through(wrapper, dev: torch.device, fn):
    """`fn()`, which must launch `wrapper`'s kernel at least once on a
    card (on the CPU the wrapper runs its plain version)."""
    before = wrapper.launches
    out = fn()
    if dev.type == "cuda" and wrapper.launches == before:
        raise RuntimeError(f"{wrapper.__name__} launched no kernel")
    return out


def _cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event ms of `fn` over `reps` back-to-back calls, warm."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _kernel_line(wrapper, ms: float, bound: tuple, what: str) -> None:
    """A `#` line: the kernel's CUDA-event ms beside its bound
    (`utils.observe`, against the H100's data-sheet peaks)."""
    print(f"# kernel {wrapper.__name__}: {ms:.2f} ms {what} (CUDA events), "
          f"bound {bound[0]:.2f} ms ({bound[1]})", file=sys.stderr)


# ---------------------------------------------------------------------------
# parity gate
# ---------------------------------------------------------------------------

def _rung(name: str, fn) -> bool:
    """Run one parity rung, `fn() -> (ok, detail)`, and print its line; a
    rung that raises is a FAIL line, and the other rungs still run (the
    caller exits 1 on any failure)."""
    try:
        ok, detail = fn()
    except Exception as e:  # noqa: BLE001 -- a crashed rung is a FAIL
        ok, detail = False, f"CRASH {_crash(e)}"
    print(f"# parity {name}: {detail} {'OK' if ok else 'FAIL'}",
          file=sys.stderr)
    return ok


def parity_inputs() -> dict:
    """bench.py's parity inputs (`check_parity`, rng 7), drawn in its
    order: the MF bank and data, then the BP features, moveouts and
    source weights."""
    rng = np.random.default_rng(7)
    n_tp, n_sta, n_comp, L, n_samp = 16, 5, 3, 100, 20_000
    data = rng.normal(size=(n_sta, n_comp, n_samp)).astype(np.float32)
    tp = rng.normal(size=(n_tp, n_sta, n_comp, L)).astype(np.float32)
    mv = rng.integers(0, 150, size=(n_tp, n_sta, n_comp)).astype(np.int32)
    w = rng.uniform(0.5, 1.0, size=(n_tp, n_sta, n_comp)).astype(np.float32)
    w /= w.sum(axis=(1, 2), keepdims=True)
    n_src, n_ph, n_samp_bp = 200, 2, 8_192
    feat = rng.normal(size=(n_sta, n_comp, n_samp_bp)).astype(np.float32)
    mv_bp = rng.integers(0, 300, size=(n_src, n_sta, n_ph)).astype(np.int32)
    w_ph = np.zeros((n_sta, n_comp, n_ph), np.float32)
    w_ph[:, 2, 0] = 1.0
    w_ph[:, :2, 1] = 0.5
    w_src = rng.uniform(0.5, 1.0, size=(n_src, n_sta)).astype(np.float32)
    w_sparse = w_src.copy()
    w_sparse[:, ::2] = 0.0  # dead (station-phase, source tile) pairs
    return dict(data=data, tp=tp, mv=mv, w=w, feat=feat, mv_bp=mv_bp,
                w_ph=w_ph, w_src=w_src, w_sparse=w_sparse)


def mf_oracle(tp, mv, w, data, reference=port_reference) -> np.ndarray:
    """(n_tp, n_corr) float32 network CC at every lag, computed in float64
    by `reference.matched_filter_at` (the port's `ops.reference`, or a
    module with the same functions): the CC of `matched_filter`,
    vectorized (bench.py's oracle, whose per-lag loop takes about a minute
    at the parity shape)."""
    n_corr = data.shape[-1] - tp.shape[-1] + 1
    lags = np.arange(n_corr)
    cc = np.zeros((tp.shape[0], n_corr), np.float32)
    for t in range(tp.shape[0]):
        for a in range(0, n_corr, 4096):
            cc[t, a: a + 4096] = reference.matched_filter_at(
                tp[t], mv[t], w[t], data, lags[a: a + 4096])
    return cc


def bp_oracles(x: dict, reference=port_reference) -> dict:
    """`reference.beamform` of the BP parity inputs: (max, argmax), the
    whole beam, and (max, argmax) with every other station dead."""
    feat, mv_bp, w_ph = x["feat"], x["mv_bp"], x["w_ph"]
    return {
        "bp_max": reference.beamform(feat, mv_bp, w_ph, x["w_src"],
                                     reduce="max"),
        "bp_none": reference.beamform(feat, mv_bp, w_ph, x["w_src"],
                                      reduce="none"),
        "bp_sparse": reference.beamform(feat, mv_bp, w_ph, x["w_sparse"],
                                        reduce="max"),
    }


def parity_oracles(x: dict, mf_only: bool = False) -> dict:
    """The port's float64 oracles of `parity_inputs` (the BP ones unless
    `mf_only`)."""
    out = {"mf": mf_oracle(x["tp"], x["mv"], x["w"], x["data"])}
    if not mf_only:
        out.update(bp_oracles(x))
    return out


def check_parity(quick: bool = False, device=None) -> bool:
    """Every kernel against the float64 oracles on bench.py's small
    parity shapes: MF at 'highest' (kernel #1's 'highest' build),
    'high' (kernel #2) and 'default' (kernel #1's default build), within
    5e-6; BP (kernel #3) at 'highest' and 'high' in both reduce modes
    (2e-5 / 2e-4, the argmax equal everywhere at 'highest' and at more
    than 99.9% of the samples otherwise) and with every other station
    dead (2e-4, >= 99.9%).  `quick` gates only the MF rungs.  Each rung
    runs through `_rung`, so a crash is a FAIL and the others still run;
    returns True when every rung passed."""
    dev = resolve_device(device)
    x = parity_inputs()
    ref = parity_oracles(x, mf_only=quick)
    ok = True
    n_samp = x["data"].shape[-1]

    def mf_rung(prec):
        def fn():
            wrapper = MF_KERNELS[prec][0]
            plan = mf.MatchedFilterPlan(x["tp"], x["mv"], x["w"], n_samp,
                                        precision=prec, device=dev)
            data_pad = plan.pad_data(x["data"])
            cc = _through(wrapper, dev, lambda: plan(data_pad)).cpu().numpy()
            err = float(np.abs(cc - ref["mf"]).max())
            return err <= MF_TOL, f"max|diff|={err:.2e}"
        return fn

    for prec in ("highest", "high", "default"):
        ok &= _rung(f"MF[{prec}]", mf_rung(prec))
    if quick:
        return ok

    n_samp_bp = x["feat"].shape[-1]

    def beam(w_src, reduce, prec):
        plan = bp.BeamformPlan(x["mv_bp"], x["w_ph"], w_src, n_samp_bp,
                               reduce=reduce, precision=prec, device=dev)
        out = _through(bp.bp_beam, dev, lambda: plan(x["feat"]))
        if reduce == "none":
            return out.cpu().numpy()
        return out[0].cpu().numpy(), out[1].cpu().numpy()

    def bp_rung(prec):
        def fn():
            mb_ref, ms_ref = ref["bp_max"]
            mb, ms = beam(x["w_src"], "max", prec)
            err = float(np.abs(mb - mb_ref).max())
            agree = float(np.mean(ms == ms_ref))
            err_none = float(np.abs(beam(x["w_src"], "none", prec)
                                    - ref["bp_none"]).max())
            am_ok = agree == 1.0 if prec == "highest" else agree > 0.999
            tol = BP_TOL[prec]
            return err <= tol and err_none <= tol and am_ok, (
                f"max|diff| max={err:.2e} none={err_none:.2e} "
                f"argmax_agree={agree:.4f}")
        return fn

    for prec in ("highest", "high"):
        ok &= _rung(f"BP[{prec}]", bp_rung(prec))

    def bp_sparse():
        mb_ref, ms_ref = ref["bp_sparse"]
        mb, ms = beam(x["w_sparse"], "max", "high")
        err = float(np.abs(mb - mb_ref).max())
        agree = float(np.mean(ms == ms_ref))
        return err <= BP_TOL["high"] and agree >= 0.999, (
            f"max|diff|={err:.2e} argmax_agree={agree:.4f}")

    ok &= _rung("BP[high,sparse]", bp_sparse)
    return ok


# ---------------------------------------------------------------------------
# matched filter
# ---------------------------------------------------------------------------

def mf_day_inputs(kind: str = "headline", n_tp: int = N_TP,
                  n_samp: int = DAY_SAMPLES) -> tuple:
    """bench.py's MF day (rng 0), drawn in its order: data, templates,
    moveouts in [0, 400), uniform weights; for 'extraction' and 'screen'
    the 500-sample noise table; for 'screen' also ~10 occurrences of every
    4th template injected at 0.5.  Returns (data, tp, mv, w, white_noise
    or None)."""
    if kind not in ("headline", "extraction", "screen"):
        raise ValueError(f"unknown MF day {kind!r}")
    rng = np.random.default_rng(0)
    data = rng.normal(size=(N_STA, N_COMP, n_samp)).astype(np.float32)
    tp = rng.normal(size=(n_tp, N_STA, N_COMP, L_MF)).astype(np.float32)
    mv = rng.integers(0, 400, size=(n_tp, N_STA, N_COMP)).astype(np.int32)
    w = np.full((n_tp, N_STA, N_COMP), 1.0 / (N_STA * N_COMP), np.float32)
    if kind == "headline":
        return data, tp, mv, w, None
    wn = rng.normal(size=500).astype(np.float32)
    if kind == "screen":
        for t in range(0, n_tp, 4):
            for o in rng.integers(0, n_samp - 1200, size=10):
                for s in range(N_STA):
                    for c in range(N_COMP):
                        b = int(o) + int(mv[t, s, c])
                        data[s, c, b: b + L_MF] += 0.5 * tp[t, s, c]
    return data, tp, mv, w, wn


def _sig(x: float) -> float:
    """`x` to 6 significant digits (bench.py rounds to decimals, which
    would print a small CPU figure as 0.0)."""
    return float(f"{x:.6g}")


def _macs(plan) -> float:
    return float(plan.n_tp) * plan.n_ch * plan.n_corr_unit * plan.L


def bench_mf(precision: str = "high", device=None, n_tp: int = N_TP,
             n_samp: int = DAY_SAMPLES) -> dict:
    """Headline MF day-scan throughput: one plan of the bank, the day
    uploaded once, median of 5 wall-clock runs each ending in a fetch of
    every 200,000th lag (the full CC stays on the card)."""
    dev = resolve_device(device)
    wrapper, what = MF_KERNELS[precision]
    data, tp, mv, w, _ = mf_day_inputs("headline", n_tp, n_samp)
    plan = mf.MatchedFilterPlan(tp, mv, w, n_samp, precision=precision,
                                device=dev)
    data_pad = plan.pad_data(data)
    del data

    def run():
        out = _through(wrapper, dev, lambda: plan(data_pad))
        return out[:, ::200000].cpu()

    run()  # warm
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    if dev.type == "cuda":
        _kernel_line(wrapper, _cuda_ms(lambda: plan(data_pad), 5),
                     mf_bound_ms(plan, data_pad), "a day-call")
    gmacs = _macs(plan) / dt / 1e9
    return {
        "metric": "matched_filter_throughput",
        "value": _sig(gmacs),
        "unit": f"GMAC/s on {card_label(dev)} ({n_tp} templates x "
                f"{N_STA * N_COMP} ch x {n_samp} samples @ 25 Hz, "
                f"{precision}: {what}, median of 5; min-rep "
                f"{_macs(plan) / min(times) / 1e9:.0f})",
        "vs_baseline": _sig(gmacs / CPU_BASELINE_GMACS),
    }


def _to_host(t: torch.Tensor) -> tuple:
    """Queue `t`'s copy to the host (pinned memory on a card) and mark
    the stream there: the copy runs before any work queued later."""
    if not t.is_cuda:
        return t.clone(), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _host(pend: tuple) -> torch.Tensor:
    host, done = pend
    if done is not None:
        done.synchronize()
    return host


def _pipelined_median(step, consume, arg, reps: int = 6,
                      sets: int = 3) -> float:
    """Steady-state campaign pipeline (bench.py's): day N+1's work is
    queued on the stream before day N's result is read on the host, so
    the host's fetch and refine overlap the card's next day.  Median s a
    day over `sets` sets of `reps` days."""
    dts = []
    for _ in range(sets):
        t0 = time.perf_counter()
        pend = step(arg)
        for _ in range(reps - 1):
            nxt = step(arg)
            consume(pend)
            pend = nxt
        consume(pend)
        dts.append((time.perf_counter() - t0) / reps)
    return float(np.median(dts))


def _extraction_day(kind: str, precision: str, margin: float, device,
                    n_tp: int, n_samp: int) -> tuple:
    """The plan, padded day, extraction plan and the queued day step of
    the extraction and screen extras (bench.py's 1800 s window, overlap
    0.25, k = 1024, caps 0.8, 8 deviations)."""
    dev = resolve_device(device)
    wrapper = MF_KERNELS[precision][0]
    data, tp, mv, w, wn = mf_day_inputs(kind, n_tp, n_samp)
    plan = mf.MatchedFilterPlan(tp, mv, w, n_samp, precision=precision,
                                device=dev)
    data_pad = plan.pad_data(data)
    eplan = RmsExtractionPlan(plan.n_corr_unit, int(1800.0 * 25.0),
                              overlap=0.25, white_noise=wn, k=1024,
                              device=dev)
    caps = torch.full((n_tp,), 0.8, dtype=torch.float32, device=dev)

    def step(d):
        cc = torch.nan_to_num(_through(wrapper, dev, lambda: plan(d)))
        return _to_host(eplan.extract(cc, caps, 8.0, margin=margin,
                                      pack=True))

    return dev, plan, data_pad, eplan, step, (data, tp, mv, w)


def bench_mf_extraction(precision: str = "high", device=None,
                        n_tp: int = N_TP, n_samp: int = DAY_SAMPLES) -> dict:
    """Sustained MF throughput including the detection extraction: the
    headline day, each day's CC through the batched rms threshold and
    two-stage top-k (`RmsExtractionPlan.extract(pack=True)`), queued
    behind the scan, one packed fetch a day (`unpack`)."""
    dev, plan, data_pad, eplan, step, _ = _extraction_day(
        "extraction", precision, 0.0, device, n_tp, n_samp)

    def consume(pend):
        return eplan.unpack(_host(pend))

    consume(step(data_pad))  # warm
    dt = _pipelined_median(step, consume, data_pad)
    gmacs = _macs(plan) / dt / 1e9
    return {
        "metric": "matched_filter_with_extraction",
        "value": _sig(gmacs),
        "unit": f"GMAC/s on {card_label(dev)} sustained incl. threshold+"
                f"top-k extraction ({n_tp} templates x 1 day, {precision}: "
                f"{MF_KERNELS[precision][1]}, 6-day pipelined steady "
                f"state)",
        "vs_baseline": _sig(gmacs / CPU_BASELINE_GMACS),
    }


def bench_mf_screen(device=None, n_tp: int = N_TP,
                    n_samp: int = DAY_SAMPLES) -> dict:
    """Screen-mode sustained throughput: the injected day at 'default'
    (kernel #1's default build) with margin-widened extraction (0.01),
    then the exact float64 host refine of every candidate
    (`ops.reference.matched_filter_at`), day N's refine overlapping day
    N+1's scan."""
    dev, plan, data_pad, eplan, step, (data, tp, mv, w) = _extraction_day(
        "screen", "default", 0.01, device, n_tp, n_samp)

    def refine(pend):
        idx, _, _, n_above = eplan.unpack(_host(pend))[:4]
        n_ref = 0
        for t in range(n_tp):
            n = min(int(n_above[t]), idx.shape[1])
            if n:
                port_reference.matched_filter_at(tp[t], mv[t], w[t], data,
                                                 idx[t, :n])
                n_ref += n
        return n_ref

    n_ref = refine(step(data_pad))  # warm
    dt = _pipelined_median(step, refine, data_pad)
    if dev.type == "cuda":
        _kernel_line(mf.mf_cc, _cuda_ms(lambda: plan(data_pad), 5),
                     mf_bound_ms(plan, data_pad), "a day-call")
    gmacs = _macs(plan) / dt / 1e9
    return {
        "metric": "matched_filter_detection_parity_throughput",
        "value": _sig(gmacs),
        "unit": f"GMAC/s on {card_label(dev)} sustained incl. extraction + "
                f"exact refine of {n_ref} candidates/day ({n_tp} templates "
                f"x 1 day, screen: {MF_KERNELS['default'][1]}, 6-day "
                f"pipelined steady state)",
        "vs_baseline": _sig(gmacs / CPU_BASELINE_GMACS),
    }


# ---------------------------------------------------------------------------
# beamforming
# ---------------------------------------------------------------------------

def bp_inputs(n_src: int = 100_000, n_sta: int = 32,
              n_samp: int = DAY_SAMPLES) -> tuple:
    """bench.py's BP day: the lattice's moveouts (seed 1), P on the
    vertical and S on the horizontals, closest-10 source weights, and
    uniform features from rng 0.  Returns (mv, w_ph, w_src, features)."""
    rng = np.random.default_rng(0)
    mv = smooth_grid_moveouts(n_src, n_sta)
    w_ph = np.zeros((n_sta, N_COMP, 2), np.float32)
    w_ph[:, 2, 0] = 1.0   # P on vertical
    w_ph[:, :2, 1] = 0.5  # S on horizontals
    w_src = closest_weights(mv, 10)
    feat = rng.uniform(0, 1, size=(n_sta, N_COMP, n_samp)).astype(np.float32)
    return mv, w_ph, w_src, feat


def bench_bp(n_src: int = 100_000, n_sta: int = 32,
             precision: str = "highest", budget_s: float = 90.0,
             device=None, n_samp: int = DAY_SAMPLES) -> dict:
    """Beamforming throughput on the smooth lattice: the day's folded
    features on the card, then kernel #3 (`ops.bp.bp_beam`) over
    consecutive chunks of whole time tiles, as near 16 x 1,024 samples as
    the tiles allow, each ending in a fetch; as many chunks as fit in
    `budget_s` are timed, and the figure is their rate."""
    dev = resolve_device(device)
    mv, w_ph, w_src, feat = bp_inputs(n_src, n_sta, n_samp)
    t_setup = time.perf_counter()
    plan = bp.BeamformPlan(mv, w_ph, w_src, n_samp, reduce="max",
                           precision=precision, device=dev)
    g_pad = plan.fold_and_pad(feat)
    del feat
    _sync(dev)
    tab = plan.tables
    print(f"# bp plan+fold: {time.perf_counter() - t_setup:.1f}s "
          f"({tab.n_tiles} source tiles, {tab.n_stages} stages, "
          f"{tab.n_pairs} used pairs, {plan.n_t_blocks} time tiles)",
          file=sys.stderr)
    tiles_per = min(plan.n_t_blocks,
                    max(1, round(BP_CHUNK_SAMPLES / bp.TIME_TILE)))
    samp_per = tiles_per * bp.TIME_TILE

    def launch(c):
        return _through(bp.bp_beam, dev, lambda: bp.bp_beam(
            g_pad, tab, reduce="max", tile0=c * tiles_per, n_tt=tiles_per))

    def chunk(c):
        v, i = launch(c)
        return v[::20000].cpu(), i[::20000].cpu()

    t_setup = time.perf_counter()
    chunk(0)  # warm
    print(f"# bp warm chunk: {time.perf_counter() - t_setup:.1f}s",
          file=sys.stderr)
    n_chunks_total = plan.n_t_blocks // tiles_per
    done, t_start = 0, time.perf_counter()
    while done < n_chunks_total and time.perf_counter() - t_start < budget_s:
        chunk(done % n_chunks_total)
        done += 1
    dt = time.perf_counter() - t_start
    if dev.type == "cuda":
        def day():
            for c in range(n_chunks_total):
                launch(c)
        _kernel_line(bp.bp_beam, _cuda_ms(day, 1),
                     bp_bound_ms(tab, g_pad, n_chunks_total * samp_per),
                     f"a day ({n_chunks_total} chunk launches)")
    gpts = n_src * done * samp_per / dt / 1e9
    day_s = n_samp / (gpts * 1e9 / n_src)
    return {
        "metric": "beamform_throughput",
        "value": _sig(gpts),
        "unit": f"Gpoints/s on {card_label(dev)} ({n_src} src x {n_sta} "
                f"sta, {precision}: kernel #3 csrc/bp.cu in f32 at every "
                f"rung; {done}/{n_chunks_total} day-chunks of {tiles_per} "
                f"time tiles ({samp_per} samples) measured -> "
                f"{day_s:.2f} s/day)",
        "vs_baseline": _sig(gpts / CPU_BASELINE_GPTS),
    }


# ---------------------------------------------------------------------------
# PhaseNet
# ---------------------------------------------------------------------------

def bench_phasenet(device=None, n_sta: int = N_STA,
                   n_samp: int = DAY_SAMPLES) -> dict:
    """PhaseNet day inference with the day resident on the card: the
    Z-score, every window's forward (cuDNN, IEEE f32) and the overlap
    average, median of 5 runs each ending in a fetch of every 200,000th
    sample.  Seeded random weights (no checkpoint is in the repository)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n_sta, 3, n_samp)).astype(np.float32)
    model = init_phasenet(torch.Generator().manual_seed(0), device=dev)
    xd = torch.from_numpy(x).to(dev)

    def run():
        probas = phasenet_probas_device(model, xd)
        return probas[:, :, ::200000].cpu()

    run()  # warm
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    return {
        "metric": "phasenet_day_inference",
        "value": _sig(dt),
        "unit": f"s/day on {card_label(dev)} ({n_sta} sta x 3 comp x "
                f"{n_samp} samples, device-resident, f32, median of 5)",
        "vs_baseline": _sig(60.0 / dt),  # ~1 min/day torch-CPU
    }


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def probe_backend(timeout_s: float = 420.0, device=None):
    """Bounded device probe: resolve the device and run a small matmul
    there in a worker thread.  Returns None, or a short diagnostic when
    it raises or is still blocked after `timeout_s`."""
    result: dict = {}

    def work():
        try:
            dev = resolve_device(device)
            a = torch.ones((128, 128), device=dev)
            result["ok"] = float((a @ a).sum().item())
        except Exception as e:  # noqa: BLE001 -- reported to the caller
            result["err"] = (f"{type(e).__name__}: "
                             f"{' '.join(str(e).split())[:200]}")

    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        return f"device init still blocked after {timeout_s:.0f}s"
    return result.get("err")


def _zero(metric: str, unit: str, why: str) -> dict:
    return {"metric": metric, "value": 0.0, "unit": f"{unit} ({why})",
            "vs_baseline": 0.0}


def _crash(e: Exception) -> str:
    return f"{type(e).__name__}: {' '.join(str(e).split())[:200]}"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="bench_torch.py",
        description="Benchmark of the PyTorch port (bench.py's metrics).")
    ap.add_argument("--check", action="store_true",
                    help="kernel parity gate only")
    ap.add_argument("--bp", action="store_true",
                    help="beamform throughput instead of matched filter")
    ap.add_argument("--n-src", type=int, default=100_000)
    ap.add_argument("--n-sta", type=int, default=32,
                    help="BP: station count (BASELINE config 5 uses 128)")
    ap.add_argument("--precision", default=None,
                    choices=["highest", "high", "default"],
                    help="rung (default: 'high' for the MF headline, "
                         "'highest' for --bp; every BP rung runs kernel "
                         "#3 in f32)")
    ap.add_argument("--budget-s", type=float, default=90.0,
                    help="BP: steady-state measurement budget in seconds")
    ap.add_argument("--phasenet", action="store_true",
                    help="PhaseNet day-inference metric")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the parity gate before the headline")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions)")
    ap.add_argument("--extras", default=EXTRAS_FILE,
                    help="file the default run writes its extras to")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    metric, unit = (("tpu_kernel_parity", "bool") if args.check
                    else ("beamform_throughput", "Gpoints/s") if args.bp
                    else ("phasenet_day_inference", "s/day") if args.phasenet
                    else ("matched_filter_throughput", "GMAC/s"))
    err = probe_backend(float(os.environ.get("BENCH_INIT_TIMEOUT_S", "420")),
                        args.device)
    if err is None and resolve_device(args.device).type == "cuda":
        try:
            t0 = time.perf_counter()
            _build.build_all()
            print(f"# build: {time.perf_counter() - t0:.1f}s",
                  file=sys.stderr)
        except RuntimeError as e:
            err = f"kernel build failed: {_crash(e)}"
    if err is not None:
        print(json.dumps(_zero(metric, unit,
                               f"DEVICE UNAVAILABLE: {err}")))
        return 1
    dev = resolve_device(args.device)

    if args.check:
        ok = check_parity(device=dev)
        print(json.dumps({
            "metric": "tpu_kernel_parity",
            "value": 1 if ok else 0,
            "unit": f"bool (MF kernels #1 both designs and #2, BP kernel #3, "
                    f"against the float64 oracles, on {card_label(dev)})",
            "vs_baseline": 1.0,
        }))
        return 0 if ok else 1

    if args.bp or args.phasenet:
        try:
            result = (bench_bp(n_src=args.n_src, n_sta=args.n_sta,
                               precision=args.precision or "highest",
                               budget_s=args.budget_s, device=dev)
                      if args.bp else bench_phasenet(device=dev))
        except Exception as e:  # noqa: BLE001 -- one parseable line, exit 1
            print(json.dumps(_zero(metric, unit, f"CRASH: {_crash(e)}")))
            return 1
        print(json.dumps(result))
        return 0

    if not args.no_check and not check_parity(quick=True, device=dev):
        print(json.dumps(_zero(metric, unit, "PARITY GATE FAILED")))
        return 1
    try:
        result = bench_mf(precision=args.precision or "high", device=dev)
    except Exception as e:  # noqa: BLE001 -- one parseable line, exit 1
        print(json.dumps(_zero(metric, unit, f"HEADLINE CRASH: {_crash(e)}")))
        return 1
    failed = []
    if not os.environ.get("BENCH_QUICK"):
        extras = {}
        for name, fn in (
            ("mf_extraction", lambda: bench_mf_extraction(device=dev)),
            ("mf_screen", lambda: bench_mf_screen(device=dev)),
            # bench.py's extra: 100k sources keeps the plan build inside
            # the run's budget on the same chunked path as --bp
            ("beamform", lambda: bench_bp(n_src=100_000, budget_s=60.0,
                                          precision="high", device=dev)),
            ("phasenet", lambda: bench_phasenet(device=dev)),
        ):
            try:
                r = fn()
                extras[name] = r
                print(f"# {r['metric']}: {r['value']} {r['unit']}",
                      file=sys.stderr)
            except Exception as e:  # noqa: BLE001 -- reported, exit 1
                failed.append(name)
                print(f"# {name} extra failed: {_crash(e)}", file=sys.stderr)
        try:
            with open(args.extras, "w") as fh:
                json.dump(extras, fh, indent=1)
        except OSError as e:
            failed.append("extras file")
            print(f"# extras not written to {args.extras}: {_crash(e)}",
                  file=sys.stderr)
    print(json.dumps(result))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
