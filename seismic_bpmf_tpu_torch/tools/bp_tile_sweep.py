"""Checks and times the BP kernel's compile-time tile choices.

    python -m seismic_bpmf_tpu_torch.tools.bp_tile_sweep

Builds csrc/bp.cu once per BP_R (columns per lane) and prints ptxas's
register and spill report.  The first variant (the source's default) is
held against the plain PyTorch version at the main path's width (100,000
lattice sources x 32 stations x 2 phases, closest-10 weights,
tools/lattice.py) on a 2^13-sample window, for reduce='max' under both
policies and 'none'.
Then every variant runs one day (2,160,000 samples, uniform features,
`BeamformPlan.call_folded`, so the day's 11 chunk calls) and prints its
time (CUDA events, the best of 2 x 2 days) and whether it gives the first
variant's bits, with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from .. import _build
from ..ops import bp
from ..workflow import default_weights_phases
from .lattice import closest_weights, smooth_grid_moveouts

VARIANTS = [16, 8]    # BP_R; the first is the default of csrc/bp.cu
N_SRC, N_STA, N_DAY = 100_000, 32, 2_160_000


def _use(so: str, r: int):
    bp.TIME_TILE = 32 * r
    bp._BOUND.discard("bp")
    _build._LIBS["bp"] = ctypes.CDLL(so)


def _check(mv, w_ph, w_src, rng):
    """Kernel against the plain version on a short window."""
    n = 2**13
    feat = rng.uniform(0, 1, size=(N_STA, 3, n)).astype(np.float32)
    for reduce, oob in (("max", "strict"), ("max", "flexible"),
                        ("none", "strict")):
        plan = bp.BeamformPlan(mv, w_ph, w_src, n, reduce=reduce,
                               out_of_bounds=oob)
        g = plan.fold_and_pad(feat)
        got = bp.bp_beam(g, plan.tables, reduce=reduce)
        want = bp.beamform_plain(g, plan.tables, reduce=reduce)
        torch.cuda.synchronize()
        if reduce == "none":
            err = float((got - want).abs().max())
            print(f"check {reduce}/{oob}: max|diff| {err:.3g}", flush=True)
            continue
        err = float((got[0] - want[0]).abs().max())
        same = float((got[1] == want[1]).float().mean())
        print(f"check {reduce}/{oob}: max|diff| {err:.3g}, argmax equal "
              f"at {100 * same:.3f}% of samples", flush=True)


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    built = _build.build_variants(
        "bp", [(f"BP_R={r}",) for r in VARIANTS],
        extra_flags=("-Xptxas", "-v"))
    for r, (_, log) in zip(VARIANTS, built):
        regs = [ln.split("info    :")[-1].strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"BP_R={r} ptxas: {'; '.join(regs)}", flush=True)
    rng = np.random.default_rng(3)
    mv = smooth_grid_moveouts(N_SRC, N_STA)
    w_ph = default_weights_phases(N_STA)
    w_src = closest_weights(mv)
    _use(built[0][0], VARIANTS[0])
    _check(mv, w_ph, w_src, rng)

    feat = torch.from_numpy(rng.uniform(0, 1, size=(N_STA, 3, N_DAY)).astype(
        np.float32)).cuda()
    terms = int((w_src > 0).sum()) * 2 * N_DAY
    first = None
    for r, (so, _) in zip(VARIANTS, built):
        _use(so, r)
        plan = bp.BeamformPlan(mv, w_ph, w_src, N_DAY)
        g = plan.fold_and_pad(feat)
        out = plan.call_folded(g)
        torch.cuda.synchronize()
        if first is None:
            first = out
        same = bool(torch.equal(out[0], first[0])
                    and torch.equal(out[1], first[1]))
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(2):
            e0.record()
            for _ in range(2):
                plan.call_folded(g)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1) / 2)
        ms = min(times)
        t = plan.tables
        rows = (t.stage_row[1:] - t.stage_row[:-1]).float().mean()
        print(f"BP_R={r}: {ms:.2f} ms/day "
              f"({terms / ms / 1e6:.0f} G multiply-adds/s; runs {times}); "
              f"{t.n_tiles} source tiles in {t.n_stages} stages, "
              f"{float(rows):.1f} rows/stage (max {t.max_rows}), stride "
              f"{t.stride}; first variant's "
              f"bits: {same} [{card}]", flush=True)
        del out, g, plan


if __name__ == "__main__":
    main()
