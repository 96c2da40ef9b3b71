"""Checks and times the BP kernel's compile-time choices.

    python -m seismic_bpmf_tpu_torch.tools.bp_tile_sweep \
        [--variants R,W,D,N ...] [--reference-tree DIR]

A variant is the four sizes of csrc/bp.cu: R samples per lane (BP_R, odd),
W computing warps (BP_WARPS; a warp owns two sources, a source tile is 2 W
sources), D (BP_D: a warp's two sources share a window of a staged row
where their moveouts lie less than D apart) and N slots of the staging
ring (BP_NSTAGE).  The source is built once per
variant, all at once, and ptxas's register and spill report is printed.
The first variant (the source's default unless --variants is given) is
held against the plain PyTorch version at the main path's width (100,000
lattice sources x 32 stations x 2 phases, closest-10 weights,
tools/lattice.py) on a 2^13-sample window, for reduce='max' under both
policies and 'none'.
Then every variant runs one day (2,160,000 samples, uniform features,
`BeamformPlan.call_folded`, so the day's chunk calls) and prints its time
(CUDA events, the best of 2 x 2 days), the seconds its plan's tables took
to build, the multiply-adds per word loaded from a staged row (counted
from the tables) and whether it gives the first variant's bits, with the
card's name and power limit.
--reference-tree names a directory that holds another version of this
package (say, the parent commit unpacked by `git archive`): the same day
then runs there, in a process of its own through that tree's
`BeamformPlan`, and its time and whether the first variant gives its bits
are printed.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .. import _build
from ..ops import bp
from ..workflow import default_weights_phases
from .lattice import closest_weights, smooth_grid_moveouts

DEFAULT = (bp.LANE_COLS, bp.WARPS, bp.WIN_D, bp.RING)
VARIANTS = [DEFAULT, (15, 15, 8, 4), (15, 15, 16, 3), (17, 15, 8, 3),
            (11, 19, 8, 3), (15, 11, 8, 3)]
N_SRC, N_STA, N_DAY = 100_000, 32, 2_160_000
DAY_SEED = 4

# runs in the reference tree: the same day through that tree's plan
_REFERENCE = """
import sys, numpy as np, torch
from seismic_bpmf_tpu_torch.ops import bp
from seismic_bpmf_tpu_torch.workflow import default_weights_phases
from seismic_bpmf_tpu_torch.tools.lattice import (
    closest_weights, smooth_grid_moveouts)
n_src, n_sta, n_day, seed = (int(a) for a in sys.argv[1:5])
out = sys.argv[5]
mv = smooth_grid_moveouts(n_src, n_sta)
feat = torch.from_numpy(np.random.default_rng(seed).uniform(
    0, 1, size=(n_sta, 3, n_day)).astype(np.float32)).cuda()
plan = bp.BeamformPlan(mv, default_weights_phases(n_sta),
                       closest_weights(mv), n_day)
g = plan.fold_and_pad(feat)
val, idx = plan.call_folded(g)
torch.cuda.synchronize()
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
torch.save({"val": val.cpu(), "idx": idx.cpu(), "times": times}, out)
"""


def _use(so: str, variant):
    r, w, d, n = variant
    bp.LANE_COLS, bp.WARPS, bp.WIN_D, bp.RING = r, w, d, n
    bp.TIME_TILE, bp.SRC_TILE = 32 * r, w * bp.GROUP
    bp._BOUND.discard("bp")
    _build._LIBS["bp"] = ctypes.CDLL(so)


def _name(variant) -> str:
    return "R/W/D/N=" + "/".join(str(v) for v in variant)


def _check(mv, w_ph, w_src, rng):
    """Kernel against the plain version on a short window."""
    n = 2**13
    feat = rng.uniform(0, 1, size=(N_STA, 3, n)).astype(np.float32)
    for reduce, oob in (("max", "strict"), ("max", "flexible"),
                        ("none", "strict")):
        plan = bp.BeamformPlan(mv, w_ph, w_src, n, reduce=reduce,
                               out_of_bounds=oob)
        g = plan.fold_and_pad(feat)
        got = plan.call_folded(g)
        want = bp.beamform_plain(g, plan.tables, reduce=reduce)
        torch.cuda.synchronize()
        if reduce == "none":
            err = float((got - want).abs().max())
            print(f"check {reduce}/{oob}: max|diff| {err:.3g}", flush=True)
            continue
        err = float((got[0] - want[0][:n]).abs().max())
        same = float((got[1] == want[1][:n]).float().mean())
        print(f"check {reduce}/{oob}: max|diff| {err:.3g}, argmax equal "
              f"at {100 * same:.3f}% of samples", flush=True)


def _day_ms(plan, g):
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
    return min(times), times


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="*", default=None,
                    help="R,W,D,N of each variant")
    ap.add_argument("--reference-tree", default=None)
    args = ap.parse_args()
    variants = VARIANTS if args.variants is None else [
        tuple(int(v) for v in s.split(",")) for s in args.variants]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    built = _build.build_variants(
        "bp", [(f"BP_R={r}", f"BP_WARPS={w}", f"BP_D={d}", f"BP_NSTAGE={n}")
               for r, w, d, n in variants],
        extra_flags=("-Xptxas", "-v"))
    for v, (_, log) in zip(variants, built):
        regs = [ln.split("info    :")[-1].strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{_name(v)} ptxas: {'; '.join(regs)}", flush=True)
    rng = np.random.default_rng(3)
    mv = smooth_grid_moveouts(N_SRC, N_STA)
    w_ph = default_weights_phases(N_STA)
    w_src = closest_weights(mv)
    _use(built[0][0], variants[0])
    _check(mv, w_ph, w_src, rng)

    feat = torch.from_numpy(np.random.default_rng(DAY_SEED).uniform(
        0, 1, size=(N_STA, 3, N_DAY)).astype(np.float32)).cuda()
    terms = int((w_src > 0).sum()) * 2 * N_DAY
    first = None
    for v, (so, _) in zip(variants, built):
        _use(so, v)
        t0 = time.perf_counter()
        plan = bp.BeamformPlan(mv, w_ph, w_src, N_DAY)
        plan_s = time.perf_counter() - t0
        g = plan.fold_and_pad(feat)
        out = plan.call_folded(g)
        torch.cuda.synchronize()
        if first is None:
            first = out
        same = bool(torch.equal(out[0], first[0])
                    and torch.equal(out[1], first[1]))
        ms, times = _day_ms(plan, g)
        t = plan.tables
        rows = (t.stage_row[1:] - t.stage_row[:-1]).float().mean()
        print(f"{_name(v)}: {ms:.2f} ms/day "
              f"({terms / ms / 1e6:.0f} G multiply-adds/s; runs {times}); "
              f"{t.fma_per_word:.2f} multiply-adds per loaded word, "
              f"{t.n_pairs / max(1, t.n_items):.2f} per item; "
              f"{t.n_tiles} source tiles in {t.n_stages} stages, "
              f"{float(rows):.1f} rows/stage (max {t.max_rows}), stride "
              f"{t.stride}, program {t.prog_bytes} B/stage at most, "
              f"{bp._smem_bytes(t.stride, t.max_rows, t.prog_bytes)} B of "
              f"shared memory; plan built in {plan_s:.2f} s; first "
              f"variant's bits: {same} [{card}]", flush=True)
        del out, g, plan
    if args.reference_tree is None:
        return
    del feat
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "reference_day.pt")
        subprocess.run(
            [sys.executable, "-c", _REFERENCE, str(N_SRC), str(N_STA),
             str(N_DAY), str(DAY_SEED), out],
            cwd=os.path.abspath(args.reference_tree), check=True)
        ref = torch.load(out)
    same = bool(torch.equal(first[0].cpu(), ref["val"])
                and torch.equal(first[1].cpu(), ref["idx"]))
    print(f"reference tree {args.reference_tree}: {min(ref['times']):.2f} "
          f"ms/day (runs {ref['times']}); {_name(variants[0])} gives its "
          f"bits: {same} [{card}]", flush=True)


if __name__ == "__main__":
    main()
