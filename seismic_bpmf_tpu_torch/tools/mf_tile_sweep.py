"""Times a fused MF kernel's compile-time tile choices on one day.

    python -m seismic_bpmf_tpu_torch.tools.mf_tile_sweep \
        [mf | mf_highest | mf_split] [--variants A,B ...] \
        [--reference-tree DIR]

Builds the kernel's source once per variant of its compile-time sizes (all
nvcc processes at once), runs each on the main path's shapes (128
templates x 30 channels x L = 200 x 2,160,000 samples, moveouts in
[-50, 400), templates 0-15 planted four times each at 30 times the noise)
and prints ptxas's register and spill report, its time (CUDA events, the
best of 2 x 3 launches) and its largest difference from the first variant,
with the card's name and power limit.

  mf          csrc/mf.cu at precision 'default': (MF_STAGES, the ring's
              depth; MF_DIAG, 0 the kernel, 1 a diagnostic build without
              the products (staging, ring and epilogue), 2 one that only
              stages (the consumers release each stage at once), 3 one
              that only multiplies (no copies, no waits, no epilogue: the
              product loop's own rate), 4 products and epilogue without
              copies or waits; the diagnostic builds give wrong CC); the
              pre-pass's time (`ops.mf.tf32_day`) and the rate of the
              TF32 operations the main kernel issues are printed too;
  mf_highest  csrc/mf.cu's 'highest' build (MF_ACC_OUT=1) at precision
              'highest': (MF_ACC_G, the k-steps a partial; MF_STAGES;
              MF_DIAG as for mf), with the pre-pass's time and the issued
              TF32 rate as for mf, and each variant's largest |CC - the
              float64 oracle| at the planted repeats (the rung's gate is
              1e-6);
  mf_split    csrc/mf_split.cu at precision 'high': (MFS_STAGES, MFS_DIAG
              as MF_DIAG's 0-2); the pre-pass's time (`ops.mf.split_day`)
              is printed too.

--reference-tree names a directory that holds another version of this
package (say, the parent commit unpacked by `git archive`): the same day
then runs there too, in a process of its own through that tree's
`MatchedFilterPlan` at the same precision, once before the variants and
once after them, and each variant is held to it: the largest difference
between the CC's, and whether they agree within rtol 1e-4, atol 1e-5.
Compare two trees' times only within one run of this tool.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from .. import _build
from ..ops import mf
from ..ops.reference import matched_filter_at

KERNELS = {
    # name: (source, its build's fixed defines, define names, precision,
    # variants; the first is the build's default)
    "mf": ("mf", (), ("MF_STAGES", "MF_DIAG"), "default",
           [(4, 0), (3, 0), (2, 0), (4, 1), (4, 2), (4, 3), (4, 4)]),
    "mf_highest": ("mf", mf.HIGHEST_BUILD, ("MF_ACC_G", "MF_STAGES",
                                            "MF_DIAG"), "highest",
                   [(2, 4, 0), (3, 4, 0), (5, 4, 0), (10, 4, 0), (2, 3, 0),
                    (2, 4, 3)]),
    "mf_split": ("mf_split", (), ("MFS_STAGES", "MFS_DIAG"), "high",
                 [(3, 0), (2, 0), (1, 0), (3, 1), (3, 2)]),
}
RTOL, ATOL = 1e-4, 1e-5
N_PLANTED, PER_PLANTED = 16, 4   # templates planted, repeats of each

# runs in the reference tree: the same day through that tree's plan
_REFERENCE = """
import sys, numpy as np, torch
from seismic_bpmf_tpu_torch.ops import mf
src, precision, out = sys.argv[1:4]
z = np.load(src)
plan = mf.MatchedFilterPlan(z["tp"], z["mv"], z["w"], z["d"].shape[-1],
                            precision=precision)
dp = plan.pad_data(z["d"])
cc = plan(dp)
torch.cuda.synchronize()
e0 = torch.cuda.Event(enable_timing=True)
e1 = torch.cuda.Event(enable_timing=True)
times = []
for _ in range(2):
    e0.record()
    for _ in range(3):
        plan(dp)
    e1.record()
    torch.cuda.synchronize()
    times.append(e0.elapsed_time(e1) / 3)
torch.save({"cc": cc.cpu(), "times": times}, out)
"""


def _route(name: str, variant) -> str:
    """The build's key in `_build._LIBS` of a variant, with ops.mf's
    mirrors of its tile sizes set."""
    if name == "mf":
        mf.STAGES = variant[0]
        return _build.key("mf")
    if name == "mf_highest":
        mf.HIGHEST_PARTIAL_STEPS, mf.STAGES = variant[:2]
        return _build.key("mf", mf.HIGHEST_BUILD)
    mf.SPLIT_STAGES = variant[0]
    return _build.key("mf_split")


def _issued_tflops(plan, ms: float) -> float:
    """TF32 TFLOP/s of the products csrc/mf.cu (either build) issues for
    `plan`'s day: two m64n64k8 products a k-step for every template slot
    of a block, used channel and lag tile."""
    slots = -(-plan.n_tp // mf.BLOCK_TEMPLATES) * mf.BLOCK_TEMPLATES
    tiles = -(-plan.n_corr_unit // mf.LAG_TILE)
    chans = int((plan.tile_lo >= 0).sum()) / plan.tile_lo.shape[1]
    n_ks = mf._k_taps(plan.L) // mf.TF32_K_STEP
    flops = 2 * slots * tiles * chans * n_ks * 2 * 64 * 64 * 8
    return flops / ms / 1e9


def _day_ms(plan, dp) -> tuple:
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(2):
        e0.record()
        for _ in range(3):
            plan(dp)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / 3)
    return min(times), times


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel", nargs="?", default="mf", choices=list(KERNELS))
    ap.add_argument("--variants", nargs="*", default=None,
                    help="the compile-time sizes of each variant, A,B")
    ap.add_argument("--reference-tree", default=None)
    args = ap.parse_args()
    name = args.kernel
    source, fixed, defines, precision, variants = KERNELS[name]
    if args.variants is not None:
        variants = [tuple(int(v) for v in s.split(","))
                    for s in args.variants]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    built = _build.build_variants(
        source, [(*fixed, *(f"{k}={v}" for k, v in zip(defines, var)))
                 for var in variants], extra_flags=("-Xptxas", "-v"))
    label = [" ".join(f"{k}={v}" for k, v in zip(defines, var))
             for var in variants]
    for lab, (so, log) in zip(label, built):
        regs = [ln.split("info    :")[-1].strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln
                or "Performance Loss" in ln]
        print(f"{lab} ptxas: {'; '.join(regs)}", flush=True)
    rng = np.random.default_rng(3)
    n_tp, n_sta, n_comp, L, n = 128, 10, 3, 200, 2160000
    tp = rng.normal(size=(n_tp, n_sta, n_comp, L)).astype(np.float32)
    mv = rng.integers(-50, 400, size=(n_tp, n_sta, n_comp))
    w = np.full((n_tp, n_sta, n_comp), 1.0 / 30, np.float32)
    d = rng.standard_normal((n_sta, n_comp, n), dtype=np.float32)
    lags = rng.integers(1000, n - 1000, size=(N_PLANTED, PER_PLANTED))
    for t in range(N_PLANTED):
        for o in lags[t]:
            for s in range(n_sta):
                for c in range(n_comp):
                    st = o + mv[t, s, c]
                    d[s, c, st : st + L] += 30.0 * tp[t, s, c]
    exact = np.stack([matched_filter_at(tp[t], mv[t], w[t], d, lags[t])
                      for t in range(N_PLANTED)])
    macs = n_tp * n_sta * n_comp * L * (n - L + 1)
    with tempfile.TemporaryDirectory() as tmp:
        refs = []
        if args.reference_tree is not None:
            src = os.path.join(tmp, "day.npz")
            np.savez(src, tp=tp, mv=mv, w=w, d=d)
            refs.append(_reference(args.reference_tree, src, precision, tmp,
                                   card))
            print(f"reference tree: max|CC - oracle| at the {exact.size} "
                  f"planted repeats "
                  f"{_oracle_err(refs[0]['cc'], lags, exact):.3g}", flush=True)
        first = None
        for var, lab, (so, _) in zip(variants, label, built):
            lib_key = _route(name, var)
            mf._BOUND.discard(lib_key)
            _build._LIBS[lib_key] = ctypes.CDLL(so)
            plan = mf.MatchedFilterPlan(tp, mv, w, n, precision=precision)
            dp = plan.pad_data(d)
            try:
                out = plan(dp)
            except RuntimeError as exc:    # a launch the build refuses
                print(f"{name} {lab}: {exc} [{card}]", flush=True)
                continue
            torch.cuda.synchronize()
            if first is None:
                first = out
            err = float((out - first).abs().max())
            ms, times = _day_ms(plan, dp)
            extra = ""
            if name == "mf_split":
                extra = (f"; pre-pass {_prepass_ms(mf.split_day, dp, L):.3f}"
                         f" ms, {mf.split_stages(L, plan.max_delta)} stages")
            else:
                pre = _prepass_ms(mf.tf32_day, dp, L)
                extra = (f"; pre-pass {pre:.3f} ms, "
                         f"{mf.stages(L, plan.max_delta)} stages, issued "
                         f"TF32 {_issued_tflops(plan, ms - pre):.1f} "
                         f"TFLOP/s (the day less its pre-pass)")
            extra += (f"; max|CC - oracle| at the {exact.size} planted "
                      f"repeats {_oracle_err(out, lags, exact):.3g}")
            if refs:
                cc = refs[0]["cc"]
                outc = out.cpu()
                extra += (f"; vs reference max|diff| "
                          f"{float((outc - cc).abs().max()):.3g}, within "
                          f"rtol={RTOL}, atol={ATOL}: "
                          f"{bool(torch.allclose(outc, cc, rtol=RTOL, atol=ATOL))}")
            print(f"{name} {lab}: {ms:.2f} ms/day "
                  f"({macs / ms / 1e6:.0f} GMAC/s; runs {times}), max|diff| "
                  f"vs first {err:.3g}{extra} [{card}]", flush=True)
            del out, dp, plan
        if refs:
            del first
            torch.cuda.empty_cache()
            refs.append(_reference(args.reference_tree, src, precision, tmp,
                                   card))


def _oracle_err(out, lags, exact) -> float:
    """Largest |CC - the float64 oracle| at the planted repeats."""
    got = out[:N_PLANTED].cpu().numpy()
    return float(max(np.abs(got[t, lags[t]] - exact[t]).max()
                     for t in range(N_PLANTED)))


def _prepass_ms(prepass, dp, L) -> float:
    """Best of 2 x 3 runs of a kernel's pre-pass, ms."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(2):
        e0.record()
        for _ in range(3):
            prepass(dp, L)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / 3)
    return min(times)


def _reference(tree, src, precision, tmp, card) -> dict:
    """The day through `tree`'s plan in a process of its own: its CC (on
    the CPU) and times, printed."""
    out = os.path.join(tmp, "reference_day.pt")
    subprocess.run([sys.executable, "-c", _REFERENCE, src, precision, out],
                   cwd=os.path.abspath(tree), check=True)
    ref = torch.load(out)
    print(f"reference tree {tree}: {min(ref['times']):.2f} ms/day (runs "
          f"{ref['times']}) [{card}]", flush=True)
    return ref


if __name__ == "__main__":
    main()
