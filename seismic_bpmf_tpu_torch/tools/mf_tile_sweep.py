"""Times a fused MF kernel's compile-time tile choices on one day.

    python -m seismic_bpmf_tpu_torch.tools.mf_tile_sweep [mf | mf_split]

Builds the kernel's source once per variant of its compile-time sizes,
runs each on the main path's shapes (128 templates x 30 channels x L = 200
x 2,160,000 samples, moveouts in [-50, 400)) and prints ptxas's register
and spill report, its time (CUDA events, 2 x 3 launches) and its largest
difference from the first variant, with the card's name and power limit.

  mf        csrc/mf.cu: (MF_R lags per thread, MF_MINB blocks per SM for
            the register budget, MF_YG samples per partial of the window
            sums), at precision 'highest';
  mf_split  csrc/mf_split.cu: (MFS_NSUB 128-lag sub-tiles per block,
            MFS_MINB), at precision 'high'.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from .. import _build
from ..ops import mf

KERNELS = {
    # name: (define names, precision, variants; the first is the source's
    # default)
    "mf": (("MF_R", "MF_MINB", "MF_YG"), "highest",
           [(16, 2, 16), (8, 1, 1), (16, 2, 1), (16, 2, 8), (16, 1, 16)]),
    "mf_split": (("MFS_NSUB", "MFS_MINB"), "high",
                 [(4, 2), (4, 1), (3, 2), (2, 2), (2, 3)]),
}


def _set_tiles(name: str, variant) -> None:
    """Point ops.mf's mirrors of the kernel's tile sizes at a variant."""
    if name == "mf":
        mf.TAP_MULTIPLE, mf.LAG_TILE = variant[0], 32 * variant[0]
    else:
        mf.SPLIT_LAG_TILE = 128 * variant[0]


def main(name: str = "mf"):
    defines, precision, variants = KERNELS[name]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    built = _build.build_variants(
        name, [tuple(f"{k}={v}" for k, v in zip(defines, var))
               for var in variants], extra_flags=("-Xptxas", "-v"))
    label = [" ".join(f"{k}={v}" for k, v in zip(defines, var))
             for var in variants]
    for lab, (so, log) in zip(label, built):
        regs = [ln.split("info    :")[-1].strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{lab} ptxas: {'; '.join(regs)}", flush=True)
    rng = np.random.default_rng(3)
    n_tp, n_sta, n_comp, L, n = 128, 10, 3, 200, 2160000
    tp = rng.normal(size=(n_tp, n_sta, n_comp, L)).astype(np.float32)
    mv = rng.integers(-50, 400, size=(n_tp, n_sta, n_comp))
    w = np.full((n_tp, n_sta, n_comp), 1.0 / 30, np.float32)
    d = rng.standard_normal((n_sta, n_comp, n), dtype=np.float32)
    macs = n_tp * n_sta * n_comp * L * (n - L + 1)
    first = None
    for var, lab, (so, _) in zip(variants, label, built):
        _set_tiles(name, var)
        mf._BOUND.discard(name)
        _build._LIBS[name] = ctypes.CDLL(so)
        plan = mf.MatchedFilterPlan(tp, mv, w, n, precision=precision)
        dp = plan.pad_data(d)
        out = plan(dp)
        torch.cuda.synchronize()
        if first is None:
            first = out
        err = float((out - first).abs().max())
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
        ms = min(times)
        print(f"{name} {lab}: {ms:.2f} ms/day "
              f"({macs / ms / 1e6:.0f} GMAC/s; runs {times}), max|diff| vs "
              f"first {err:.3g} [{card}]", flush=True)
        del out, dp, plan


if __name__ == "__main__":
    main(*sys.argv[1:2])
