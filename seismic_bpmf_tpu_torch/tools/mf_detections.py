"""Holds an MF campaign's detections of one tree to another's.

    python -m seismic_bpmf_tpu_torch.tools.mf_detections \
        [--reference-tree DIR] [--precision high | highest | screen]

At `high` it runs `chip_smoke.py` phase 11's campaign
(`tools/mf_world.py`'s world of 128 templates x 30 channels over its two
days of 2,160,000 samples, `workflow.scan_days` at the rung, phase 11's
engine settings and noise seed); at `highest` the same campaign at that
rung (phase 5's) with phase 4's noise seed; at `screen` phase 4's campaign
(the same world and settings, phase 4's noise seed) and then phase 24's
(`tools/year_world.py`'s 1024-template year bank, `tools/year_scan.py`'s
campaign over days 0-1 and then day 2 from its state file, phase 24's
white noise).  Each runs in a process of its own in this tree and, with
--reference-tree, in the other tree (say, the parent commit unpacked by
`git archive`); prints each tree's detections a day and whether the two
give the same template ids at the same samples, with the largest
difference of their CC, beside the card's name and power limit.  A change
of a kernel that keeps the campaign's decisions gives "identical: True".
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

# runs in a tree's root: the campaign through that tree's package
_CAMPAIGN = """
import json, os, sys, tempfile
import numpy as np
from seismic_bpmf_tpu_torch import workflow
from seismic_bpmf_tpu_torch.config import Config
world_name, precision, out = sys.argv[1:4]
SEED = 20260816
if world_name == "year":
    from seismic_bpmf_tpu_torch.tools.year_scan import campaign, dates_of
    from seismic_bpmf_tpu_torch.tools.year_world import (
        build_bank, build_world)
    world = build_world()
    bank = build_bank(world, 1024)
    noise = np.random.default_rng(SEED + 24).normal(size=500).astype(
        np.float32)
    dates = dates_of(3)
    sr = world.cfg.sampling_rate_hz
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "year_state.json")
        for upto in (2, 3):
            res.update(campaign(world, bank, dates[:upto], state_file=state,
                                precision=precision, white_noise=noise))
else:
    from seismic_bpmf_tpu_torch.tools.mf_world import DATES, L, SR, MFWorld
    world = MFWorld(SEED, n_tp=128)
    _, tg = world.bank()
    sr = SR
    seed = SEED + (4 if precision == "high" else 2)
    kw = dict(minimum_interevent_time=5.0, min_channels=6, min_stations=3,
              max_kurto=1e6, rng=np.random.default_rng(seed))
    res = workflow.scan_days(list(DATES), world.make_data, tg,
                             cfg=Config(sampling_rate_hz=SR,
                                        template_len_sec=L / SR),
                             precision=precision, **kw)
found = {str(day): {tid: [[int(round(e.origin_time_epoch * sr)),
                           float(e.aux_data["cc"])] for e in evs]
                    for tid, evs in r.items()} for day, r in res.items()}
with open(out, "w") as f:
    json.dump(found, f)
"""


def campaign(tree: str, world: str, precision: str, tmp: str) -> dict:
    """{day: {template id: [[sample, cc], ...]}} of the campaign on
    `world` ('tutorial' or 'year') in `tree`, run in a process of its own;
    samples count from the epoch."""
    out = os.path.join(tmp, f"found-{len(os.listdir(tmp))}.json")
    subprocess.run([sys.executable, "-c", _CAMPAIGN, world, precision, out],
                   cwd=os.path.abspath(tree), check=True)
    with open(out) as f:
        return json.load(f)


def compare(a: dict, b: dict) -> tuple:
    """(the same template ids at the same samples every day, the largest
    |CC difference| at the detections they share)."""
    same, worst = set(a) == set(b), 0.0
    for day in set(a) & set(b):
        if set(a[day]) != set(b[day]):
            same = False
        for tid in set(a[day]) & set(b[day]):
            sa = dict((s, c) for s, c in a[day][tid])
            sb = dict((s, c) for s, c in b[day][tid])
            same &= sa.keys() == sb.keys()
            for s in sa.keys() & sb.keys():
                worst = max(worst, abs(sa[s] - sb[s]))
    return same, worst


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reference-tree", default=None)
    ap.add_argument("--precision", default="high",
                    choices=("high", "highest", "screen"))
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    trees = [here] + ([args.reference_tree] if args.reference_tree else [])
    worlds = (["tutorial", "year"] if args.precision == "screen"
              else ["tutorial"])
    for world in worlds:
        with tempfile.TemporaryDirectory() as tmp:
            found = [campaign(t, world, args.precision, tmp) for t in trees]
        for tree, f in zip(trees, found):
            print(f"{tree}: {world} {args.precision} detections a day "
                  f"{({d: sum(map(len, r.values())) for d, r in f.items()})}"
                  f" [{card}]", flush=True)
        if len(found) == 2:
            same, worst = compare(*found)
            print(f"{world} {args.precision} identical: {same}; max|CC "
                  f"difference| at shared detections {worst:.3g} [{card}]",
                  flush=True)


if __name__ == "__main__":
    main()
