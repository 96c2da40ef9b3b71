"""The control of a cell's check: the plain reference computed in the
nearest precision below the configuration's (bf16 operands, float32 sums)
put in the program's place, on the worlds that runs with these seeds
draw, at the cell's own sizes.  Its outputs go into a window's record and
through the run's own comparison (`reference.<name>.compare`) and verdict
(`harness.judge`).  It prints each number it reads beside the cell's
limit, and exits 0 only when every seed's control comes out not correct,
as a sound check requires.  The benchmark's runs do not run it.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--days 4]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(root: str, name: str, seed: int, days: int, device,
             overrides: dict = None) -> dict:
    """The control of cell `name` on the world of `seed`, over its first
    `days` window days, judged as a run is: {"correct", "failed",
    "checks": {number: {value, limit}}}."""
    import importlib

    from benchmark import harness, window

    cell = harness.resolve(root, name)
    sizes = dict(cell.config["sizes"], **(overrides or {}))
    check = cell.config["check"]
    gen = importlib.import_module(
        f"benchmark.generators.{cell.config['generator']}")
    ref = importlib.import_module(
        f"benchmark.reference.{cell.config['reference']}")
    world = gen.build(sizes, cell.traffic, seed, device)
    n_warm = int(cell.traffic["warm_days"])
    rec = window.Record(seed=seed, days=list(range(n_warm, n_warm + days)))
    for i, parts in ref.control(world, cell.traffic, seed, rec.days, device,
                                check).items():
        for part, value in parts.items():
            getattr(rec, part)[i] = value
    per_day = ref.compare(world, cell.traffic, rec, device, check)
    checks, failed, correct = harness.judge(per_day, cell.limits)
    return {"correct": correct, "failed": failed, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--days", type=int, default=4)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    ok = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(ROOT, args.workload, seed, args.days,
                     torch.device(args.device))
        ok &= not r["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed, **r,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
