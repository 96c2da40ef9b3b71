"""Runs one cell of the benchmark of `seismic_bpmf_tpu_torch` and prints
its result as one JSON line, the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's world is drawn from the seed; set-up runs its warm days through
the campaign; the window then runs `--seconds` of campaign days through
`workflow.scan_days`; the plain reference then judges what the window's
days produced.  With `--trace 1` the window runs under `torch.profiler`
and the line holds the per-layer metrics, else the end-to-end ones.  Each
number compared is printed beside its limit as the last lines of standard
error.  The process runs its host work on one intra-op thread besides
the program's own threads.  It needs a CUDA card, and exits with another
code than 0, printing no result, without one, when a module of JAX or of
the JAX package is loaded once the window has closed, or when the program
is not beside it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One intra-op thread for the host work of the run's process: with the
# default of one thread a core, the runs of a cell spread by up to 10%
# on the same seeds, and with one they were as fast or faster and tighter.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    print(f"# imports: torch {t_torch - T0:.3f} s, the card's count "
          f"{time.perf_counter() - t_torch:.3f} s", file=sys.stderr)
    sys.path.insert(0, ROOT)
    from benchmark import harness

    cards = [torch.device("cuda", i) for i in range(int(cell["chips"]))]
    result = harness.run_cell(ROOT, args.workload, args.seed % 2 ** 63,
                              args.seconds, bool(args.trace), cards, T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
