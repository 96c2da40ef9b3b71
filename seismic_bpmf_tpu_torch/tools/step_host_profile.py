"""Where a PhaseNet training step's host time goes, unsharded and on a
virtual {"data": 4} mesh of one card.

    python -m seismic_bpmf_tpu_torch.tools.step_host_profile

At full width (`PhaseNet()`, the month script's training windows of
3,001 samples), at the script's batch (32) and at 256 windows, the step
of `make_train_step` and that of `make_sharded_train_step` each go
through `host_breakdown`: torch.profiler's CPU side by aten op, by CUDA
runtime call and by the sharded step's Python layers.  On a mesh of
CUDA devices the sharded step replays one CUDA graph, which enters none
of those layers, so their rows are empty there.  Prints the card's name
and power limit, then one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import torch

from ..models import make_sharded_train_step, make_train_step
from ..models.phasenet import PhaseNet, gaussian_pick_labels, init_weights
from ..parallel import make_mesh
from .mesh_days import _r, cards_line, sync
from .month_workflow import TRAIN_KW
from .month_world import build_world as build_month_world, training_windows

N_TRAIN = 256


def host_breakdown(step, batch, devs, n: int = 3, rows: int = 14) -> dict:
    """Where a training step's host time goes, from torch.profiler's CPU
    side over `n` steps (a warm one before), each count and ms divided by
    `n`: the profiled ms a step; the `rows` aten ops and CUDA runtime
    calls of the most self time (count, self ms); and the sharded step's
    Python layers, each within a `record_function` range for the run
    (count, total ms, self ms): `Shards.__torch_function__` (every op of
    a shard passes through it), `_ShardsBatchNorm.forward` / `.backward`
    and Adam's step."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from ..models import phasenet

    def ranged(name, fn):
        def run(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return run

    layers = {"Shards.__torch_function__": (
        phasenet.Shards, "__torch_function__", classmethod),
        "_ShardsBatchNorm.forward": (
        phasenet._ShardsBatchNorm, "forward", staticmethod),
        "_ShardsBatchNorm.backward": (
        phasenet._ShardsBatchNorm, "backward", staticmethod)}
    saved = {k: v[0].__dict__[v[1]] for k, v in layers.items()}
    step(batch)
    sync(devs)
    try:
        for name, (cls, attr, kind) in layers.items():
            setattr(cls, attr, kind(ranged(name, saved[name].__func__)))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t = time.perf_counter()
            for _ in range(n):
                step(batch)
            sync(devs)
            wall = (time.perf_counter() - t) / n
    finally:
        for name, (cls, attr, _) in layers.items():
            setattr(cls, attr, saved[name])
    avg = prof.key_averages()

    def top(keep):
        got = sorted((e for e in avg if keep(e.key)),
                     key=lambda e: e.self_cpu_time_total, reverse=True)
        return {e.key: [e.count / n, _r(e.self_cpu_time_total / 1e3 / n)]
                for e in got[:rows]}

    ranges = [*layers, "Optimizer.step#Adam.step"]
    return dict(
        profiled_step_ms=_r(1e3 * wall, 2),
        aten=top(lambda k: k.startswith("aten::")),
        runtime=top(lambda k: k.startswith("cuda")),
        layers={e.key: [e.count / n, _r(e.cpu_time_total / 1e3 / n),
                        _r(e.self_cpu_time_total / 1e3 / n)]
                for e in avg if e.key in ranges})


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="step_host_") as work:
        wavelet = build_month_world(work).wavelet
    x, picks = training_windows(wavelet, N_TRAIN)
    labels = torch.from_numpy(
        gaussian_pick_labels(picks, x.shape[-1], sigma=TRAIN_KW["sigma"]))
    mesh = make_mesh({"data": 4}, devices=[card] * 4)
    out = {}
    for nb in (TRAIN_KW["batch_size"], N_TRAIN):
        batch = (torch.from_numpy(x[:nb]).to(card), labels[:nb].to(card))
        for where in ("one card", "4 shards"):
            model = init_weights(PhaseNet(),
                                 torch.Generator().manual_seed(0)).to(card)
            opt = torch.optim.Adam(model.parameters(),
                                   lr=TRAIN_KW["learning_rate"])
            step = (make_sharded_train_step(model, opt, mesh)
                    if where == "4 shards" else make_train_step(model, opt))
            out[f"{where}, batch {nb}"] = host_breakdown(step, batch, [card])
    print(f"step_host_profile [{cards_line()}]", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
