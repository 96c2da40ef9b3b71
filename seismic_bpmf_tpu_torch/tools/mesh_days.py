"""Sharded day scans and sharded training on every visible card.

    python -m seismic_bpmf_tpu_torch.tools.mesh_days           # full width
    python -m seismic_bpmf_tpu_torch.tools.mesh_days --cut     # a cut world

Drives `parallel.sharded` on `make_mesh(..., devices=None)`, a mesh of
real cards (n of them, n even), where `chip_smoke.py` phases 26-27 and 29
use virtual meshes that repeat one card:

  - the MF day: `chip_smoke.py` phase 4's bank (`tools/mf_world.py`: 128
    templates x 30 channels, L = 200) and day 1 (2,160,000 samples), at
    'default' (kernel #1, csrc/mf.cu, which `screen` scans), 'highest'
    (its 'highest' build) and 'high' (kernel #2), on the
    meshes {"tp": 2, "time": n/2}, {"time": n}, {"tp": n} and {"tp": 2,
    "time": n} over the cards twice;
  - the BP day: phase 8's lattice (`tools/bp_world.py`: 100,000 sources x
    64 station-phases) and day 1's envelopes (kernel #3) on {"src": 2,
    "time": n/2}, {"src": n} and {"time": n};
  - `scan_days(mesh=)` over both days of each world, MF at 'screen';
  - `train_phasenet(mesh=make_mesh({"data": n}))` (run first): its first
    step against the unsharded step, then two epochs; the step alone at
    the script's batch and at the whole training set, on one card and on
    the mesh (one CUDA graph a step), and a torch.profiler summary of
    both at the script's batch (`step_profile`: launches, copies and
    stream waits a step, each card's kernels and busy ms).
    `training([cuda:0] * 4, FULL, {})` runs it on a virtual mesh of one
    card.

Checks (any failure raises): every sharded CC and (max, argmax) equal bit
for bit to the unsharded kernel's on the first card (the sharded argmax
merges by the first-max rule); every plan table, halo-extended chunk and
shard output on its shard's card, the results on the first; each card
launched each kernel (`launches_on`, counted where the wrapper launches);
the campaigns' detections identical; the sharded training within the gates
of `chip_smoke.py` phase 29 (losses 1e-3 relative).  It prints the day's ms
sharded and on one card, each shard's kernel ms, the halo exchange's ms,
whether the cards reach each other as peers, the campaigns' s/day, ms a
training step and where a step's time goes, with the cards' names and power limits, and one JSON line
last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .. import workflow
from ..config import Config
from ..models import make_sharded_train_step, make_train_step, train_phasenet
from ..models.phasenet import (PhaseNet, Shards, gaussian_pick_labels,
                               init_weights)
from ..ops import bp, mf
from ..ops.cf import saturated_envelopes
from ..parallel import make_mesh, sharded
from ..utils.observe import GLOBAL_TIMER
from .bp_world import BPWorld
from .month_world import build_world as build_month_world, training_windows
from .month_workflow import TRAIN_KW
from .mf_world import DATES, SR, MFWorld

SEED = 20260816                      # chip_smoke.py's
MF_KW = dict(minimum_interevent_time=5.0, min_channels=6, min_stations=3,
             max_kurto=1e6)
RUNGS = {"default": "mf_cc", "highest": "mf_cc_highest", "high": "mf_cc_split"}
# the cut world of --cut: every event inside 75,000 samples
CUT = dict(n_tp=4, day_sec=3000.0, n_src=600, n_sta=12,
           repeats=[("d1", 1, 39000), ("d2", 3, 60000), ("d2", 2, 20003)],
           events={"d1": [(40_000, 345), (60_003, 155)],
                   "d2": [(30_011, 270), (50_000, 500)]},
           n_train=64, n_epochs=1)
FULL = dict(n_tp=128, day_sec=86400.0, n_src=100_000, n_sta=32,
            n_train=256, n_epochs=2)


def cards_line() -> str:
    """Every card's name and power limit, as nvidia-smi gives them."""
    return "; ".join(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines())


def sync(devs) -> None:
    for d in dict.fromkeys(devs):
        torch.cuda.synchronize(d)


def wall_ms(fn, devs, reps: int = 3):
    """ms of `fn` on the host clock, every device synchronized after a
    warm call and after the runs: with work on several cards, no one
    card's events time it."""
    devs = list(devs)
    fn()
    sync(devs)
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(devs)
    return 1e3 * (time.perf_counter() - t) / reps


def device_ms(fn, dev, reps: int = 3):
    """ms of `fn`'s work queued on `dev` (CUDA events there)."""
    with torch.cuda.device(dev):
        fn()
        torch.cuda.synchronize(dev)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize(dev)
    return e0.elapsed_time(e1) / reps


def _r(x, digits: int = 3):
    return round(x, digits)


def on(dev, what: str, *tensors) -> None:
    """Raise unless every tensor lies on `dev`."""
    for t in tensors:
        if t.device != dev:
            raise AssertionError(f"{what} is on {t.device}, not {dev}")


def tensors_of(obj) -> list:
    return [v for v in vars(obj).values() if isinstance(v, torch.Tensor)]


def launched_everywhere(wrapper, before: dict, devs, what: str) -> dict:
    """The launches of `wrapper` on each card since `before`; raise unless
    every card of `devs` launched it."""
    got = {i: wrapper.launches_on[i] - before.get(i, 0)
           for i in wrapper.launches_on}
    missing = [d for d in dict.fromkeys(devs) if got.get(d.index, 0) < 1]
    if missing:
        raise AssertionError(f"{what}: no launch on {missing} ({got})")
    return {f"cuda:{i}": n for i, n in sorted(got.items()) if n}


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch")


def step_profile(step, batch, devs, n: int = 3) -> dict:
    """Where a training step's time goes, from torch.profiler over `n`
    steps (a warm one before): the profiled ms a step; a step's CUDA
    runtime calls (count and host ms) for the six that take the most
    host time; its launches (`LAUNCH_CALLS`: kernels and graphs), copies
    (cudaMemcpyAsync, peer copies too) and stream waits
    (cudaStreamWaitEvent, the cross-device orderings); each card's
    kernels run (count) and kernel and copy ms a step (its busy time).
    Each count and time is divided by `n`."""
    from torch.profiler import ProfilerActivity, profile

    step(batch)
    sync(devs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            step(batch)
        sync(devs)
        wall = (time.perf_counter() - t) / n
    calls, host_us, busy_us, kernels = {}, {}, {}, {}
    for e in prof.events():
        us = e.time_range.elapsed_us()
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev = f"cuda:{e.device_index}"
            busy_us[dev] = busy_us.get(dev, 0) + us
            if "memcpy" not in e.name.lower() and \
                    "memset" not in e.name.lower():
                kernels[dev] = kernels.get(dev, 0) + 1
        elif e.name.startswith("cuda"):
            calls[e.name] = calls.get(e.name, 0) + 1
            host_us[e.name] = host_us.get(e.name, 0) + us
    top = sorted(host_us, key=host_us.get, reverse=True)[:6]
    return dict(profiled_step_ms=_r(1e3 * wall, 2),
                launches=sum(calls.get(k, 0) for k in LAUNCH_CALLS) / n,
                copies=calls.get("cudaMemcpyAsync", 0) / n,
                waits=calls.get("cudaStreamWaitEvent", 0) / n,
                runtime_calls={k: [calls[k] / n, _r(host_us[k] / 1e3 / n)]
                               for k in top},
                kernels_run={k: v / n for k, v in sorted(kernels.items())},
                card_busy_ms={k: _r(v / 1e3 / n)
                              for k, v in sorted(busy_us.items())})


def mf_meshes(devs) -> dict:
    n = len(devs)
    return {f"tp2 x time{n // 2}": make_mesh({"tp": 2, "time": n // 2},
                                            devs),
            f"time{n}": make_mesh({"time": n}, devs),
            f"tp{n}": make_mesh({"tp": n}, devs),
            f"tp2 x time{n} (cards twice)": make_mesh({"tp": 2, "time": n},
                                                      devs * 2)}


def bp_meshes(devs) -> dict:
    n = len(devs)
    return {f"src2 x time{n // 2}": make_mesh({"src": 2, "time": n // 2},
                                             devs),
            f"src{n}": make_mesh({"src": n}, devs),
            f"time{n}": make_mesh({"time": n}, devs)}


def mf_days(world: MFWorld, tg, devs, out: dict) -> None:
    first = devs[0]
    day = world.day("d1")
    w = np.full(tg.moveouts_arr.shape, 1.0 / np.prod(
        tg.moveouts_arr.shape[1:]), np.float32)
    n_samp = day.shape[-1]
    for rung, name in RUNGS.items():
        wrapper = getattr(mf, name)
        plan = mf.MatchedFilterPlan(tg.waveforms_arr, tg.moveouts_arr, w,
                                    n_samp, precision=rung, device=first)
        dp = plan.pad_data(day)
        want = plan(dp)
        one_ms = device_ms(lambda: plan(dp), first)
        one_wall = wall_ms(lambda: plan(plan.pad_data(day)), devs, 2)
        for mesh_name, mesh in mf_meshes(devs).items():
            sp = sharded.ShardedMatchedFilterPlan(
                tg.waveforms_arr, tg.moveouts_arr, w, n_samp, mesh,
                precision=rung)
            grid, lay = sp.grid, sp.layout
            for (a, dev), p in sp.plans.items():
                on(dev, f"{rung} plan of template shard {a}", *tensors_of(p))
            sd = sp.pad_data(day)
            for (t, dev), ext in sd.exts.items():
                on(dev, f"time chunk {t} with its halos", ext)
            before = dict(wrapper.launches_on)
            got = sp(sd)
            sync(devs)
            launches = launched_everywhere(wrapper, before, grid.flat,
                                           f"{rung} on {mesh_name}")
            on(first, "the gathered CC", got)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"sharded {rung} on {mesh_name} != the unsharded kernel "
                    f"on {first}: max|diff| "
                    f"{float((got - want).abs().max()):.3g}")
            shards = [(a, t) for a, _, _ in sp.shards
                      for t in range(lay.n_t) if sp.n_lags(t)]
            shard_ms = {}
            for a, t in shards:
                dev = grid[a, t]
                on(dev, f"shard ({a}, {t})'s CC", sp.shard_cc(sd, a, t))
                shard_ms[f"{a},{t}@{dev}"] = _r(device_ms(
                    lambda: sp.shard_cc(sd, a, t), dev))
            src = torch.from_numpy(day.reshape(-1, n_samp))
            chunks = sharded._scatter(src, grid, lay)
            halo_ms = wall_ms(lambda: sharded._exchange(chunks, grid, lay),
                              grid.flat, 5)
            del chunks
            row = dict(
                day_ms=_r(wall_ms(lambda: sp(sd), grid.flat)),
                one_card_ms=_r(one_ms),
                upload_and_day_ms=_r(wall_ms(lambda: sp(sp.pad_data(day)),
                                             grid.flat, 2)),
                one_card_upload_and_day_ms=_r(one_wall),
                shard_ms=shard_ms, halo_ms=_r(halo_ms), launches=launches)
            out.setdefault("mf", {})[f"{rung} {mesh_name}"] = row
            print(f"mf {rung} {mesh_name}: equal to one card's bit for bit; "
                  f"{json.dumps(row)}", flush=True)
            del sp, sd, got
        del plan, dp, want


def bp_days(world: BPWorld, devs, out: dict) -> None:
    first = devs[0]
    feat = saturated_envelopes(world.day("d1"), device=first)[0]
    plan = bp.BeamformPlan(world.mv, world.w_ph, world.w_src,
                           world.n_samp, device=first)
    wv, wi = plan(feat)
    one_ms = device_ms(lambda: plan(feat), first, 2)
    for mesh_name, mesh in bp_meshes(devs).items():
        sp = sharded.ShardedBeamformPlan(world.mv, world.w_ph, world.w_src,
                                         world.n_samp, mesh)
        grid, lay = sp.grid, sp.layout
        for (a, dev), tab in sp.tables.items():
            on(dev, f"tables of source shard {a}", *[
                getattr(tab, f) for f in tab.__dataclass_fields__
                if isinstance(getattr(tab, f), torch.Tensor)])
        gd = sp.fold_and_pad(feat)
        for (t, dev), ext in gd.exts.items():
            on(dev, f"time chunk {t} with its halo", ext)
        before = dict(bp.bp_beam.launches_on)
        gv, gi = sp.call_folded(gd)
        sync(devs)
        launches = launched_everywhere(bp.bp_beam, before, grid.flat,
                                       f"bp on {mesh_name}")
        on(first, "the merged beam", gv, gi)
        if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
            raise AssertionError(
                f"sharded bp on {mesh_name} != the unsharded kernel on "
                f"{first}: values {float((gv - wv).abs().max()):.3g}, "
                f"{int((gi != wi).sum())} sources differ")
        shard_ms = {}
        for a, _, _ in sp.shards:
            for t in range(lay.n_t):
                if not sp.tile_range(t)[1]:
                    continue
                dev = grid[a, t]
                on(dev, f"shard ({a}, {t})'s beam",
                   *sp.shard_beam(gd, a, t))
                shard_ms[f"{a},{t}@{dev}"] = _r(device_ms(
                    lambda: sp.shard_beam(gd, a, t), dev, 2))
        g = bp.fold_components(feat, plan.weights_phases)
        chunks = sharded._scatter(g, grid, lay)
        halo_ms = wall_ms(lambda: sharded._exchange(chunks, grid, lay),
                          grid.flat, 5)
        del chunks, g
        row = dict(day_ms=_r(wall_ms(lambda: sp.call_folded(gd),
                                     grid.flat, 2)),
                   one_card_ms=_r(one_ms), shard_ms=shard_ms,
                   halo_ms=_r(halo_ms), launches=launches)
        out.setdefault("bp", {})[mesh_name] = row
        print(f"bp {mesh_name}: equal to one card's bit for bit; "
              f"{json.dumps(row)}", flush=True)
        del sp, gd, gv, gi


def mf_detections(res) -> dict:
    return {d: {t: sorted(round(e.origin_time_epoch * SR) for e in evs)
                for t, evs in r.items() if evs} for d, r in res.items()}


def bp_detections(res) -> dict:
    return {d: sorted((round(e.origin_time_epoch * SR),
                       e.aux_data["source_index"]) for e in evs)
            for d, evs in res.items()}


def campaigns(mfw: MFWorld, tg, bpw: BPWorld, devs, out: dict) -> None:
    """scan_days over both days of each world on one card and on a mesh:
    the same detections; s/day of the scan stages."""
    cfg = Config(sampling_rate_hz=SR, template_len_sec=tg.waveforms_arr
                 .shape[-1] / SR)
    cfg_bp = Config(sampling_rate_hz=SR)
    dates = list(DATES)
    meshes = {"mf": make_mesh({"tp": 2, "time": len(devs) // 2}, devs),
              "bp": make_mesh({"src": 2, "time": len(devs) // 2}, devs)}
    runs = {}
    for stage, where in (("mf", None), ("mf", "mesh"), ("bp", None),
                         ("bp", "mesh")):
        keys = (("mf_scan",) if stage == "mf" else
                ("bp_features", "bp_backproject", "bp_detect"))
        t0 = {k: GLOBAL_TIMER.times[k] for k in keys}
        kw = (dict(mesh=meshes[stage]) if where else dict(device=devs[0]))
        if stage == "mf":
            res = workflow.scan_days(
                dates, mfw.make_data, tg, cfg=cfg,
                rng=np.random.default_rng(SEED + 2), **MF_KW, **kw)
            hits = mf_detections(res)
        else:
            res = workflow.scan_days(
                dates, bpw.make_data, cfg=cfg_bp, stage="bp",
                network=bpw.network, travel_times=bpw.travel, **kw)
            hits = bp_detections(res)
        runs[(stage, where)] = hits
        out.setdefault("campaigns", {})[
            f"{stage} {'mesh' if where else 'one card'}"] = {
            k: round((GLOBAL_TIMER.times[k] - t0[k]) / len(dates), 4)
            for k in keys}
    for stage in ("mf", "bp"):
        if runs[(stage, "mesh")] != runs[(stage, None)]:
            raise AssertionError(f"scan_days({stage}, mesh=) detections "
                                 f"differ from one card's")
        out["campaigns"][f"{stage} detections"] = sum(
            len(v) for v in runs[(stage, None)].values())
    print(f"campaigns: detections identical on the mesh and one card; "
          f"s/day {json.dumps(out['campaigns'])}", flush=True)


def training(devs, size: dict, out: dict) -> None:
    """The month script's picker trained on {"data": n}: the first step
    against the unsharded one, the shards on their cards, then the
    epochs' losses within 1e-3 relative of the unsharded run's; then the
    step's ms and profile (`step_profile`)."""
    first = devs[0]
    mesh = make_mesh({"data": len(devs)}, devs)
    with tempfile.TemporaryDirectory(prefix="mesh_days_") as work:
        wavelet = build_month_world(work).wavelet
    x, picks = training_windows(wavelet, size["n_train"])
    labels = gaussian_pick_labels(picks, x.shape[-1], sigma=TRAIN_KW["sigma"])
    nb = TRAIN_KW["batch_size"] // len(devs) * len(devs)
    batch = np.random.default_rng(0).permutation(len(x))[:nb]
    xb = torch.from_numpy(x[batch]).to(first)
    yb = torch.from_numpy(labels[batch]).to(first)
    res = []
    for shard in (False, True):
        model = init_weights(PhaseNet(),
                             torch.Generator().manual_seed(0)).to(first)
        opt = torch.optim.Adam(model.parameters(),
                               lr=TRAIN_KW["learning_rate"])
        step = (make_sharded_train_step(model, opt, mesh) if shard
                else make_train_step(model, opt))
        loss = float(step((xb, yb)))
        res.append((loss, {k: p.grad.double().cpu()
                           for k, p in model.named_parameters()},
                    {k: t.double().cpu() for k, t in
                     model.state_dict().items() if "running_" in k}))
    with torch.no_grad():
        parts = model(Shards(xb[k::len(devs)].to(d)
                             for k, d in enumerate(devs))).parts
    for dev, part in zip(devs, parts):
        on(dev, "a shard's probabilities", part)
    (l_u, g_u, s_u), (l_s, g_s, s_s) = res
    g_scale = max(float(g.abs().max()) for g in g_u.values())
    err_g = max(float((g_s[k] - g_u[k]).abs().max()) for k in g_u) / g_scale
    err_bn = max(float(((s_s[k] - s_u[k]).abs()
                        / s_u[k].abs().clamp(min=1e-3)).max()) for k in s_u)
    if abs(l_s - l_u) > 1e-5 or err_g > 1e-4 or err_bn > 1e-4:
        raise AssertionError(
            f"sharded step ({len(devs)} shards) vs unsharded: loss {l_s} / "
            f"{l_u} (gate 1e-5), gradients {err_g:.3g} of the largest (gate "
            f"1e-4), running statistics {err_bn:.3g} (gate 1e-4)")
    kw = dict(TRAIN_KW, n_epochs=size["n_epochs"])
    n_steps = kw["n_epochs"] * (len(x) // kw["batch_size"])
    runs = {}
    for where in ("one card", "mesh"):
        sync(devs)
        t = time.perf_counter()
        _, _, losses = train_phasenet(
            x, picks, seed=0, verbose=False,
            **(dict(mesh=mesh) if where == "mesh" else dict(device=first)),
            **kw)
        sync(devs)
        runs[where] = (losses, 1e3 * (time.perf_counter() - t) / n_steps)
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(runs["mesh"][0], runs["one card"][0]))
    if rel > 1e-3:
        raise AssertionError(f"sharded training losses {runs['mesh'][0]} "
                             f"against {runs['one card'][0]} (gate 1e-3 "
                             f"relative)")
    out["training"] = dict(
        first_step=dict(loss=abs(l_s - l_u), gradients=err_g,
                        running_statistics=err_bn),
        losses_rel=rel, steps=n_steps,
        ms_a_step={k: _r(v[1], 2) for k, v in runs.items()})
    # the step alone at the script's batch and at the whole training set,
    # and where its time goes (torch.profiler) at the script's batch
    labels_t = torch.from_numpy(labels)
    for nb_ in dict.fromkeys((nb, len(x) // len(devs) * len(devs))):
        batch = (torch.from_numpy(x[:nb_]).to(first), labels_t[:nb_].to(first))
        for where in ("one card", "mesh"):
            model = init_weights(PhaseNet(),
                                 torch.Generator().manual_seed(0)).to(first)
            opt = torch.optim.Adam(model.parameters(),
                                   lr=TRAIN_KW["learning_rate"])
            step = (make_sharded_train_step(model, opt, mesh)
                    if where == "mesh" else make_train_step(model, opt))
            key = f"{where}, batch {nb_}"
            out["training"].setdefault("step_ms", {})[key] = _r(
                wall_ms(lambda: step(batch), devs, 5), 2)
            if nb_ == nb:
                out["training"].setdefault("profile", {})[key] = (
                    step_profile(step, batch, devs))
    print(f"training on {len(devs)} shards: {json.dumps(out['training'])}",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cut", action="store_true",
                    help="the cut world (4 templates, 600 sources, 3,000 s "
                         "days)")
    args = ap.parse_args(argv)
    devs = [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]
    make_mesh(devices=None)                     # raises without CUDA
    if len(devs) < 2 or len(devs) % 2:
        raise SystemExit(f"needs an even number of devices, 2 or more: "
                         f"{len(devs)}")
    size = CUT if args.cut else FULL
    t_start = time.perf_counter()
    card = cards_line()
    n = len(devs)
    out = {"devices": [str(d) for d in devs], "cards": card,
           "peer_access": {
               f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
               for i in range(n) for j in range(n) if i != j}}
    mfw = MFWorld(SEED, n_tp=size["n_tp"], day_sec=size["day_sec"],
                  **({"repeats": size["repeats"]} if "repeats" in size
                     else {}))
    _, tg = mfw.bank()
    bpw = BPWorld(SEED, n_src=size["n_src"], n_sta=size["n_sta"],
                  day_sec=size["day_sec"],
                  **({"events": size["events"]} if "events" in size
                     else {}))
    # training first: torch.profiler keeps every device row in a process
    # that has not yet kept the cards busy for minutes
    training(devs, size, out)
    mf_days(mfw, tg, devs, out)
    bp_days(bpw, devs, out)
    campaigns(mfw, tg, bpw, devs, out)
    out["seconds"] = round(time.perf_counter() - t_start, 1)
    print(f"mesh_days: every check passed on {len(devs)} devices "
          f"({out['seconds']} s) [{card}]", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
