"""The year bank's `screen` campaign over a 'tp' mesh, as the benchmark's
four-card cell runs it (`workflow.scan_days(mesh=make_mesh({"tp": 4}))`),
on the CPU at a cut.

The world is the year bank's in small (BASELINE config 4 with distinct
templates): 8 sources under 4 stations, each with its own moveouts and its
own burst on every channel; the JAX package cuts one template from each
source's event in a seed day, and each campaign day holds two events of
every source at seeded times.  The JAX package's `scan_days` on a 'tp'
mesh of four CPU devices, the port's on a 'tp' mesh of four and the
port's without a mesh find the same detections, every planted event among
them; the port's two runs are identical and within 1e-5 of the JAX
package's CC.  Every day files the sharded scan's span and meters;
`mf_gather_bytes` counts the CC bytes copied from another device into the
first, none on a mesh whose devices all repeat, and `mf_shard_launches`
the launches that `ops.mf` counts."""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from seismic_bpmf_tpu import workflow as jwf  # noqa: E402
from seismic_bpmf_tpu.config import Config  # noqa: E402
from seismic_bpmf_tpu.data import (  # noqa: E402
    Data, Event, Network, Template, TemplateGroup, data_reader_hdf5,
    write_hdf5_continuous,
)
from seismic_bpmf_tpu.data.stream import Stream, Trace  # noqa: E402
from seismic_bpmf_tpu.parallel import make_mesh as jax_mesh  # noqa: E402

import seismic_bpmf_tpu_torch.config as tconfig  # noqa: E402
import seismic_bpmf_tpu_torch.data as tdata  # noqa: E402
from seismic_bpmf_tpu_torch import workflow  # noqa: E402
from seismic_bpmf_tpu_torch.ops import mf as _mf  # noqa: E402
from seismic_bpmf_tpu_torch.parallel import make_mesh, sharded  # noqa: E402
from seismic_bpmf_tpu_torch.utils.observe import GLOBAL_TIMER  # noqa: E402

SR = 25.0
DAY = 2000.0
N_STA = 4
N_TP = 8
T0 = 1343260800.0       # 2012-07-26
DATES = ["mesh-day-0", "mesh-day-1"]
# the year bank's scan, at a cut: plans of 4 templates, extraction chunks
# of 5 (shards of 2, 2, 1 and then 1, 1, 1 over four devices)
SCAN_KW = dict(minimum_interevent_time=5.0, threshold_window_dur=1800.0,
               min_channels=3, min_stations=2, max_kurto=1e6,
               template_chunk=4,
               max_memory_gb=5.5 * 4.0 * DAY * SR / 1024.0 ** 3)
CPU4 = [torch.device("cpu")] * 4


def _burst(rng, n_w=int(1.5 * SR)):
    return rng.normal(size=n_w) * np.hanning(n_w)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_year")
    rng = np.random.default_rng(2 ** 31 + 77)
    cfg = Config(data_buffer_sec=0.0, sampling_rate_hz=SR,
                 template_len_sec=8.0, n_dev_mf_threshold=8.0)
    md = pd.DataFrame({
        "stations": [f"S{i}" for i in range(N_STA)],
        "networks": ["XX"] * N_STA,
        "latitude": 40.0 + 0.05 * np.arange(N_STA),
        "longitude": 30.0 + 0.05 * np.arange(N_STA),
        "elevation_m": np.zeros(N_STA),
    })
    net = Network.from_dataframe(md)
    tt_p = rng.uniform(1.0, 5.0, (N_TP, N_STA))
    tts = np.stack([tt_p, 1.7 * tt_p], axis=2)      # (n_tp, n_sta, P/S)
    bursts = [[[_burst(rng) for _ in "NEZ"] for _ in range(N_STA)]
              for _ in range(N_TP)]
    n = int(DAY * SR)

    def write_day(name, events):
        """events: [(source, origin s)] -> the day's HDF5 file."""
        st = Stream()
        for s in range(N_STA):
            for c, comp in enumerate("NEZ"):
                x = 0.05 * rng.normal(size=n).astype(np.float32)
                for src, ot in events:
                    k = int((ot + tts[src, s, 0 if comp == "Z" else 1]) * SR)
                    b = bursts[src][s][c]
                    x[k:k + len(b)] += b
                st += Trace(x, station=f"S{s}", network="XX",
                            channel=f"HH{comp}", sampling_rate=SR,
                            starttime=T0)
        path = str(tmp / f"{name}.h5")
        write_hdf5_continuous(path, st)
        return path

    write_day("seed", [(i, 100.0 + 200.0 * i) for i in range(N_TP)])
    templates = []
    for i in range(N_TP):
        ev = Event(T0 + 100.0 + 200.0 * i, tts[i], net.stations, ["P", "S"],
                   "seed.h5", str(tmp), sampling_rate=SR)
        ev.read_waveforms(cfg.template_len_sec, data_reader=data_reader_hdf5)
        tp = Template.init_from_event(ev)
        tp.set_aux_data({"tid": i})
        tp.id = str(i)
        templates.append(tp)
    bank = TemplateGroup(templates, net)

    # two events of every source a day, one in each half, 60 s from the
    # day's ends and 10 s from the other half
    half = (DAY - 120.0) / 2
    origins = [60.0 + half * np.arange(2)[None]
               + np.round(rng.uniform(10.0, half - 20.0, (N_TP, 2)) * SR)
               / SR for _ in DATES]
    days = [write_day(d, [(i, o) for i in range(N_TP) for o in origins[k][i]])
            for k, d in enumerate(DATES)]
    tbank = tdata.TemplateGroup.from_arrays(
        bank.waveforms_arr, bank.moveouts_arr, bank.tids,
        stations=bank.stations, components=bank.components,
        sampling_rate=SR, phases=templates[0].phases,
        moveouts_sec=np.stack([tp.moveouts.loc[bank.stations].values
                               for tp in templates]),
        locations=np.zeros((N_TP, 3)),
        origin_times=[tp.origin_time for tp in templates])
    tcfg = tconfig.Config(**{k: getattr(cfg, k) for k in (
        "data_buffer_sec", "sampling_rate_hz", "template_len_sec",
        "n_dev_mf_threshold")})
    return dict(cfg=cfg, bank=bank, tcfg=tcfg, tbank=tbank, days=days,
                origins=origins)


def _keys(out):
    """{date: sorted (tid, origin sample, cc)} of either package's run."""
    t0 = np.datetime64(int(T0 * 1e9), "ns")
    return {d: sorted((int(str(t)), int(round(
        (np.datetime64(e.origin_time, "ns") - t0) / np.timedelta64(1, "ns")
        * 1e-9 * SR)), float(e.aux_data["cc"]))
        for t, evs in r.items() for e in evs) for d, r in out.items()}


def _port(w, mesh):
    path = dict(zip(DATES, w["days"]))
    place = dict(device="cpu") if mesh is None else dict(mesh=mesh)
    return _keys(workflow.scan_days(
        DATES, lambda d: tdata.Data("2012-07-26", path[d],
                                    tdata.data_reader_hdf5, duration=DAY,
                                    sampling_rate=SR).read_waveforms(),
        w["tbank"], cfg=w["tcfg"], precision="screen",
        rng=np.random.default_rng(23), **place, **SCAN_KW))


def test_a_sharded_year_campaign_finds_the_unsharded_detections(world):
    w = world
    path = dict(zip(DATES, w["days"]))
    jout = _keys(jwf.scan_days(
        DATES, lambda d: Data("2012-07-26", path[d], data_reader_hdf5,
                              duration=DAY, sampling_rate=SR)
        .read_waveforms(),
        w["bank"], cfg=w["cfg"], precision="screen",
        mesh=jax_mesh({"tp": 4, "time": 1}, jax.devices()[:4]), **SCAN_KW))
    plain = _port(w, None)
    meshed = _port(w, make_mesh({"tp": 4}, CPU4))
    assert meshed == plain
    for k, d in enumerate(DATES):
        assert [x[:2] for x in meshed[d]] == [x[:2] for x in jout[d]]
        np.testing.assert_allclose([x[2] for x in meshed[d]],
                                   [x[2] for x in jout[d]], rtol=0,
                                   atol=1e-5)
        found = {x[:2] for x in meshed[d]}
        planted = {(t, int(round(o * SR))) for t in range(N_TP)
                   for o in w["origins"][k][t]}
        assert planted <= found, (d, sorted(planted - found))
        day = GLOBAL_TIMER.day_spans[d]
        meters = GLOBAL_TIMER.day_meters[d]
        # two extraction chunks a day: shards of 2, 2, 1 and of 1, 1, 1;
        # no kernel launches on CPU devices, no row from another device
        assert day["mf_shard_scan"][2] == 2
        assert meters["mf_shard_launches"] == 0
        assert meters["mf_gather_bytes"] == 0
    assert "mf_dispatch" in GLOBAL_TIMER.parents["mf_shard_scan"]


def _problem(rng, n_tp=5, n_sta=2, n_comp=3, L=20, n_samp=6000):
    return (rng.normal(size=(n_tp, n_sta, n_comp, L)).astype(np.float32),
            rng.integers(0, 30, size=(n_tp, n_sta, n_comp)),
            np.full((n_tp, n_sta, n_comp), 1.0 / (n_sta * n_comp),
                    np.float32),
            rng.normal(size=(n_sta, n_comp, n_samp)).astype(np.float32))


def _counted(wrapper, prepass):
    """`wrapper` counting a launch of itself and of `prepass` on each call,
    as it does on a card."""
    def f(*args, **kwargs):
        f.launches += 1
        prepass.launches += 1
        return wrapper(*args, **kwargs)
    f.launches = 0
    return f


@pytest.mark.parametrize("devices,shape", [
    (CPU4, {"tp": 2, "time": 2}),
    ([torch.device("cpu", i) for i in range(4)], {"tp": 2, "time": 2}),
    ([torch.device("cpu", i) for i in range(3)], {"tp": 3}),
])
def test_gather_bytes_count_the_rows_copied_from_another_device(
        devices, shape, monkeypatch):
    """A mesh of `cpu:<i>` devices stands for distinct cards: they compare
    unequal, so a shard there counts its rows as copied into the first.
    The launches are those of `ops.mf`'s counters, made to count here as
    they do on a card: the pre-pass and the main kernel of each shard."""
    templates, moveouts, weights, data = _problem(np.random.default_rng(3))
    plan = sharded.ShardedMatchedFilterPlan(
        templates, moveouts, weights, data.shape[-1],
        make_mesh(shape, devices), precision="default")
    # two time shards of 4,096 lags and the rest of the day's 5,981
    assert [plan.n_lags(t) for t in range(plan.layout.n_t)] == (
        [4096, 1885] if "time" in shape else [5981])
    want = sum((s1 - s0) * plan.n_lags(t) * 4 for a, s0, s1 in plan.shards
               for t in range(plan.layout.n_t)
               if plan.grid[a, t] != plan.device)
    monkeypatch.setattr(_mf.tf32_day, "launches", _mf.tf32_day.launches)
    monkeypatch.setattr(_mf, "mf_cc", _counted(_mf.mf_cc, _mf.tf32_day))
    meters = dict(GLOBAL_TIMER.meters)
    out = plan(plan.pad_data(data))
    got = {m: GLOBAL_TIMER.meters[m] - meters.get(m, 0.0)
           for m in ("mf_gather_bytes", "mf_shard_launches")}
    assert got["mf_gather_bytes"] == want
    assert got["mf_shard_launches"] == 2 * len(plan.shards) * (
        plan.layout.n_t) == 2 * _mf.mf_cc.launches
    assert (want == 0) == (len(set(devices)) == 1)
    unsharded = sharded.ShardedMatchedFilterPlan(
        templates, moveouts, weights, data.shape[-1],
        make_mesh({"tp": 1}, ["cpu"]), precision="default")
    torch.testing.assert_close(out, unsharded(unsharded.pad_data(data)),
                               rtol=0, atol=1e-6)
