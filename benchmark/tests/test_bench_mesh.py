"""The four-card cell, `mf_year_screen_4card`: the harness finds its parts,
and its configuration is the year bank's sizes laid over four cards;
on a virtual mesh of four CPU devices a sound run is correct and reads
the sharded scan's span and meter, and a run whose gather loses or
shifts one template shard's rows is not; the control is not correct; the
readers of the device trace read the cards' peer copies, and kernel #1's
roofline its rows summed over the cards; every new reader reads None
where the program keeps nothing for it."""

import math
import time
import types

import pytest
import torch

from benchmark import control, devtrace, harness, work

CELL = "mf_year_screen_4card"
NEW = ("mf_shard_dispatch_s", "mf_gather_gib", "mf_peer_copy_s")
CPU4 = [torch.device("cpu")] * 4
SHARD = "seismic_bpmf_tpu_torch.parallel.sharded:ShardedMatchedFilterPlan"


def test_the_four_card_cell_is_found_with_its_parts(root):
    cell = harness.resolve(root, CELL)
    assert cell.entry["chips"] == 4
    assert cell.entry["config"] == "year_bank_4card"
    one = harness.resolve(root, "mf_year_screen")
    assert {k: cell.config[k] for k in ("generator", "reference", "sizes",
                                        "check", "reduced")} == {
        k: one.config[k] for k in ("generator", "reference", "sizes",
                                   "check", "reduced")}
    assert cell.config["layout"]["mesh"] == cell.traffic["engine"]["mesh"]
    assert cell.traffic["engine"] == {"precision": "screen",
                                      "mesh": {"tp": 4}}
    assert cell.limits == harness.resolve(root, "mf_year_screen").limits
    assert {"mf_day_s", "peak_device_gib", "setup_s"} <= set(cell.end_to_end)
    assert set(NEW) <= set(cell.per_layer)
    assert {"mf_scan_s", "mf_dispatch_s", "mf_collect_s", "mf_select_s",
            "mf_host_loop_s", "mf_set_data_s", "mf_refine_yield",
            "device_idle.mf", "roofline.mf_screen_cc"} <= set(
                cell.per_layer)
    for m in NEW:
        assert harness.load_metric(m).UNIT
    args = harness.scan_args(
        types.SimpleNamespace(scan_args=dict(device="cpu", stage="mf")),
        cell.traffic, CPU4)
    assert args["mesh"].shape == {"tp": 4} and "device" not in args


def _small():
    """The CPU sizes of the year bank, whose sizes this configuration has."""
    from conftest import SMALL

    return SMALL["year_bank"]


def _run(root, trace=False):
    return harness.run_cell(root, CELL, 2 ** 31 + 41, 0.01, trace, CPU4,
                            time.perf_counter(), overrides=_small())


def test_a_sound_traced_run_on_a_virtual_mesh_reads_the_sharded_scan(
        root):
    out = _run(root, trace=True)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["count"] == 4
    got = out["metrics"]
    assert math.isfinite(got["mf_shard_dispatch_s"]["value"])
    # every device is the CPU: no row crosses from another device
    assert got["mf_gather_gib"]["value"] == 0.0
    # no device rows on the CPU
    assert "mf_peer_copy_s" not in got and "roofline.mf_screen_cc" not in got


def _rows_dropped(shard_cc):
    def f(self, day, a, t):
        cc = shard_cc(self, day, a, t)
        return torch.zeros_like(cc) if a == 1 else cc
    return f


def _rows_shifted(shard_cc):
    def f(self, day, a, t):
        cc = shard_cc(self, day, a, t)
        return torch.roll(cc, 1, dims=1) if a == 1 else cc
    return f


@pytest.mark.parametrize("wrap", [_rows_dropped, _rows_shifted])
def test_a_gather_that_loses_a_shards_rows_is_not_correct(root, wrap,
                                                          monkeypatch):
    import importlib

    mod, cls = SHARD.split(":")
    obj = getattr(importlib.import_module(mod), cls)
    monkeypatch.setattr(obj, "shard_cc", wrap(obj.shard_cc))
    out = _run(root)
    assert out["correct"] is False and out["failed"] >= 1
    assert any(not out["checks"][n]["value"] <= out["checks"][n]["limit"]
               for n in ("cc_gap", "missed")), out["checks"]


def test_the_control_is_not_correct_at_a_small_size(root):
    for seed in (1, 2, 3):
        r = control.readings(root, CELL, seed, 2, "cpu",
                             overrides=_small())
        assert r["correct"] is False and r["failed"] >= 1, (seed, r)


@pytest.mark.cuda
def test_the_control_is_not_correct_at_the_cells_size(root, cuda):
    r = control.readings(root, CELL, 2 ** 31 + 5, 2, cuda)
    assert r["correct"] is False and r["failed"] >= 1, r


PROBLEM = dict(kind="mf", n_templates=1024, n_channels=30, L=200,
               n_samples=2_160_000, n_lags=2_159_801, n_pairs=30_720)


def _view(trace, n_days=2):
    return types.SimpleNamespace(trace=trace, n_days=n_days,
                                 problem=PROBLEM)


def test_the_trace_readers_sum_over_the_cards():
    names = {"Memcpy PtoP (Device -> Device)": [18, 0.04],
             "Memcpy HtoD (Pageable -> Device)": [2, 0.5],
             "mf_kernel(float const*, int)": [16, 0.6],
             "mf_prepass(float const*, long long)": [16, 0.02]}
    view = _view(devtrace.Trace(busy_s=1.0, span_s=2.0, names=names))
    assert harness.load_metric("mf_peer_copy_s").read(view) == (
        pytest.approx(0.02))
    roof = harness.load_metric("roofline.mf_screen_cc")
    flops, nbytes = work.mf_cc_day(PROBLEM)
    least = work.least_seconds(flops, nbytes, work.PEAKS["bf16_flops"])
    assert roof.read(view) == pytest.approx(100.0 * 2 * least / 0.62)


def test_every_new_reader_reads_none_without_its_records(monkeypatch):
    from seismic_bpmf_tpu_torch.utils.observe import GLOBAL_TIMER

    monkeypatch.setattr(GLOBAL_TIMER, "day_spans",
                        {"d000004": {"mf_dispatch": [0.5, 0.5, 1]}})
    monkeypatch.setattr(GLOBAL_TIMER, "day_meters",
                        {"d000004": {"mf_detections": 2048}})
    run = types.SimpleNamespace(
        n_days=1, record=types.SimpleNamespace(days=[4]),
        trace=devtrace.Trace(busy_s=0.0, span_s=1.0, names={}),
        problem=PROBLEM)
    for m in NEW:
        assert harness.load_metric(m).read(run) is None, m
    GLOBAL_TIMER.day_spans["d000004"]["mf_shard_scan"] = [0.25, 0.2, 2]
    GLOBAL_TIMER.day_meters["d000004"]["mf_gather_bytes"] = 2.0 ** 31
    assert harness.load_metric("mf_shard_dispatch_s").read(run) == 0.25
    assert harness.load_metric("mf_gather_gib").read(run) == 2.0
