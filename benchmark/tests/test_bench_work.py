"""The rooflines count the problem's operations and bytes, by hand at
tiny shapes, and read at most 100% of what a trace's rows allow."""

import types

import numpy as np
import pytest

from benchmark import devtrace, harness, work
from benchmark.reference import bp as ref_bp


def test_mf_day_counts_by_hand():
    p = dict(n_pairs=6, L=4, n_lags=10, n_channels=3, n_samples=13,
             n_templates=2)
    flops, nbytes = work.mf_cc_day(p)
    assert flops == 2 * 6 * 4 * 10
    # day 3 x 13, templates 2 x 3 x 4, moveouts 2 x 3, CC 2 x 10: 4 B each
    assert nbytes == 4 * (39 + 24 + 6 + 20)


def test_bp_day_counts_by_hand():
    p = dict(n_pairs=8, n_samples=100, n_sources=5, n_stations=2,
             n_components=3, n_phases=2)
    flops, nbytes = work.bp_beam_day(p)
    assert flops == 2 * 8 * 100
    # features 2 x 3 x 100, moveouts 5 x 2 x 2, source weights 5 x 2,
    # phase weights 2 x 3 x 2, max and argmax 2 x 100
    assert nbytes == 4 * (600 + 20 + 10 + 12 + 200)


def test_the_year_banks_pairs_are_its_weighted_channels(root, small):
    import torch

    from benchmark.generators import year_world
    from benchmark.reference import mf as ref_mf

    cell = harness.resolve(root, "mf_year_screen")
    sizes = dict(cell.config["sizes"], **small("mf_year_screen"))
    world = year_world.build(sizes, cell.traffic, 5, torch.device("cpu"))
    w = ref_mf.channel_weights(world.templates, 3, 2)
    assert world.problem["n_pairs"] == int((w != 0).sum()) == 8 * 4 * 3
    assert world.problem["n_lags"] == 50_000 - 200 + 1


def test_closest_weights_keep_ties_and_count_used_pairs():
    mv = np.zeros((2, 4, 2), np.int64)
    mv[0, :, 0] = [3, 1, 2, 2]     # k = 2: stations 1, 2 and the tie 3
    mv[1, :, 0] = [0, 5, 6, 7]     # k = 2: stations 0 and 1
    w = ref_bp.closest_station_weights(mv, 2)
    np.testing.assert_allclose(w[0], [0, 1 / 3, 1 / 3, 1 / 3], rtol=1e-6)
    np.testing.assert_allclose(w[1], [0.5, 0.5, 0, 0])
    assert int((w != 0).sum()) * 2 == 10


def _run(trace, n_days=2, problem=None):
    rec = types.SimpleNamespace(days=list(range(n_days)), window_s=2.0,
                                peak_bytes=0, stages_before={},
                                stages_after={})
    return harness.RunView(rec, problem, trace, 1.0)


def test_a_roofline_share_is_the_least_time_over_the_rows():
    p = dict(n_pairs=1000, L=200, n_lags=10 ** 6, n_channels=30,
             n_samples=10 ** 6 + 199, n_templates=100)
    flops, nbytes = work.mf_cc_day(p)
    least = work.least_seconds(flops, nbytes, work.PEAKS["bf16_flops"])
    assert least == flops / 989e12
    ev = [{"ph": "X", "cat": "kernel", "name": "mf_kernel(float const*)",
           "ts": 0.0, "dur": 4 * least * 1e6},
          {"ph": "X", "cat": "kernel", "name": "mf_prepass(float const*)",
           "ts": 1e7, "dur": 0.0},
          {"ph": "X", "cat": "kernel", "name": "mf_split_kernel(x)",
           "ts": 2e7, "dur": 1e6}]
    tr = devtrace.summarize(ev)
    share = work.roofline_share(_run(tr, 2, p), {r"^mf_prepass\b": "",
                                                 r"^mf_kernel\b": ""},
                                work.mf_cc_day, "bf16_flops")
    assert share == pytest.approx(50.0)        # two days over four
    assert work.roofline_share(_run(None, 2, p), {}, work.mf_cc_day,
                               "bf16_flops") is None


def test_busy_idle_and_the_host_stages_of_a_gap():
    ev = [{"ph": "X", "cat": "kernel", "name": "a(int)", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 5,
           "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 50, "dur": 10},
          {"ph": "X", "cat": "user_annotation", "name": "stage:mf_scan",
           "ts": 0, "dur": 100, "tid": 7},
          {"ph": "X", "cat": "user_annotation", "name": "stage:mf_refine",
           "ts": 20, "dur": 20, "tid": 7},
          {"ph": "X", "cat": "user_annotation", "name": "stage:mf_set_data",
           "ts": 60, "dur": 40, "tid": 8},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 99,
           "dur": 1, "tid": 7}]
    tr = devtrace.summarize(ev, main_tid=7)
    assert tr.busy_s == pytest.approx(25e-6)
    assert tr.span_s == pytest.approx(100e-6)
    assert tr.idle_gaps[0] == ["mf_scan | mf_set_data (thread)",
                               pytest.approx(40e-6)]
    assert tr.idle_gaps[1] == ["mf_refine", pytest.approx(35e-6)]
    assert tr.rows(r"^a\b") == (1, pytest.approx(10e-6))
    assert tr.device_ops[0][0] in ("a", "Memcpy HtoD", "b")


def test_busy_is_each_cards_union_averaged_over_the_cards():
    ev = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 40,
           "args": {"device": 0}},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 10, "dur": 40,
           "args": {"device": 0}},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 60, "dur": 20,
           "args": {"device": 1}},
          {"ph": "X", "cat": "cpu_op", "name": "x", "ts": 0, "dur": 100}]
    tr = devtrace.summarize(ev, n_devices=2)
    assert tr.busy_s == pytest.approx((50e-6 + 20e-6) / 2)
    assert tr.idle_gaps[0][1] == pytest.approx(20e-6)
