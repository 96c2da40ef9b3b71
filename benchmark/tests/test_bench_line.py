"""A run on the CPU at a small size: the result line's keys, the metrics
of each kind of run, and the checks last, each beside its limit."""

import json
import time

import pytest

from benchmark import harness


@pytest.mark.parametrize("cell,trace", [("mf_year_screen", False),
                                        ("mf_year_high", True),
                                        ("bp_lattice_day", False)])
def test_a_small_run_prints_the_contracts_line(root, small, cell, trace):
    out = harness.run_cell(root, cell, 2 ** 31 + 11, 0.01, trace, "cpu",
                           time.perf_counter(), overrides=small(cell))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    c = harness.resolve(root, cell)
    want = c.per_layer if trace else c.end_to_end
    # the CPU has no device rows and no peak: those metrics stay out
    assert set(out["metrics"]) <= set(want)
    host = {"mf_scan_s", "mf_set_data_s", "mf_host_loop_s", "mf_day_s",
            "bp_day_s", "setup_s", "bp_backproject_s", "bp_features_s",
            "bp_detect_s"}
    assert set(want) & host <= set(out["metrics"])
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(out["checks"]) == set(c.limits)
    lines = harness.check_lines(out)
    assert len(lines) == len(c.limits)
    assert all(" limit " in line for line in lines)
    json.dumps(out)
