"""The metrics that read the program's per-day records: a small traced run
on the CPU reads a finite value from each that applies to the cell, and a
program that keeps no such records reads None."""

import math
import time
import types

import pytest

from benchmark import harness, spans

NEW = {"mf_wait_s", "mf_read_s", "mf_upload_s", "mf_dispatch_s",
       "mf_collect_s", "mf_select_s", "mf_refine_yield", "bp_stack_s",
       "bp_weights_s", "bp_threshold_s", "bp_peaks_s"}


@pytest.mark.parametrize("cell", ["mf_year_screen", "mf_year_high",
                                  "bp_lattice_day"])
def test_a_traced_run_reads_every_day_span_metric(root, small, cell):
    want = NEW & set(harness.resolve(root, cell).per_layer)
    assert want
    out = harness.run_cell(root, cell, 2 ** 31 + 23, 0.01, True, "cpu",
                           time.perf_counter(), overrides=small(cell))
    assert out["correct"] is True
    for m in want:
        assert math.isfinite(out["metrics"][m]["value"]), m
    if cell == "mf_year_screen":
        assert 0.0 < out["metrics"]["mf_refine_yield"]["value"] <= 100.0


def test_a_day_without_a_record_reads_none(monkeypatch):
    from seismic_bpmf_tpu_torch.utils.observe import GLOBAL_TIMER

    run = types.SimpleNamespace(n_days=2, record=types.SimpleNamespace(
        days=[7, 8]))
    monkeypatch.setattr(GLOBAL_TIMER, "day_spans",
                        {"d000007": {"scan_wait": [0.5, 0.5, 1]}})
    monkeypatch.setattr(GLOBAL_TIMER, "day_meters", {})
    assert spans.stage_per_day(run, "scan_wait") is None
    assert spans.meter_total(run, "mf_candidates") is None
    GLOBAL_TIMER.day_spans["d000008"] = {"scan_wait": [0.25, 0.2, 1]}
    assert spans.stage_per_day(run, "scan_wait") == 0.375
    assert spans.stage_per_day(run, "scan_wait", spans.SELF_SECONDS) == 0.35
    assert spans.stage_per_day(run, "mf_collect") is None
    monkeypatch.delattr(GLOBAL_TIMER, "day_spans")
    assert spans.stage_per_day(run, "scan_wait") is None
