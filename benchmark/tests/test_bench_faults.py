"""A run whose timed path is broken underneath reads `correct` false:
half the batch left out, and an answer altered where it is produced.  (A
cell of one card has no exchange between cards, and no cell trains, so
no step returns a state.)  The harness's look for a card is skipped; the
rest of a run is driven on the CPU at a small size."""

import contextlib
import time

import pytest
import torch

from benchmark import harness


def _run(root, small, cell):
    return harness.run_cell(root, cell, 977, 0.01, False, "cpu",
                            time.perf_counter(), overrides=small(cell))


@contextlib.contextmanager
def _wrapped(obj, name, wrap):
    old = getattr(obj, name)
    setattr(obj, name, wrap(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def _half_templates(call):
    def f(self, data_pad):
        out = call(self, data_pad)
        out[out.shape[0] // 2:] = 0.0
        return out
    return f


def _cc_shifted(call):
    def f(self, data_pad):
        return call(self, data_pad) + 1e-3
    return f


def _detection_moved(build):
    def f(self, tid, tt, cc_idx, cc_vals, thr_vals):
        return build(self, tid, tt, [int(i) + 1 for i in cc_idx], cc_vals,
                     thr_vals)
    return f


def _half_stations(fold):
    def f(self, features):
        g = fold(self, features)
        g[: g.shape[0] // 2] = 0.0
        return g
    return f


def _beam_raised(call):
    def f(self, g_pad):
        val, idx = call(self, g_pad)
        return val + 1e-2, idx
    return f


def _argmax_moved(call):
    def f(self, g_pad):
        val, idx = call(self, g_pad)
        return val, (idx + 1) % self.n_src
    return f


MF = "seismic_bpmf_tpu_torch.ops.mf:MatchedFilterPlan"
ENGINE = "seismic_bpmf_tpu_torch.detection.matched_filter:MatchedFilter"
BP = "seismic_bpmf_tpu_torch.ops.bp:BeamformPlan"


@pytest.mark.parametrize("cell,where,name,wrap,number", [
    ("mf_year_screen", MF, "__call__", _half_templates, "missed"),
    ("mf_year_high", MF, "__call__", _half_templates, "missed"),
    ("mf_year_screen", MF, "__call__", _cc_shifted, "cc_gap"),
    ("mf_year_high", MF, "__call__", _cc_shifted, "cc_gap"),
    ("mf_year_screen", ENGINE, "_build_events", _detection_moved, "missed"),
    ("bp_lattice_day", BP, "fold_and_pad", _half_stations, "beam_gap"),
    ("bp_lattice_day", BP, "call_folded", _beam_raised, "beam_gap"),
    ("bp_lattice_day", BP, "call_folded", _argmax_moved, "argmax_gap"),
])
def test_a_broken_timed_path_is_not_correct(root, small, cell, where, name,
                                            wrap, number):
    import importlib

    mod, cls = where.split(":")
    obj = getattr(importlib.import_module(mod), cls)
    with _wrapped(obj, name, wrap):
        out = _run(root, small, cell)
    assert out["correct"] is False and out["failed"] >= 1
    c = out["checks"][number]
    assert not c["value"] <= c["limit"], out["checks"]


def test_the_sound_runs_of_these_worlds_are_correct(root, small):
    for cell in ("mf_year_screen", "bp_lattice_day"):
        out = _run(root, small, cell)
        assert out["correct"] is True, out["checks"]
