"""The harness finds a cell's parts by name, and a configuration, a
traffic mix, a limits file and a metric dropped into a copy of the
benchmark are found with no edit to any file that was there."""

import json
import os
import re
import shutil
import subprocess
import sys

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_resolves_to_files_of_its_own(root):
    bench = harness.load_benchmark(root)
    import importlib

    for w in bench["workloads"]:
        cell = harness.resolve(root, w["name"])
        ref = importlib.import_module(
            f"benchmark.reference.{cell.config['reference']}")
        importlib.import_module(
            f"benchmark.generators.{cell.config['generator']}")
        assert set(cell.limits) == set(ref.NAMES)
        assert cell.traffic["stage"] in ("mf", "bp")
        for m in cell.end_to_end + cell.per_layer:
            mod = harness.load_metric(m)
            assert callable(mod.read) and UNIT.match(mod.UNIT)
        assert "setup_s" in cell.end_to_end
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_benchmark_json_keeps_to_its_contract(root):
    bench = harness.load_benchmark(root)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    units = {}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        units[m["name"]] = m["unit"]
        assert harness.load_metric(m["name"]).UNIT == m["unit"]
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        assert os.path.isfile(os.path.join(root, c["file"]))
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
    assert len(json.dumps(bench)) < 64 * 1024


def _copy(root, dst):
    shutil.copy(os.path.join(root, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(root, "benchmark"), dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))


def test_new_files_and_entries_are_found_without_an_edit(root, tmp_path):
    _copy(root, tmp_path)
    b = tmp_path / "benchmark"
    before = {p: p.read_bytes() for p in b.rglob("*") if p.is_file()}
    conf = json.load(open(b / "configs" / "year_bank.json"))
    conf["name"] = "year_bank_small"
    conf["sizes"]["n_templates"] = 512
    json.dump(conf, open(b / "configs" / "year_bank_small.json", "w"))
    json.dump({"stage": "mf", "engine": {"precision": "screen"},
               "pool_days": 2, "warm_days": 1, "events_per_template": 3},
              open(b / "traffic" / "mf_screen_three.json", "w"))
    shutil.copy(b / "limits" / "mf_year_screen.json",
                b / "limits" / "mf_small_three.json")
    (b / "metrics" / "mf_days.py").write_text(
        'UNIT = "day"\n\n\ndef read(run):\n    return run.n_days\n')
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    bench["configs"].append(
        {"name": "year_bank_small", "source": "a test",
         "file": "benchmark/configs/year_bank_small.json", "reduced": [],
         "why": "a test"})
    bench["workloads"].append(
        {"name": "mf_small_three", "config": "year_bank_small",
         "traffic": "mf_screen_three", "chips": 1, "why": "a test"})
    bench["per_layer"].append(
        {"name": "mf_days", "unit": "day", "better": "higher",
         "source": "program_counter", "layer": "workflow",
         "moves": "mf_day_s", "workloads": ["mf_small_three"]})
    bench["end_to_end"][0]["workloads"].append("mf_small_three")
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    code = (
        "import json, sys; sys.path.insert(0, '.');"
        "from benchmark import harness;"
        "c = harness.resolve('.', 'mf_small_three');"
        "m = harness.load_metric('mf_days');"
        "print(json.dumps([c.config['sizes']['n_templates'],"
        " c.traffic['events_per_template'], c.end_to_end, c.per_layer,"
        " m.UNIT, harness.__file__]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, check=True)
    n_tp, k, e2e, per_layer, unit, where = json.loads(out.stdout)
    assert (n_tp, k, unit) == (512, 3, "day")
    assert where.startswith(str(tmp_path))
    assert "mf_day_s" in e2e and "setup_s" in e2e
    assert per_layer == ["mf_days"]
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_a_dropped_in_mix_hands_its_engine_keywords_to_scan_days(root,
                                                                 tmp_path):
    from conftest import SMALL

    _copy(root, tmp_path)
    b = tmp_path / "benchmark"
    json.dump({"stage": "mf", "engine": {"precision": "screen",
                                         "screen_margin": 0.02},
               "pool_days": 2, "warm_days": 1, "events_per_template": 2},
              open(b / "traffic" / "mf_screen_margin.json", "w"))
    shutil.copy(b / "limits" / "mf_year_screen.json",
                b / "limits" / "mf_margin.json")
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    bench["workloads"].append(
        {"name": "mf_margin", "config": "year_bank",
         "traffic": "mf_screen_margin", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("mf_margin")
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    code = (
        "import functools, json, sys, time; sys.path.insert(0, '.');"
        "from benchmark import harness;"
        "from seismic_bpmf_tpu_torch import workflow;"
        "seen = {}; scan = workflow.scan_days\n"
        "@functools.wraps(scan)\n"
        "def tap(dates, make_data, **kw):\n"
        "    seen.update(kw); return scan(dates, make_data, **kw)\n"
        "workflow.scan_days = tap;"
        f"out = harness.run_cell('.', 'mf_margin', 5, 0.01, False, 'cpu',"
        f" time.perf_counter(), overrides={SMALL['year_bank']!r});"
        "print(json.dumps([seen['precision'], seen['screen_margin'],"
        " out['correct']]))")
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1]) == ["screen", 0.02, True]


def _world(**scan):
    import types

    return types.SimpleNamespace(scan_args=dict(
        template_group=None, cfg=None, stage="mf", device="cpu", **scan))


def test_a_keyword_scan_days_does_not_take_is_refused():
    import pytest

    with pytest.raises(ValueError, match="takes no"):
        harness.scan_args(_world(), {"stage": "mf", "engine": {
            "precision": "high", "n_cards": 4}}, ["cpu"])
    with pytest.raises(ValueError, match="world"):
        harness.scan_args(_world(), {"stage": "mf", "engine": {
            "cfg": None}}, ["cpu"])
    with pytest.raises(ValueError, match="takes no"):
        harness.scan_args(_world(), {"stage": "bp", "engine": {
            "precision": "high", "template_chunk": 4}}, ["cpu"])


def test_a_mesh_of_axis_sizes_spans_the_cells_devices():
    import torch

    args = harness.scan_args(_world(template_chunk=4), {
        "stage": "mf", "engine": {"precision": "high", "mesh": {"tp": 2}}},
        [torch.device("cpu")] * 2)
    assert "device" not in args and args["template_chunk"] == 4
    assert args["precision"] == "high"
    assert args["mesh"].shape == {"tp": 2}
    assert [str(d) for d in args["mesh"].devices.flat] == ["cpu", "cpu"]
