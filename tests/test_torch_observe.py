"""The port's stage timer (`utils.observe.StageTimer`): nesting and self
time on a thread, the per-day records of stages and meters (a second
thread's spans filed under the day it names), the `stage:<name>` ranges
on a recording torch profiler, the spans of a small `scan_days` campaign
of each stage, and `mf_bound_ms`'s product count."""

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seismic_bpmf_tpu_torch import workflow  # noqa: E402
from seismic_bpmf_tpu_torch.config import Config  # noqa: E402
from seismic_bpmf_tpu_torch.detection import MatchedFilter  # noqa: E402
from seismic_bpmf_tpu_torch.ops.mf import MatchedFilterPlan  # noqa: E402
from seismic_bpmf_tpu_torch.tools import year_scan  # noqa: E402
from seismic_bpmf_tpu_torch.tools.bp_world import BPWorld  # noqa: E402
from seismic_bpmf_tpu_torch.tools.year_world import (  # noqa: E402
    build_bank, build_world,
)
from seismic_bpmf_tpu_torch.utils import observe  # noqa: E402
from seismic_bpmf_tpu_torch.utils.observe import (  # noqa: E402
    GLOBAL_TIMER, StageTimer,
)


def _busy(seconds):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


def test_nested_stages_keep_inclusive_times_and_self_times():
    t = StageTimer()
    with t.stage("alone") as alone:
        pass
    with t.day("d1"):
        with t.stage("outer") as outer:
            _busy(0.002)
            with t.stage("inner") as first:
                _busy(0.003)
            with t.stage("inner") as second:
                _busy(0.001)
        with t.stage("inner") as top:
            pass
    assert t.counts == {"alone": 1, "outer": 1, "inner": 3}
    assert first.parent is outer and second.parent is outer
    assert outer.parent is None and top.parent is None
    # the stages each ran inside, in a day or not
    assert t.parents == {"alone": {None}, "inner": {"outer", None},
                         "outer": {None}}
    assert t.times["outer"] == outer.seconds >= 0.006
    assert t.times["inner"] == pytest.approx(
        first.seconds + second.seconds + top.seconds)
    # the parent is inclusive of its children; its self time is the rest
    assert outer.seconds >= first.seconds + second.seconds
    assert outer.self_seconds == pytest.approx(
        outer.seconds - first.seconds - second.seconds)
    assert outer.self_seconds >= 0.002
    assert first.self_seconds == first.seconds
    assert alone.self_seconds == alone.seconds == t.times["alone"]
    assert t.day_spans == {"d1": {
        "outer": [outer.seconds, outer.self_seconds, 1],
        "inner": [pytest.approx(t.times["inner"]),
                  pytest.approx(t.times["inner"]), 3]}}
    rep = t.report()["stages"]
    assert rep["outer"] == {"seconds": round(outer.seconds, 4), "calls": 1,
                            "parents": [None]}
    assert rep["inner"]["calls"] == 3
    assert rep["inner"]["parents"] == [None, "outer"]
    assert t.day_meters == {} and set(t.report()) == {"stages", "meters"}


def test_a_stage_that_raises_is_still_timed():
    t = StageTimer()
    with pytest.raises(ValueError):
        with t.stage("outer"):
            with t.stage("inner"):
                raise ValueError("x")
    assert t.counts == {"outer": 1, "inner": 1}
    with t.stage("after") as span:
        pass
    assert span.parent is None


@pytest.mark.parametrize("first", ["set_data", "dispatch"])
def test_parents_hold_every_stage_a_name_ran_inside_in_any_order(first):
    t = StageTimer()
    paths = {"set_data": ("mf_set_data", "d1"), "dispatch": ("mf_dispatch",
                                                             "d2")}
    order = [first] + [p for p in paths if p != first]
    for path in order + order:
        outer, key = paths[path]
        with t.day(key):
            with t.stage(outer):
                with t.stage("mf_upload"):
                    pass
    assert t.parents["mf_upload"] == {"mf_set_data", "mf_dispatch"}
    assert t.report()["stages"]["mf_upload"]["parents"] == [
        "mf_dispatch", "mf_set_data"]
    for key, outer in (("d1", "mf_set_data"), ("d2", "mf_dispatch")):
        assert set(t.day_spans[key]) == {outer, "mf_upload"}
        _check_nesting(t.day_spans[key], t.parents)


def test_a_second_threads_spans_are_filed_under_the_day_it_names():
    t = StageTimer()
    fetched = threading.Event()

    def prefetch():
        with t.day("d2"):
            with t.stage("day_read"):
                _busy(0.002)
            t.add("rows", 3)
        fetched.set()

    with t.day("d1"):
        with t.stage("scan_day"):
            worker = threading.Thread(target=prefetch)
            worker.start()
            fetched.wait()
            with t.stage("work"):
                _busy(0.001)
        worker.join()
    assert set(t.day_spans) == {"d1", "d2"}
    assert set(t.day_spans["d2"]) == {"day_read"}
    assert set(t.day_spans["d1"]) == {"scan_day", "work"}
    sec, own, calls = t.day_spans["d2"]["day_read"]
    assert calls == 1 and sec == own >= 0.002
    # the other thread's span is no child of the main thread's stage
    assert t.parents["day_read"] == {None}
    assert t.parents["work"] == {"scan_day"}
    assert t.day_meters == {"d2": {"rows": 3.0}}
    assert t.meters == {"rows": 3.0}


def test_meters_are_filed_per_day_and_a_fresh_day_starts_empty():
    t = StageTimer()
    t.add("mf_detections", 2)
    for key, n in (("a", 5), ("b", 7), ("a", 1)):
        with t.day(key):
            t.add("mf_detections", n)
            with t.stage("scan_day"):
                pass
    assert t.meters["mf_detections"] == 15
    assert t.day_meters == {"a": {"mf_detections": 6.0},
                            "b": {"mf_detections": 7.0}}
    assert t.day_spans["a"]["scan_day"][2] == 2
    with t.day("a", fresh=True):
        pass
    assert "a" not in t.day_spans and "a" not in t.day_meters
    assert t.counts["scan_day"] == 3


def test_day_records_keep_the_last_days(monkeypatch):
    t = StageTimer()
    monkeypatch.setattr(StageTimer, "MAX_DAYS", 3)
    for i in range(5):
        with t.day(i):
            with t.stage("scan_day"):
                pass
            t.add("n", i)
    assert list(t.day_spans) == ["2", "3", "4"]
    assert list(t.day_meters) == ["2", "3", "4"]
    assert t.counts["scan_day"] == 5


def _annotations(prof, path):
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith("stage:")]


def test_a_recording_profiler_gets_one_range_a_stage_nested_alike(tmp_path):
    t = StageTimer()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with t.stage("outer"):
            with t.stage("inner"):
                torch.ones(8).sum()
            with t.stage("inner"):
                pass
    got = _annotations(prof, tmp_path / "on.json")
    assert sorted(e["name"] for e in got) == [
        "stage:inner", "stage:inner", "stage:outer"]
    outer = next(e for e in got if e["name"] == "stage:outer")
    for e in got:
        if e is not outer:
            assert outer["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    assert t.counts == {"outer": 1, "inner": 2}

    # a stage opened while no profiler records has no range
    with t.stage("unrecorded"):
        with torch.profiler.profile(activities=acts) as prof:
            with t.stage("recorded"):
                pass
    got = _annotations(prof, tmp_path / "late.json")
    assert [e["name"] for e in got] == ["stage:recorded"]
    assert t.counts["unrecorded"] == 1


MF_SPANS = {"scan_wait", "scan_day", "day_read", "mf_set_data",
            "mf_normalize", "mf_upload", "mf_scan", "mf_dispatch",
            "mf_detect", "mf_collect", "mf_refine", "mf_events"}
BP_SPANS = {"scan_wait", "scan_day", "day_read", "bp_features", "bp_stack",
            "bp_weights", "bp_backproject", "bp_detect", "bp_threshold",
            "bp_peaks"}


def _check_nesting(spans_of_day, parents):
    """A parent's inclusive seconds cover its children's, and its self time
    is the rest.  A child that also ran inside another stage (in this
    process, on another path) may have run inside either this day, so its
    seconds bound the self time from one side only."""
    for name, (sec, own, calls) in spans_of_day.items():
        assert calls >= 1 and 0.0 <= own <= sec + 1e-12, name
        only = sum(spans_of_day[k][0] for k, p in parents.items()
                   if p == {name} and k in spans_of_day)
        some = sum(spans_of_day[k][0] for k, p in parents.items()
                   if name in p and k in spans_of_day)
        assert sec >= only - 1e-9, name
        assert sec - some - 1e-6 <= own <= sec - only + 1e-6, name


@pytest.fixture(scope="module")
def year():
    world = build_world(n_sta=4, day_sec=600.0)
    return world, build_bank(world, 4)


def test_an_mf_campaign_files_every_span_under_each_day(year, capsys):
    world, bank = year
    dates = ["obs-mf-0", "obs-mf-1"]
    before = {k: (GLOBAL_TIMER.times[k], GLOBAL_TIMER.counts[k])
              for k in ("mf_scan", "mf_set_data", "mf_refine", "mf_events")}
    res = year_scan.campaign(world, bank, dates, precision="screen",
                             device="cpu")
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("Total time")]
    assert len(printed) == 4
    for i, key in enumerate(dates):
        day = GLOBAL_TIMER.day_spans[key]
        assert MF_SPANS <= set(day), MF_SPANS - set(day)
        assert ("mf_plan" in day) == (i == 0)
        assert day["mf_set_data"][2] == day["scan_day"][2] == 1
        _check_nesting(day, GLOBAL_TIMER.parents)
        meters = GLOBAL_TIMER.day_meters[key]
        kept = sum(len(v) for v in res[key].values())
        assert meters["mf_detections"] == kept >= 4
        assert meters["mf_candidates"] >= kept
        assert "mf_rescan" not in day
        # the printed totals are the spans' seconds
        assert printed[2 * i] == (
            f"Total time computing CCs: {day['mf_dispatch'][0]:.2f}s")
        assert printed[2 * i + 1] == (
            f"Total time finding detections: {day['mf_detect'][0]:.2f}s")
    parents = GLOBAL_TIMER.parents
    for name, parent in [
            ("scan_wait", None), ("scan_day", None), ("day_read", None),
            ("mf_set_data", None), ("mf_upload", "mf_set_data"),
            ("mf_normalize", "mf_set_data"), ("mf_dispatch", "mf_scan"),
            ("mf_detect", "mf_scan"), ("mf_collect", "mf_detect"),
            ("mf_refine", "mf_detect"), ("mf_scan", "scan_day")]:
        assert parent in parents[name], name
    # the process totals keep their inclusive meaning, a call a day
    for k, (sec, calls) in before.items():
        per_day = sum(GLOBAL_TIMER.day_spans[d][k][0] for d in dates)
        assert GLOBAL_TIMER.times[k] - sec == pytest.approx(per_day)
    assert GLOBAL_TIMER.counts["mf_scan"] - before["mf_scan"][1] == 2
    assert GLOBAL_TIMER.counts["mf_set_data"] - before["mf_set_data"][1] == 2


def test_an_overflowing_chunk_is_rescanned_inside_mf_detect(year,
                                                            monkeypatch):
    world, bank = year
    monkeypatch.setattr(MatchedFilter, "MAX_CANDIDATES", 1)
    res = year_scan.campaign(world, bank, ["obs-rescan"], precision="high",
                             device="cpu")
    day = GLOBAL_TIMER.day_spans["obs-rescan"]
    assert day["mf_rescan"][2] >= 1
    assert GLOBAL_TIMER.parents["mf_rescan"] == {"mf_detect"}
    assert "mf_candidates" not in GLOBAL_TIMER.day_meters["obs-rescan"]
    assert sum(len(v) for v in res["obs-rescan"].values()) >= 4
    _check_nesting(day, GLOBAL_TIMER.parents)


def test_a_bp_campaign_files_every_span_under_each_day():
    events = {"d1": [(3000, 17), (9000, 100)], "d2": [(5000, 50)]}
    bw = BPWorld(7, n_src=200, n_sta=5, day_sec=600.0, events=events)
    dates = ["d1", "d2"]
    res = workflow.scan_days(
        dates, bw.make_data, cfg=Config(sampling_rate_hz=25.0), stage="bp",
        network=bw.network, travel_times=bw.travel, device="cpu",
        threshold_window_sec=200.0)
    assert all(len(res[d]) >= len(events[d]) for d in dates)
    for i, key in enumerate(dates):
        day = GLOBAL_TIMER.day_spans[key]
        assert BP_SPANS <= set(day), BP_SPANS - set(day)
        assert ("bp_plan" in day) == (i == 0)
        _check_nesting(day, GLOBAL_TIMER.parents)
    parents = GLOBAL_TIMER.parents
    assert "bp_features" in parents["bp_stack"]
    assert "scan_day" in parents["bp_weights"]
    assert "bp_backproject" in parents["bp_plan"]
    assert "bp_detect" in parents["bp_threshold"]
    assert "bp_detect" in parents["bp_peaks"]


@pytest.mark.parametrize("precision", ["default", "highest", "high"])
def test_mf_bound_counts_the_functions_three_products(monkeypatch,
                                                     precision):
    rng = np.random.default_rng(3)
    n_tp, n_sta, n_comp, L, n_samp = 3, 2, 3, 40, 4000
    plan = MatchedFilterPlan(
        rng.normal(size=(n_tp, n_sta, n_comp, L)).astype(np.float32),
        rng.integers(0, 50, size=(n_tp, n_sta, n_comp)),
        np.ones((n_tp, n_sta, n_comp), np.float32) / (n_sta * n_comp),
        n_samp, precision=precision, device="cpu")
    data_pad = plan.pad_data(rng.normal(size=(n_sta, n_comp, n_samp))
                             .astype(np.float32))
    monkeypatch.setattr(observe, "HBM_BYTES_PER_S", float("inf"))
    ms, by, macs, fma_ms = observe.mf_bound_ms(plan, data_pad)
    assert macs == n_tp * n_sta * n_comp * L * plan.n_corr_unit
    peak = (observe.BF16_PEAK_FLOPS if precision == "high"
            else observe.TF32_PEAK_FLOPS)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 3 * 2.0 * macs / peak)
    assert fma_ms == pytest.approx(1e3 * 2.0 * macs
                                   / observe.F32_PEAK_FLOPS)
