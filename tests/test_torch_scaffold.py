"""The port's boundaries: it imports neither JAX nor the JAX package (nor
pandas, h5py or ml_dtypes on its main path), its entry points run on CUDA
unless asked for the CPU, and nothing is compiled at import."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "seismic_bpmf_tpu_torch"

BLOCKED = "jax jaxlib pandas h5py ml_dtypes seismic_bpmf_tpu".split()

MAIN_PATH = textwrap.dedent("""
    import importlib.abc, sys

    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"{{name}} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    from seismic_bpmf_tpu_torch import workflow
    from seismic_bpmf_tpu_torch.config import Config
    from seismic_bpmf_tpu_torch.data import Data, Stream, TemplateGroup, Trace
    from seismic_bpmf_tpu_torch.ops import mf

    SR, L, N = 25.0, 50, 12000
    rng = np.random.default_rng(0)
    wave = (rng.normal(size=(2, 4, 3, L)) * np.hanning(L) * 20).astype(
        np.float32)
    mv = rng.integers(-10, 60, size=(2, 4, 3))
    days = {{}}
    for key, o in (("d1", 3000), ("d2", 7001)):
        x = rng.standard_normal((4, 3, N), dtype=np.float32)
        for s in range(4):
            for c in range(3):
                x[s, c, o + mv[0, s, c]: o + mv[0, s, c] + L] += wave[0, s, c]
        days[key] = x
    tpl = np.stack([days["d1"][s, c, 3000 + mv[0, s, c]:][:L]
                    for s in range(4) for c in range(3)]).reshape(4, 3, L)
    tg = TemplateGroup.from_arrays(
        np.stack([tpl, wave[1]]), mv, ["0", "1"], ["A", "B", "C", "D"],
        sampling_rate=SR)

    def reader(where, starttime=None, endtime=None, **kw):
        st = Stream()
        for s, sta in enumerate("ABCD"):
            for c, comp in enumerate("NEZ"):
                st += Trace(days[where][s, c], station=sta,
                            channel="HH" + comp, sampling_rate=SR,
                            starttime=0.0)
        return st

    cfg = Config(data_buffer_sec=0.0, sampling_rate_hz=SR)
    out = workflow.scan_days(
        ["d1", "d2"],
        lambda d: Data("1970-01-01", d, reader, duration=N / SR,
                       sampling_rate=SR).read_waveforms(),
        tg, cfg=cfg, device="cpu", minimum_interevent_time=5.0,
        threshold_window_dur=120.0, min_channels=3, min_stations=2,
        max_kurto=1e6, rng=np.random.default_rng(1))
    for key, o in (("d1", 3000), ("d2", 7001)):
        hits = [e for e in out[key]["0"]
                if abs(e.origin_time_epoch - o / SR) < 0.5 / SR]
        assert hits and hits[0].aux_data["cc"] > 0.99, (key, out[key])
    assert mf.matched_filter_plain.calls > 0 and mf.mf_cc.launches == 0

    # the backprojection day scan: a 40-source line, 4 stations, two events
    from seismic_bpmf_tpu_torch.data import Network, TravelTimes
    from seismic_bpmf_tpu_torch.ops import bp

    n_src, n_bp = 40, 9000
    sta_x = np.array([0.0, 15.0, 30.0, 45.0])
    src_x = np.linspace(0.0, 45.0, n_src)
    dist = np.hypot(src_x[:, None] - sta_x[None, :], 8.0)
    tts = {{"P": {{s: dist[:, i] / 6.0 for i, s in enumerate("ABCD")}},
            "S": {{s: dist[:, i] / 3.4 for i, s in enumerate("ABCD")}}}}
    tt = TravelTimes.from_arrays(tts, {{"longitude": src_x / 111.0,
                                       "latitude": np.zeros(n_src),
                                       "depth": np.full(n_src, 8.0)}})
    tt.convert_to_samples(SR)
    net = Network.from_arrays(list("ABCD"), longitude=sta_x / 111.0,
                              latitude=np.zeros(4))
    bp_days = {{}}
    for key, (o, src) in (("d1", (3000, 11)), ("d2", (6001, 30))):
        x = 0.1 * rng.standard_normal((4, 3, n_bp), dtype=np.float32)
        for s in range(4):
            for c, ph in ((2, "P"), (0, "S"), (1, "S")):
                a = o + int(tt.travel_times_samp[ph]["ABCD"[s]][src])
                x[s, c, a - 6: a + 7] += 8.0 * np.hanning(13)  # centred
        bp_days[key] = x

    def bp_reader(where, starttime=None, endtime=None, **kw):
        st = Stream()
        for s, sta in enumerate("ABCD"):
            for c, comp in enumerate("NEZ"):
                st += Trace(bp_days[where][s, c], station=sta,
                            channel="HH" + comp, sampling_rate=SR,
                            starttime=0.0)
        return st

    out = workflow.scan_days(
        ["d1", "d2"],
        lambda d: Data("1970-01-01", d, bp_reader, duration=n_bp / SR,
                       sampling_rate=SR).read_waveforms(),
        cfg=cfg, stage="bp", network=net, travel_times=tt, device="cpu",
        num_closest_stations=4, threshold_window_sec=120.0)
    for key, (o, src) in (("d1", (3000, 11)), ("d2", (6001, 30))):
        t_ot = o / SR
        assert any(abs(e.origin_time_epoch - t_ot) < 3 / SR
                   for e in out[key]), (key, out[key])
    assert bp.beamform_plain.calls > 0 and bp.bp_beam.launches == 0

    # detections -> templates -> the `high` scan -> catalog
    def tpl_reader(where, stations=None, channels=None, starttime=None,
                   endtime=None, **kw):
        st = Stream()
        for s, sta in enumerate("ABCD"):
            for c, comp in enumerate("NEZ"):
                if ((stations is None or sta in stations)
                        and (channels is None or channels.endswith(comp))):
                    st += Trace(bp_days[where][s, c], station=sta,
                                channel="HH" + comp, sampling_rate=SR,
                                starttime=0.0)
        return st.slice(starttime, endtime)

    cfg_t = Config(data_buffer_sec=0.0, sampling_rate_hz=SR,
                   template_len_sec=2.0)
    bank = workflow.build_templates(out["d1"], net, cfg=cfg_t,
                                    data_reader=tpl_reader, device="cpu")
    assert bank.n_templates >= 1
    day = Data("1970-01-01", "d1", bp_reader, duration=n_bp / SR,
               sampling_rate=SR).read_waveforms()
    dets = workflow.matched_filter_day(
        bank, day, cfg=cfg_t, precision="high", device="cpu",
        threshold_window_dur=120.0, min_channels=3, min_stations=2,
        max_kurto=1e6, rng=np.random.default_rng(2))
    assert mf.matched_filter_split_plain.calls > 0
    assert mf.mf_cc_split.launches == 0
    cat = workflow.assemble_catalog(dets, bank, device="cpu")
    assert cat.n_events >= 1 and cat["unique_event"].any()
    assert any(abs(t - 3000 / SR) < 3 / SR for t in cat.origin_times_epoch)
    loaded = [m for m in sys.modules
              if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not loaded, loaded
    print("MAIN_PATH_OK")
""")


def test_main_path_runs_without_jax_pandas_h5py_ml_dtypes():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", MAIN_PATH.format(blocked=BLOCKED)],
        capture_output=True, text=True, cwd=str(REPO), env=env,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "MAIN_PATH_OK" in proc.stdout


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("forbidden", ["jax", "seismic_bpmf_tpu"])
def test_no_port_file_imports_jax_or_the_jax_package(forbidden):
    files = (sorted(PORT.rglob("*.py"))
             + [REPO / "chip_smoke.py", REPO / "bench_torch.py"]
             + sorted((REPO / "examples").glob("*_torch.py")))
    assert len(files) > 15
    assert PORT / "__main__.py" in files and PORT / "cli.py" in files
    assert PORT / "viz" / "plots.py" in files
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _imports(f)
           if name == forbidden or name.startswith(forbidden + ".")]
    assert not bad


def test_entry_points_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from seismic_bpmf_tpu_torch import workflow
    from seismic_bpmf_tpu_torch.data import (
        Network, TemplateGroup, TravelTimes,
    )
    from seismic_bpmf_tpu_torch.detection import Beamformer, MatchedFilter
    from seismic_bpmf_tpu_torch.ops import bp, cf, mf, thresholds
    from seismic_bpmf_tpu_torch.ops.matched_filter import (
        matched_filter as mf_plain_engine,
    )

    tp = np.ones((1, 1, 3, 8), np.float32)
    tp[..., ::2] = 2.0
    mv = np.zeros((1, 1, 3), np.int64)
    w = np.full((1, 1, 3), 1 / 3, np.float32)
    data = np.ones((1, 3, 64), np.float32)
    tg = TemplateGroup.from_arrays(tp, mv, ["0"], ["A"])
    bmv = np.array([[[0, 3]], [[1, 5]]])
    w_ph = np.ones((1, 3, 2), np.float32)
    w_src = np.ones((2, 1), np.float32)
    net = Network.from_arrays(["A"])
    tts = TravelTimes.from_arrays(
        {"P": {"A": np.array([1.0, 1.1])}, "S": {"A": np.array([2.0, 2.2])}},
        {"longitude": np.zeros(2), "latitude": np.zeros(2),
         "depth": np.ones(2)})
    calls = [
        lambda: mf.MatchedFilterPlan(tp, mv, w, 64),
        lambda: mf.matched_filter(tp, mv, w, data),
        lambda: mf.pad_day_data(data, 3, 64, 0, 64),
        lambda: MatchedFilter(tg),
        lambda: thresholds.time_dependent_threshold(np.ones(600), 100, 8.0),
        lambda: thresholds.RmsExtractionPlan(4096, 2048),
        lambda: bp.BeamformPlan(bmv, w_ph, w_src, 64),
        lambda: bp.beamform(data, bmv, w_ph, w_src),
        lambda: cf.saturated_envelopes(data),
        lambda: thresholds.bp_detection_threshold(np.ones(600), 100),
        lambda: Beamformer(network=net, phases=["P", "S"],
                           travel_times=tts),
        lambda: workflow.backproject_day(None, net, tts),
        lambda: mf.MatchedFilterPlan(tp, mv, w, 64, precision="high"),
        lambda: mf_plain_engine(tp, mv, w, data),
        lambda: TemplateGroup.from_arrays(
            np.concatenate([tp, tp]), np.concatenate([mv, mv]), ["0", "1"],
            ["A"], locations=np.zeros((2, 3))).compute_intertemplate_cc(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # asked for the CPU, the same calls run
    assert mf.matched_filter(tp, mv, w, data, device="cpu").shape == (1, 57)
    assert MatchedFilter(tg, device="cpu").device.type == "cpu"
    assert mf_plain_engine(tp, mv, w, data, network_sum=False,
                           device="cpu").shape == (1, 57, 1, 3)
    assert bp.beamform(data, bmv, w_ph, w_src, device="cpu")[0].shape == (64,)
    assert Beamformer(network=net, travel_times=tts,
                      device="cpu").device.type == "cpu"
    with pytest.raises(NotImplementedError, match="process-group mesh"):
        MatchedFilter(tg, device="cpu", mesh=object())


def test_nothing_is_compiled_at_import():
    from seismic_bpmf_tpu_torch import _build
    from seismic_bpmf_tpu_torch.ops import mf

    # in a fresh interpreter: a test run earlier in this process may have
    # loaded a library on purpose (the host scans)
    fresh = subprocess.run(
        [sys.executable, "-c", "from seismic_bpmf_tpu_torch import _build, "
         "workflow; from seismic_bpmf_tpu_torch.ops import bp, mf; "
         "print(len(_build._LIBS))"],
        capture_output=True, text=True, check=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert fresh.stdout.strip() == "0"
    assert _build.sources() == ["bp", "mf", "mf_split"]
    assert _build.builds() == [("bp", ()), ("mf", ()),
                               ("mf", mf.HIGHEST_BUILD), ("mf_split", ())]
    try:
        _build._nvcc()
    except RuntimeError:
        # no CUDA compiler: a kernel's first use raises, naming nvcc
        for name, defines in _build.builds():
            with pytest.raises(RuntimeError, match="nvcc"):
                _build.load(name, defines)


def test_host_ops_copies_match_the_jax_package():
    from seismic_bpmf_tpu.ops import host_ops as jops
    from seismic_bpmf_tpu_torch.ops import host_ops as tops

    rng = np.random.default_rng(2)
    for _ in range(5):
        cc = rng.normal(size=3000).astype(np.float32)
        thr = np.full(3000, 1.5, np.float32)
        np.testing.assert_array_equal(tops.select_cc_indexes(cc, thr, 20),
                                      jops.select_cc_indexes(cc, thr, 20))
        idx = np.flatnonzero(cc > 1.0)
        np.testing.assert_array_equal(
            tops.dedup_detection_indexes(idx, cc, 15),
            jops.dedup_detection_indexes(idx, cc, 15))


BP_ORACLES = ["beamform", "bp_detection_threshold", "kurtosis", "envelope",
              "saturated_envelopes"]


@pytest.mark.parametrize("name", BP_ORACLES)
def test_bp_oracle_copies_match_the_jax_package(name):
    """The copies in the port's ops/reference.py are the JAX package's
    functions, text and results."""
    import inspect

    from seismic_bpmf_tpu.ops import reference as jref
    from seismic_bpmf_tpu_torch.ops import reference as tref

    assert inspect.getsource(getattr(tref, name)) == inspect.getsource(
        getattr(jref, name))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 3, 900)).astype(np.float32)
    x[1, 2] = 0.0
    if name == "beamform":
        mv = rng.integers(0, 40, size=(7, 3, 2))
        w_ph = np.ones((3, 3, 2), np.float32)
        w_src = rng.uniform(0, 1, size=(7, 3)).astype(np.float32)
        w_src[:, 1] = 0.0
        for reduce in ("max", "none"):
            for oob in ("strict", "flexible"):
                np.testing.assert_array_equal(
                    tref.beamform(x, mv, w_ph, w_src, reduce, oob),
                    jref.beamform(x, mv, w_ph, w_src, reduce, oob))
    elif name == "bp_detection_threshold":
        y = np.abs(x[0, 0])
        np.testing.assert_array_equal(tref.bp_detection_threshold(y, 200),
                                      jref.bp_detection_threshold(y, 200))
    elif name == "kurtosis":
        np.testing.assert_array_equal(tref.kurtosis(x, 40),
                                      jref.kurtosis(x, 40))
    elif name == "envelope":
        np.testing.assert_array_equal(tref.envelope(x), jref.envelope(x))
    else:
        for a, b in zip(tref.saturated_envelopes(x),
                        jref.saturated_envelopes(x)):
            np.testing.assert_array_equal(a, b)


PHASENET_PATH = textwrap.dedent("""
    import importlib.abc, sys

    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"{{name}} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    import torch
    from seismic_bpmf_tpu_torch import workflow
    from seismic_bpmf_tpu_torch.config import Config
    from seismic_bpmf_tpu_torch.data import (
        Data, Network, Stream, Trace, TravelTimes, WaveformTransform,
    )
    from seismic_bpmf_tpu_torch.models import init_phasenet, make_picker
    from seismic_bpmf_tpu_torch.ops import bp
    from seismic_bpmf_tpu_torch.ops.signal import preprocess_batch

    # raw day -> preprocessing -> PhaseNet P/S probabilities -> BP -> picks
    SR, n_src, n = 25.0, 40, 9000
    rng = np.random.default_rng(0)
    sta_x = np.array([0.0, 15.0, 30.0, 45.0])
    src_x = np.linspace(0.0, 45.0, n_src)
    dist = np.hypot(src_x[:, None] - sta_x[None, :], 8.0)
    tt = TravelTimes.from_arrays(
        {{"P": {{s: dist[:, i] / 6.0 for i, s in enumerate("ABCD")}},
          "S": {{s: dist[:, i] / 3.4 for i, s in enumerate("ABCD")}}}},
        {{"longitude": src_x / 111.0, "latitude": np.zeros(n_src),
          "depth": np.full(n_src, 8.0)}})
    tt.convert_to_samples(SR)
    net = Network.from_arrays(list("ABCD"), longitude=sta_x / 111.0,
                              latitude=np.zeros(4))
    day = 0.1 * rng.standard_normal((4, 3, n), dtype=np.float32)
    for o, src in ((3000, 11), (6001, 30)):
        for s in range(4):
            for c, ph in ((2, "P"), (0, "S"), (1, "S")):
                a = o + int(tt.travel_times_samp[ph]["ABCD"[s]][src])
                day[s, c, a - 20: a + 20] += 8.0 * np.hanning(40)

    def reader(where, stations=None, channels=None, starttime=None,
               endtime=None, **kw):
        st = Stream()
        for s, sta in enumerate("ABCD"):
            for c, comp in enumerate("NEZ"):
                if ((stations is None or sta in stations)
                        and (channels is None or channels.endswith(comp))):
                    st += Trace(day[s, c], station=sta, channel="HH" + comp,
                                sampling_rate=SR, starttime=0.0)
        return st.slice(starttime, endtime)

    model = init_phasenet(torch.Generator().manual_seed(1), device="cpu")
    pn = workflow.phasenet_feature_fn(model)
    kept = {{}}

    def feature_fn(arr):
        kept["f"] = pn(preprocess_batch(arr, SR, 2.0, 12.0, device="cpu"))
        return kept["f"]

    data = Data("1970-01-01", "d1", reader, duration=n / SR,
                sampling_rate=SR).read_waveforms()
    _, dets = workflow.backproject_day(
        # random weights: a low threshold, so that the picks have events
        data, net, tt, cfg=Config(sampling_rate_hz=SR, n_dev_bp_threshold=2.0),
        device="cpu",
        feature_fn=feature_fn, num_closest_stations=4,
        threshold_window_sec=120.0)
    assert kept["f"].shape == (4, 2, n) and dets
    assert bp.beamform_plain.calls > 0 and bp.bp_beam.launches == 0
    wt = WaveformTransform(kept["f"].numpy(), list("ABCD"), ["P", "S"],
                           data.date, SR)
    probas = kept["f"].numpy()
    thr = dict(threshold_P=float(np.quantile(probas[:, 0], 0.5)),
               threshold_S=float(np.quantile(probas[:, 1], 0.5)))
    for ev in dets[:3]:
        table = ev.pick_PS_phases(20.0, waveform_transform=wt, **thr)
        assert list(table.stations) == list("ABCD")
    table = dets[0].pick_PS_phases(20.0, picker=make_picker(model),
                                   data_reader=reader, **thr)
    assert table["P_abs_picks"].dtype == np.dtype("datetime64[ns]")
    loaded = [m for m in sys.modules
              if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not loaded, loaded
    print("PHASENET_PATH_OK")
""")


def test_phasenet_path_runs_without_jax_pandas_h5py_ml_dtypes():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", PHASENET_PATH.format(blocked=BLOCKED)],
        capture_output=True, text=True, cwd=str(REPO), env=env,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PHASENET_PATH_OK" in proc.stdout


def _module_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("forbidden",
                         ["pandas", "h5py", "ml_dtypes", "matplotlib"])
def test_no_port_module_imports_pandas_h5py_at_import(forbidden):
    files = sorted(PORT.rglob("*.py"))
    assert any(f.name == "phasenet.py" for f in files)
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _module_level_imports(f)
           if name == forbidden or name.startswith(forbidden + ".")]
    assert not bad


def test_phasenet_entry_points_need_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from seismic_bpmf_tpu_torch import workflow
    from seismic_bpmf_tpu_torch.models import phasenet
    from seismic_bpmf_tpu_torch.ops import picks, signal

    x = np.random.default_rng(0).normal(size=(1, 3, 4000)).astype(np.float32)
    path = tmp_path / "pn.pt"
    torch.save(phasenet.SeisBenchPhaseNet().state_dict(), path)
    calls = [
        lambda: phasenet.init_phasenet(),
        lambda: phasenet.load_seisbench_checkpoint(str(path)),
        lambda: workflow.phasenet_feature_fn(),
        lambda: signal.preprocess_batch(x, 25.0, 2.0, 12.0),
        lambda: signal.detrend_linear(x),
        lambda: picks.normalize_batch(x),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # asked for the CPU, they run; the model's device is the path's device
    model = phasenet.init_phasenet(device="cpu")
    feats = workflow.phasenet_feature_fn(model)(x)
    assert feats.device.type == "cpu" and feats.shape == (1, 2, 4000)
    assert signal.preprocess_batch(x, 25.0, 2.0, 12.0,
                                   device="cpu").device.type == "cpu"


DENSE_PATH = textwrap.dedent("""
    import importlib.abc, sys, tempfile, os

    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"{{name}} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    import copy
    import numpy as np
    from seismic_bpmf_tpu_torch import workflow
    from seismic_bpmf_tpu_torch.location import (
        build_travel_time_tables, layered_velocity_grid, read_nlloc_outputs,
        relocate_nlloc, write_nlloc_control, write_nlloc_grids,
        write_nlloc_obs,
    )
    from seismic_bpmf_tpu_torch.ops import bp
    from seismic_bpmf_tpu_torch.ops.cf import saturated_envelopes
    from seismic_bpmf_tpu_torch.ops.picks import PickTable
    from seismic_bpmf_tpu_torch.tools.dense_world import build_world

    # the dense path at a small size: scan, relocation both ways, NLLoc
    # files, the eikonal tables
    w = build_world(n_sta=8, n_src=600, scan_sec=400.0)
    bf, dets = workflow.backproject_day(
        w.data, w.network, w.travel_times, cfg=w.cfg, device="cpu",
        num_closest_stations=8, minimum_interevent_time=20.0,
        threshold_window_sec=400.0)
    best = max(dets, key=lambda d: d.aux_data["maxbeam"])
    env = saturated_envelopes(w.data.get_np_array(w.network.stations),
                              device="cpu")[0]
    k0 = int((best.origin_time_epoch - w.data.date_epoch - 10.0) * 25.0)
    start = w.data.date_epoch + k0 / 25.0
    locs = []
    for method, n in (("temporal", 2000), ("spatial", 1500)):
        ev = copy.deepcopy(best)
        ev.relocate(bf, env[..., k0:k0 + n], routine="beam",
                    uncertainty_method=method, features_starttime=start)
        locs.append((ev.longitude, ev.latitude, ev.depth))
        assert np.isfinite(ev.hmax_unc) and np.isfinite(ev.vmax_unc)
        at = ev.arrival_times_table
        assert (at["P_tt_sec"] > 0).all(), at.columns
    assert locs[0] == locs[1], locs
    own = copy.deepcopy(best).relocate_beam(bf, duration=40.0)
    assert abs(own.origin_time_epoch - best.origin_time_epoch) < 2.0
    assert bp.beamform_plain.calls > 0 and bp.bp_beam.launches == 0

    d = tempfile.mkdtemp()
    ev.picks_table = PickTable(at.stations, {{
        f"{{p}}_abs_picks": at[f"{{p}}_abs_arrival_times"] for p in "PS"}})
    write_nlloc_obs(ev.origin_time, ev.picks_table, list(at.stations),
                    "ev.obs", path=d)
    write_nlloc_control("ev.in", "ev", "ev.obs", d, d, "bpmf")
    lons, lats = np.linspace(30.0, 30.9, 6), np.linspace(40.0, 40.9, 5)
    deps = np.linspace(0.0, 20.0, 5)
    models = layered_velocity_grid(np.array([0.0, 10.0]),
                                   np.array([5.0, 6.0]),
                                   np.array([2.9, 3.4]), deps, (6, 5))
    tts, _ = build_travel_time_tables(w.network.subset(
        list(w.network.stations[:2]), ["Z"]), lons, lats, deps, models,
        n_iters=20, device="cpu")
    write_nlloc_grids(tts, dict(origin_lon=30.0, origin_lat=40.0,
                                origin_dep=0.0, d_lon_km=15.0,
                                d_lat_km=20.0, d_dep_km=5.0,
                                shape=(6, 5, 5)), w.network, d, "bpmf")
    assert len(os.listdir(d)) == 2 + 2 * 2 * 2
    open(os.path.join(d, "ev.hyp"), "w").write(
        'NLLOC "x" "LOCATED" "y"\\n'
        "GEOGRAPHIC  OT 2012 07 26 01 00 2.125  Lat 40.3 Long 30.2 "
        "Depth 8.7\\n")
    hypo, predicted = read_nlloc_outputs("ev.hyp", d)
    assert hypo["success"] and len(predicted) == 0
    relocate_nlloc(ev, nlloc_bin=os.path.join(d, "no_NLLoc_here"))
    assert ev.aux_data["NLLoc_reloc"] is False
    loaded = [m for m in sys.modules
              if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not loaded, loaded
    print("DENSE_PATH_OK")
""")


def test_dense_path_runs_without_jax_pandas_h5py_ml_dtypes():
    """The dense-array path (BP scan, beam relocation both ways, the NLLoc
    writers and parser, the eikonal tables) imports neither JAX nor the JAX
    package, and runs with pandas and h5py blocked."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", DENSE_PATH.format(blocked=BLOCKED)],
        capture_output=True, text=True, cwd=str(REPO), env=env,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "DENSE_PATH_OK" in proc.stdout


MAGNITUDE_PATH = textwrap.dedent("""
    import importlib.abc, sys, tempfile

    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"{{name}} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    from seismic_bpmf_tpu_torch import workflow
    from seismic_bpmf_tpu_torch.data import read_inventory
    from seismic_bpmf_tpu_torch.data.mseed import read_mseed
    from seismic_bpmf_tpu_torch.ops import response
    from seismic_bpmf_tpu_torch.source import (
        approximate_moment_magnitude, compute_moment_magnitude,
        extract_windows,
    )
    from seismic_bpmf_tpu_torch.tools.magnitude_world import build_world

    # miniSEED days + StationXML -> windows with the responses removed ->
    # Mw and Mw* -> compute_magnitudes
    w = build_world(tempfile.mkdtemp(), n_sta=4, n_events=2, hours=0.1,
                    spacing_sec=150.0)
    assert len(read_inventory(w.root + "/resp/*.xml")) == 12
    assert len(read_mseed(w.files[0], w.events[0].origin_time,
                          w.events[0].origin_time + np.timedelta64(4, "s"))
               [0].data) == 401
    for ev, mw in zip(w.events, w.mw):
        win = extract_windows(ev, duration_sec=4.0, attach_response=True,
                              taper_percentage=0.0,
                              pre_filt=(0.2, 0.5, 45.0, 49.0), device="cpu")
        spec = compute_moment_magnitude(ev, w.network, windows=win,
                                        Q0=1e9, device="cpu")
        assert spec.fit_success and abs(spec.Mw - mw) < 0.25, (spec.Mw, mw)
        star = approximate_moment_magnitude(ev, w.network, windows=win,
                                            Q0=1e9)
        assert abs(star - mw) < 0.3, (star, mw)
    mws = workflow.compute_magnitudes(w.events, w.network, device="cpu")
    assert len(mws) == 2 and all(m is not None for m in mws), mws
    assert response.apply_spectral_filter.launches == 0
    loaded = [m for m in sys.modules
              if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not loaded, loaded
    print("MAGNITUDE_PATH_OK")
""")


def test_magnitude_path_runs_without_jax_pandas_h5py_ml_dtypes():
    """miniSEED and StationXML in, moment magnitudes out, with JAX, the
    JAX package, pandas, h5py and ml_dtypes blocked."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", MAGNITUDE_PATH.format(blocked=BLOCKED)],
        capture_output=True, text=True, cwd=str(REPO), env=env,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "MAGNITUDE_PATH_OK" in proc.stdout


def test_magnitude_entry_points_need_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from seismic_bpmf_tpu_torch import workflow
    from seismic_bpmf_tpu_torch.ops import response
    from seismic_bpmf_tpu_torch.source import (
        Spectrum, approximate_moment_magnitude, compute_moment_magnitude,
        extract_windows,
    )
    from seismic_bpmf_tpu_torch.tools.magnitude_world import build_world

    w = build_world(str(tmp_path), n_sta=3, n_events=1, hours=0.05,
                    spacing_sec=60.0)
    ev = w.events[0]
    win = {p: np.ones((3, 3, 100), np.float32) for p in ("noise", "p", "s")}
    resp = [_stationxml_response(w.root)] * 2
    calls = [
        lambda: response.apply_spectral_filter(np.ones((1, 8)),
                                               np.ones((1, 9)), 16),
        lambda: response.remove_response_arr(np.ones((2, 64)), resp, 100.0),
        lambda: Spectrum().compute_spectrum(win, ["A", "B", "C"], 100.0),
        lambda: extract_windows(ev, duration_sec=4.0, attach_response=True),
        lambda: compute_moment_magnitude(ev, w.network, windows=win),
        lambda: approximate_moment_magnitude(ev, w.network),
        lambda: workflow.compute_magnitudes([ev], w.network),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # asked for the CPU, they run
    assert response.remove_response_arr(np.ones((2, 64)), resp, 100.0,
                                        device="cpu").shape == (2, 64)
    assert workflow.compute_magnitudes([ev], w.network, device="cpu")[0] \
        is not None


def _stationxml_response(root):
    from seismic_bpmf_tpu_torch.data import read_inventory

    return read_inventory(os.path.join(root, "resp", "*.xml")).responses[0]


TRAINING_PATH = textwrap.dedent("""
    import importlib.abc, os, sys, tempfile

    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"{{name}} is blocked")
            return None

    # torch.optim imports torch._dynamo, which probes optional packages
    # with importlib.util.find_spec (None where they are absent): let it
    # probe before the blocker raises on them
    import torch._dynamo  # noqa: F401
    sys.meta_path.insert(0, Block())
    import io, contextlib
    import numpy as np
    import torch

    torch.set_num_threads(1)  # the suite's workers share the cores
    from seismic_bpmf_tpu_torch.models import (
        PhaseNet, load_train_state, load_variables, make_train_step,
        save_train_state, save_variables, train_phasenet,
        windows_from_events,
    )
    from seismic_bpmf_tpu_torch.tools import month_workflow

    # training, checkpoints
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 3, 256)).astype(np.float32)
    picks = np.stack([rng.uniform(20, 100, 16), rng.uniform(120, 220, 16)],
                     axis=1).astype(np.float32)
    model, sd, losses = train_phasenet(
        x, picks, n_epochs=2, batch_size=8,
        model=PhaseNet(depth=3, filters_root=4), verbose=False,
        device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
    tmp = tempfile.mkdtemp()
    load_variables(save_variables(os.path.join(tmp, "v"), model),
                   target=PhaseNet(depth=3, filters_root=4))
    opt = torch.optim.Adam(model.parameters())
    save_train_state(os.path.join(tmp, "s"), model, opt, step=3)
    assert load_train_state(os.path.join(tmp, "s"))[2] == 3
    assert windows_from_events([])[0].shape == (0, 3, 3001)
    # the month tool at a cut (its picker trained on 32 of the script's
    # windows), then its resume (day 0 made again)
    train_picker = month_workflow.train_picker
    month_workflow.train_picker = lambda world, device=None: train_picker(
        world, device, n_train=32)
    argv = ["--days", "2", "--n-src", "200", "--day-sec", "600", "--cpu",
            "--workdir", os.path.join(tmp, "month")]
    for run in range(2):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert month_workflow.main(argv) == 0
        text = out.getvalue()
        assert "CATALOG:" in text, text
        assert ("backproject_day runs it again" in text) == (run == 1), text
    assert "BP CAMPAIGN: 0 days" in text and "MF CAMPAIGN: 0 days" in text
    loaded = [m for m in sys.modules
              if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not loaded, loaded
    print("TRAINING_PATH_OK")
""")


def test_training_and_month_path_run_without_jax_pandas_h5py_ml_dtypes():
    """PhaseNet training, its checkpoints and the month tool (a 2-day cut
    on the CPU with a picker trained on 32 windows, run twice: the second
    resumes from its state files) import neither JAX nor the JAX package,
    and run with pandas and h5py blocked."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", TRAINING_PATH.format(blocked=BLOCKED)],
        capture_output=True, text=True, cwd=str(REPO), env=env,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "TRAINING_PATH_OK" in proc.stdout


def test_training_entry_points_need_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from seismic_bpmf_tpu_torch.models import train_phasenet
    from seismic_bpmf_tpu_torch.tools import month_workflow
    from seismic_bpmf_tpu_torch.tools.month_world import build_world

    x = np.zeros((8, 3, 256), np.float32)
    picks = np.full((8, 2), 100.0, np.float32)
    world = build_world(str(tmp_path), n_sta=3, n_src=50, day_sec=300.0)
    calls = [
        lambda: train_phasenet(x, picks, n_epochs=1, batch_size=8),
        lambda: month_workflow.train_picker(world, n_train=8),
        lambda: month_workflow.bp_day(world, "day00", None),
        lambda: month_workflow.main(["--days", "1", "--n-src", "50",
                                     "--day-sec", "300"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


YEAR_PATH = textwrap.dedent("""
    import importlib.abc, contextlib, io, os, sys, tempfile

    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"{{name}} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    import torch

    torch.set_num_threads(1)  # the suite's workers share the cores
    from seismic_bpmf_tpu_torch.data import EventGroup
    from seismic_bpmf_tpu_torch.models import PhaseNet, make_picker
    from seismic_bpmf_tpu_torch.tools import year_scan
    from seismic_bpmf_tpu_torch.tools.year_world import (
        build_bank, build_world,
    )

    # the year tool at a cut, run twice (the second resumes and runs the
    # third day only), then with churn
    tmp = tempfile.mkdtemp()
    argv = ["--templates", "3", "--day-sec", "900", "--cpu",
            "--workdir", tmp]
    for days, n_run in ((2, 2), (3, 1)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert year_scan.main(argv + ["--days", str(days)]) == 0
        text = out.getvalue()
        assert f"YEAR SCAN: {{n_run}} days" in text, text
        assert "GSamples/s" in text and "mf_set_data" in text, text
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert year_scan.main(argv + ["--days", "1", "--churn", "2",
                                      "--state",
                                      os.path.join(tmp, "churn.json")]) == 0
    assert "YEAR SCAN: 1 days" in out.getvalue()
    # the family path on the year world's detections of one template
    w = build_world(day_sec=900.0)
    bank = build_bank(w, 2)
    dets = year_scan.campaign(w, bank, ["day000", "day001"], device="cpu")
    members = [ev for day in dets.values() for ev in day["0"]]
    assert len(members) == 4, len(members)
    group = EventGroup(members, w.network)
    group.read_waveforms(8.0, offset_phase={{"P": 1.0, "S": 2.0}})
    group.get_waveforms_arr()
    group.normalize("rms")
    stack = group.SVDWF_stack(2.0, 10.0, 25.0, device="cpu")
    stack.read_waveforms(8.0)
    for ev in members:
        del ev.traces
    model = PhaseNet(depth=3, filters_root=4).eval()
    picks = stack.pick_PS_phases_family_mode(
        40.0, make_picker(model), threshold_P=0.0, threshold_S=0.0,
        offset_ot=10.0, picker_sampling_rate=25.0)
    assert np.isfinite(picks["P_picks"]).all()
    loaded = [m for m in sys.modules
              if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not loaded, loaded
    print("YEAR_PATH_OK")
""")


def test_year_and_family_path_run_without_jax_pandas_h5py_ml_dtypes():
    """The year tool (`tools/year_world.py`, `tools/year_scan.py`: a cut,
    a resume and the churn mode) and the family path (EventGroup -> SVDWF
    stack -> Stack -> family picks) import neither JAX nor the JAX package,
    and run with pandas and h5py blocked."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", YEAR_PATH.format(blocked=BLOCKED)],
        capture_output=True, text=True, cwd=str(REPO), env=env,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "YEAR_PATH_OK" in proc.stdout


def test_year_and_family_entry_points_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from seismic_bpmf_tpu_torch.data import EventGroup
    from seismic_bpmf_tpu_torch.tools import year_scan
    from seismic_bpmf_tpu_torch.tools.year_world import (
        build_bank, build_world,
    )
    from seismic_bpmf_tpu_torch.utils import stacking

    w = build_world(n_sta=3, day_sec=300.0)
    bank = build_bank(w, 2)
    panels = np.random.default_rng(0).normal(size=(2, 3, 50))
    wf = np.random.default_rng(1).normal(size=(3, 2, 3, 50))
    group = EventGroup([], w.network)
    group.waveforms_arr = wf
    calls = [
        lambda: stacking.svdwf(panels[0]),
        lambda: stacking.svdwf_panels(panels),
        lambda: stacking.stack_panels(wf),
        lambda: stacking.svdwf_multiplets(bank.templates[0],
                                          detection_waveforms=wf),
        lambda: group.SVDWF_stack(2.0, 10.0, 25.0),
        lambda: year_scan.campaign(w, bank, ["day000"]),
        lambda: year_scan.main(["--days", "1", "--templates", "2",
                                "--day-sec", "300"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # asked for the CPU, they run
    assert stacking.svdwf(panels[0], device="cpu").shape == (50,)
    assert stacking.stack_panels(wf, device="cpu").shape == (2, 3, 50)


CLI_PATH = textwrap.dedent("""
    import importlib.abc, io, json, runpy, sys
    from contextlib import redirect_stdout

    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"{{name}} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    import argparse
    import numpy as np
    import torch
    from seismic_bpmf_tpu_torch import cli, viz
    from seismic_bpmf_tpu_torch.data import TemplateGroup

    out = io.StringIO()
    with redirect_stdout(out):
        assert cli.main(["--device", "cpu", "info"]) == 0
    assert json.loads(out.getvalue())["backend"] == "cpu"
    sys.argv = ["seismic_bpmf_tpu_torch", "--help"]
    try:
        with redirect_stdout(io.StringIO()):
            runpy.run_module("seismic_bpmf_tpu_torch", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
    if not torch.cuda.is_available():
        assert cli.main(["info"]) == 1
    # a runner on in-memory objects: no file, no h5py
    rng = np.random.default_rng(0)
    tg = TemplateGroup.from_arrays(
        rng.normal(size=(2, 3, 3, 40)).astype(np.float32),
        rng.integers(0, 20, size=(2, 3, 3)), ["0", "1"], ["A", "B", "C"],
        locations=np.zeros((2, 3)))
    args = cli.build_parser().parse_args(
        ["--device", "cpu", "catalog", "--network", "-", "--templates", "-",
         "--db", "-", "--output", {csv!r}])
    with redirect_stdout(io.StringIO()):
        assert cli.run_catalog(args, tg, {{}}) == 0
    # the plots need matplotlib, imported on use
    try:
        viz.plot_detection_matrix(np.zeros((2, 10)), ["A", "B"], 25.0)
    except ImportError as e:
        assert "matplotlib" in str(e)
    else:
        raise AssertionError("a plot ran without matplotlib")
    loaded = [m for m in sys.modules
              if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not loaded, loaded
    print("CLI_PATH_OK")
""")


def test_cli_and_viz_run_without_jax_pandas_h5py_matplotlib(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    script = CLI_PATH.format(blocked=BLOCKED + ["matplotlib"],
                             csv=str(tmp_path / "catalog.csv"))
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, cwd=str(REPO),
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CLI_PATH_OK" in proc.stdout
    assert (tmp_path / "catalog.csv").read_text().startswith("longitude")


# where each name of `seismic_bpmf_tpu.ops.__all__` that has a counterpart
# lives in the port (None: the name is a module of `ops`)
OPS_HOME = {
    "reference": None, "beamform": "bp", "fold_components": "beamform",
    "bandpass_zerophase": "signal", "preprocess_batch": "signal",
    "resample_fourier": "signal", "envelope": "cf", "kurtosis": "cf",
    "saturated_envelopes": "cf", "scalar_kurtosis": "cf",
    "matched_filter": "matched_filter",
    "time_dependent_threshold": "thresholds",
    "bp_detection_threshold": "thresholds",
    "time_dependent_threshold_pd": "thresholds",
    "cosine_sac_taper": "response", "remove_response_arr": "response",
    "remove_response_stream": "response",
}
PALLAS_NAMES = {"PallasMatchedFilterPlan", "matched_filter_pallas",
                "PallasBeamformPlan", "beamform_pallas"}


@pytest.mark.parametrize("name", sorted(OPS_HOME))
def test_ops_exports_are_their_modules_own_objects(name):
    import importlib

    import seismic_bpmf_tpu_torch.ops as tops

    home = OPS_HOME[name]
    module = importlib.import_module(
        f"seismic_bpmf_tpu_torch.ops.{home or name}")
    assert name in tops.__all__
    assert getattr(tops, name) is (module if home is None
                                   else getattr(module, name))


def test_package_and_ops_export_the_jax_packages_names():
    import seismic_bpmf_tpu as jpkg
    import seismic_bpmf_tpu.ops as jops

    import seismic_bpmf_tpu_torch as tpkg
    import seismic_bpmf_tpu_torch.config as tconfig
    import seismic_bpmf_tpu_torch.ops as tops

    assert tpkg.__all__ == jpkg.__all__
    assert tpkg.Config is tconfig.Config
    assert tpkg.DEFAULT_CONFIG is tconfig.DEFAULT_CONFIG
    assert set(jops.__all__) - set(tops.__all__) == PALLAS_NAMES
    assert set(tops.__all__) == set(OPS_HOME)


README_IMPORTS = textwrap.dedent("""
    import importlib.abc, sys

    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"{{name}} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    from seismic_bpmf_tpu_torch import Config, DEFAULT_CONFIG
    from seismic_bpmf_tpu_torch.data import (Network, Data, TravelTimes,
                                             Template, TemplateGroup, Catalog,
                                             data_reader_hdf5)
    from seismic_bpmf_tpu_torch.detection import Beamformer, MatchedFilter
    from seismic_bpmf_tpu_torch.ops import (saturated_envelopes, beamform,
                                            matched_filter)
    from seismic_bpmf_tpu_torch.ops import *
    assert Config().sampling_rate_hz == DEFAULT_CONFIG.sampling_rate_hz
    print("README_IMPORTS_OK")
""")


def test_readme_pipeline_imports_without_pandas_h5py_matplotlib():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    blocked = BLOCKED + ["matplotlib"]
    proc = subprocess.run(
        [sys.executable, "-c", README_IMPORTS.format(blocked=blocked)],
        capture_output=True, text=True, cwd=str(REPO), env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "README_IMPORTS_OK" in proc.stdout
