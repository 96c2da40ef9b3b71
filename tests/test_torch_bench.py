"""bench_torch.py, the port's benchmark program, against bench.py on the CPU.

The same parity inputs and float64 oracles (the port's `ops.reference`
against the JAX package's), the same MF days and BP configuration from
the same seeds (bench.py loaded from its path, its plan classes replaced
by recorders that stop the run), bench.py's JSON keys and metric names at
tiny shapes on the plain versions, exit code 1 on every failure, and the
extras file where it is asked, the repository's BENCH_EXTRAS.json
untouched.
"""

import ast
import functools
import hashlib
import importlib.util
import json
import pathlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seismic_bpmf_tpu.ops import pallas_mf as jpallas_mf  # noqa: E402
from seismic_bpmf_tpu.ops import reference as jref  # noqa: E402
from seismic_bpmf_tpu.ops import thresholds as jthresholds  # noqa: E402
from seismic_bpmf_tpu_torch.ops import bp, mf  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
KEYS = ["metric", "value", "unit", "vs_baseline"]
# tiny shapes of the plain versions (the extraction window clamps to the
# day; the pipelined extras run 19 days)
TINY_MF = dict(n_tp=1, n_samp=5_000)
TINY_BP = dict(n_src=60, n_sta=4, n_samp=5_000, budget_s=0.5)
TINY_PN = dict(n_sta=2, n_samp=20_000)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions at these small shapes run many small torch ops:
    one intra-op thread each, so that they do not spin against the other
    test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def bench_py():
    return _load("bench_jax", REPO / "bench.py")


@pytest.fixture
def bt():
    return _load("bench_torch", REPO / "bench_torch.py")


@pytest.fixture(scope="module")
def parity():
    """bench.py's rng-7 inputs and the oracles of both packages'
    `ops.reference`, in threads (numpy releases the GIL), the MF oracle in
    four template slices."""
    bt = _load("bench_torch", REPO / "bench_torch.py")
    x = bt.parity_inputs()
    slices = [slice(i, i + 4) for i in range(0, len(x["tp"]), 4)]
    refs = (bt.port_reference, jref)
    with ThreadPoolExecutor(4) as ex:
        mf_parts = [ex.submit(bt.mf_oracle, x["tp"][s], x["mv"][s],
                              x["w"][s], x["data"], r)
                    for r in refs for s in slices]
        bp_parts = [ex.submit(bt.bp_oracles, x, r) for r in refs]
        out = []
        for i, r in enumerate(refs):
            mf_i = mf_parts[i * len(slices): (i + 1) * len(slices)]
            out.append({"mf": np.concatenate([f.result() for f in mf_i]),
                        **bp_parts[i].result()})
    return x, out[0], out[1]


def _small_parity(monkeypatch, bt):
    """bench_torch's parity gate on a cut of bench.py's inputs (2
    templates, 3,000 samples; the beam on 2,048), oracles and all."""
    real = bt.parity_inputs

    def small():
        x = real()
        return {**x, "tp": x["tp"][:2], "mv": x["mv"][:2], "w": x["w"][:2],
                "data": x["data"][..., :3_000],
                "feat": x["feat"][..., :2_048]}

    monkeypatch.setattr(bt, "parity_inputs", small)


def _tiny(monkeypatch, bt):
    """Every bench function of `bt` at the tiny shapes."""
    bp_real = bt.bench_bp
    pn_real = bt.bench_phasenet
    for name in ("bench_mf", "bench_mf_extraction", "bench_mf_screen"):
        monkeypatch.setattr(bt, name,
                            functools.partial(getattr(bt, name), **TINY_MF))
    monkeypatch.setattr(bt, "bench_bp",
                        lambda **kw: bp_real(**{**kw, **TINY_BP}))
    monkeypatch.setattr(bt, "bench_phasenet",
                        lambda **kw: pn_real(**{**kw, **TINY_PN}))


def _last_json(out: str) -> dict:
    lines = out.strip().splitlines()
    result = json.loads(lines[-1])
    assert list(result) == KEYS
    return result


# ---------------------------------------------------------------------------
# (a) parity inputs and oracles
# ---------------------------------------------------------------------------

def test_parity_oracles_equal_the_jax_packages_and_the_gate_passes(
        parity, bt, monkeypatch, capsys):
    x, port, jax_ = parity
    assert set(port) == set(jax_) == {"mf", "bp_max", "bp_none",
                                      "bp_sparse"}
    for key in port:
        parts = (port[key], jax_[key])
        if not isinstance(port[key], tuple):       # (max, argmax) or one
            parts = ((port[key],), (jax_[key],))
        for a, b in zip(*parts):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64),
                                       rtol=0, atol=1e-12)
    # bench.py's own oracle, `reference.matched_filter`'s per-lag loop, on
    # 4 templates and a cut of the day: the lags whose windows all lie in
    # the cut give the bench's every-lag `matched_filter_at` oracle
    cut = jref.matched_filter(x["tp"][:4], x["mv"][:4], x["w"][:4],
                              x["data"][..., :1850])
    np.testing.assert_allclose(cut[:, :1500], port["mf"][:4, :1500],
                               rtol=0, atol=1e-7)
    # the inputs are bench.py's: its draws from default_rng(7), in order
    rng = np.random.default_rng(7)
    np.testing.assert_array_equal(
        x["data"], rng.normal(size=(5, 3, 20_000)).astype(np.float32))
    np.testing.assert_array_equal(
        x["tp"], rng.normal(size=(16, 5, 3, 100)).astype(np.float32))
    # the gate itself, every rung on the plain versions, on a cut of them
    _small_parity(monkeypatch, bt)
    assert bt.main(["--device", "cpu", "--check"]) == 0
    out = capsys.readouterr()
    result = _last_json(out.out)
    assert result["metric"] == "tpu_kernel_parity" and result["value"] == 1
    rungs = [line for line in out.err.splitlines()
             if line.startswith("# parity")]
    assert [r.split(":")[0] for r in rungs] == [
        "# parity MF[highest]", "# parity MF[high]", "# parity MF[default]",
        "# parity BP[highest]", "# parity BP[high]",
        "# parity BP[high,sparse]"]
    assert all(r.endswith(" OK") for r in rungs)


# ---------------------------------------------------------------------------
# (b) the MF days, bit for bit
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


def _recorders(seen: dict):
    """A plan class that records its bank and padded day and stops at its
    first call, and an extraction-plan class that records its arguments
    and stops; for either package's signatures."""

    class Plan:
        def __init__(self, tp, mv, w, n_samp, precision=None, **kw):
            seen.update(tp=tp, mv=mv, w=w, n_samp=n_samp,
                        precision=precision)
            self.n_corr_unit = n_samp - tp.shape[-1] + 1

        def pad_data(self, data):
            seen["data"] = data

        def __call__(self, data_pad):
            raise _Stop

    class Extraction:
        def __init__(self, n, swin, overlap=None, white_noise=None, k=None,
                     **kw):
            seen.update(n=n, swin=swin, overlap=overlap, wn=white_noise, k=k)
            raise _Stop

    return Plan, Extraction


@pytest.mark.parametrize("kind", ["headline", "extraction", "screen"])
def test_mf_days_equal_bench_py_bit_for_bit(kind, bench_py, bt, monkeypatch):
    jax_seen, port_seen = {}, {}
    plan, extraction = _recorders(jax_seen)
    monkeypatch.setattr(jpallas_mf, "PallasMatchedFilterPlan", plan)
    monkeypatch.setattr(jthresholds, "RmsExtractionPlan", extraction)
    plan, extraction = _recorders(port_seen)
    monkeypatch.setattr(mf, "MatchedFilterPlan", plan)
    monkeypatch.setattr(bt, "RmsExtractionPlan", extraction)
    jax_fn, port_fn = {
        "headline": (bench_py.bench_mf, bt.bench_mf),
        "extraction": (bench_py.bench_mf_extraction, bt.bench_mf_extraction),
        "screen": (bench_py.bench_mf_screen, bt.bench_mf_screen),
    }[kind]
    for fn, kw in ((jax_fn, {}), (port_fn, {"device": "cpu"})):
        with pytest.raises(_Stop):
            fn(**kw)
    assert set(jax_seen) == set(port_seen)
    for key, a in jax_seen.items():
        b = port_seen[key]
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert np.array_equal(a, b), key
        else:
            assert a == b, key
    assert jax_seen["data"].shape == (10, 3, 2_160_000)
    assert jax_seen["precision"] == {"screen": "default"}.get(kind, "high")
    if kind != "headline":
        assert jax_seen["swin"] == 45_000 and jax_seen["k"] == 1024


def test_bench_py_imports_no_jax_at_module_scope():
    tree = ast.parse((REPO / "bench.py").read_text())
    top = [a.name for node in tree.body if isinstance(node, ast.Import)
           for a in node.names]
    top += [node.module for node in tree.body
            if isinstance(node, ast.ImportFrom)]
    assert top and not any(m.split(".")[0] in ("jax", "seismic_bpmf_tpu")
                           for m in top)


# ---------------------------------------------------------------------------
# (c) the BP configuration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_src,n_sta", [(3_000, 32), (1_500, 128)])
def test_bp_inputs_equal_bench_py(n_src, n_sta, bench_py, bt):
    mv_ref = bench_py.smooth_grid_moveouts(n_src, n_sta)
    # bench.py's bench_bp: P on Z, S on N/E, closest-10 source weights,
    # then the features from default_rng(0)
    w_ph_ref = np.zeros((n_sta, 3, 2), np.float32)
    w_ph_ref[:, 2, 0] = 1.0
    w_ph_ref[:, :2, 1] = 0.5
    closest = np.argsort(mv_ref[:, :, 0], axis=1)[:, :10]
    w_src_ref = np.zeros((n_src, n_sta), np.float32)
    np.put_along_axis(w_src_ref, closest, 1.0 / 10.0, axis=1)
    feat_ref = np.random.default_rng(0).uniform(
        0, 1, size=(n_sta, 3, 5_000)).astype(np.float32)
    mv, w_ph, w_src, feat = bt.bp_inputs(n_src, n_sta, n_samp=5_000)
    for a, b in ((mv_ref, mv), (w_ph_ref, w_ph), (w_src_ref, w_src),
                 (feat_ref, feat)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# (d) the output contract
# ---------------------------------------------------------------------------

def test_every_mode_prints_bench_py_keys_last(bt, monkeypatch, capsys,
                                              tmp_path):
    _tiny(monkeypatch, bt)
    extras = tmp_path / "extras.json"
    assert bt.main(["--device", "cpu", "--no-check",
                    "--extras", str(extras)]) == 0
    out = capsys.readouterr()
    head = _last_json(out.out)
    assert head["metric"] == "matched_filter_throughput"
    assert head["value"] > 0 and "cpu" in head["unit"]
    assert "high: kernel #2" in head["unit"]
    got = json.loads(extras.read_text())
    assert list(got) == ["mf_extraction", "mf_screen", "beamform",
                         "phasenet"]
    assert [r["metric"] for r in got.values()] == [
        "matched_filter_with_extraction",
        "matched_filter_detection_parity_throughput",
        "beamform_throughput", "phasenet_day_inference"]
    for r in got.values():
        assert list(r) == KEYS and r["value"] > 0
        assert f"# {r['metric']}: " in out.err
    assert "candidates/day" in got["mf_screen"]["unit"]
    assert "screen: kernel #1 csrc/mf.cu default build" in got[
        "mf_screen"]["unit"]
    assert "time tiles" in got["beamform"]["unit"]
    for argv, metric in (
            (["--bp", "--n-src", "60", "--n-sta", "4", "--budget-s", "0.5"],
             "beamform_throughput"),
            (["--phasenet"], "phasenet_day_inference")):
        assert bt.main(["--device", "cpu", *argv]) == 0
        result = _last_json(capsys.readouterr().out)
        assert result["metric"] == metric and result["value"] > 0


# ---------------------------------------------------------------------------
# (e) every failure exits 1
# ---------------------------------------------------------------------------

def test_a_wrong_or_crashing_plain_version_fails_the_check(
        bt, monkeypatch, capsys):
    _small_parity(monkeypatch, bt)
    real = mf.matched_filter_split_plain

    def corrupted(*a, **k):
        return real(*a, **k) + 1e-3

    corrupted.calls = 0      # the plain version counts its calls
    monkeypatch.setattr(mf, "matched_filter_split_plain", corrupted)

    def crash(*a, **k):
        raise RuntimeError("plain beam broke")

    monkeypatch.setattr(bp, "beamform_plain", crash)
    assert bt.main(["--device", "cpu", "--check"]) == 1
    out = capsys.readouterr()
    result = _last_json(out.out)
    assert result["metric"] == "tpu_kernel_parity" and result["value"] == 0
    assert "# parity MF[high]: max|diff|=1.00e-03 FAIL" in out.err
    assert "# parity MF[highest]: " in out.err and "MF[default]" in out.err
    assert out.err.count("CRASH RuntimeError: plain beam broke FAIL") == 3
    # the default run's gate: the headline prints value 0 and exits 1
    assert bt.main(["--device", "cpu"]) == 1
    result = _last_json(capsys.readouterr().out)
    assert result["value"] == 0.0 and "PARITY GATE FAILED" in result["unit"]


def test_a_crashing_extra_or_headline_exits_1(bt, monkeypatch, capsys,
                                              tmp_path):
    _tiny(monkeypatch, bt)
    ok = {"metric": "m", "value": 1.0, "unit": "u", "vs_baseline": 1.0}

    def boom(**kw):
        raise RuntimeError("extra broke")

    monkeypatch.setattr(bt, "bench_mf_extraction", boom)
    for name in ("bench_mf_screen", "bench_bp", "bench_phasenet"):
        monkeypatch.setattr(bt, name, lambda **kw: ok)
    extras = tmp_path / "x.json"
    assert bt.main(["--device", "cpu", "--no-check",
                    "--extras", str(extras)]) == 1
    out = capsys.readouterr()
    head = _last_json(out.out)
    assert head["metric"] == "matched_filter_throughput" and head["value"] > 0
    assert "# mf_extraction extra failed: RuntimeError: extra broke" in out.err
    assert list(json.loads(extras.read_text())) == ["mf_screen", "beamform",
                                                    "phasenet"]
    # an extras file that cannot be written fails the run too
    assert bt.main(["--device", "cpu", "--no-check", "--extras",
                    str(tmp_path / "no" / "such" / "dir.json")]) == 1
    capsys.readouterr()
    for name, argv, metric in (
            ("bench_mf", [], "matched_filter_throughput"),
            ("bench_bp", ["--bp"], "beamform_throughput"),
            ("bench_phasenet", ["--phasenet"], "phasenet_day_inference")):
        monkeypatch.setattr(bt, name, boom)
        assert bt.main(["--device", "cpu", "--no-check", *argv]) == 1
        result = _last_json(capsys.readouterr().out)
        assert result["metric"] == metric and result["value"] == 0.0
        assert "extra broke" in result["unit"]


def test_without_a_card_the_bench_prints_zero_and_exits_1(bt, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    for argv, metric in (([], "matched_filter_throughput"),
                         (["--check"], "tpu_kernel_parity"),
                         (["--bp"], "beamform_throughput"),
                         (["--phasenet"], "phasenet_day_inference")):
        assert bt.main(argv) == 1
        result = _last_json(capsys.readouterr().out)
        assert result["metric"] == metric and result["value"] == 0.0
        assert "CUDA is not available" in result["unit"]


# ---------------------------------------------------------------------------
# (f) files left alone
# ---------------------------------------------------------------------------

def test_the_extras_go_where_asked_and_bench_extras_stays(
        bt, monkeypatch, capsys, tmp_path):
    def digest():
        return hashlib.sha256(
            (REPO / "BENCH_EXTRAS.json").read_bytes()).hexdigest()

    before = digest()
    ok = {"metric": "m", "value": 1.0, "unit": "u", "vs_baseline": 1.0}
    for name in ("bench_mf", "bench_mf_extraction", "bench_mf_screen",
                 "bench_bp", "bench_phasenet"):
        monkeypatch.setattr(bt, name, lambda **kw: ok)
    monkeypatch.chdir(tmp_path)
    assert bt.main(["--device", "cpu", "--no-check"]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "BENCH_TORCH_EXTRAS.json"]
    asked = tmp_path / "sub" / "asked.json"
    asked.parent.mkdir()
    assert bt.main(["--device", "cpu", "--no-check",
                    "--extras", str(asked)]) == 0
    assert len(json.loads(asked.read_text())) == 4
    capsys.readouterr()
    assert digest() == before
