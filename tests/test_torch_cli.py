"""The port's command line against the JAX package's, on the same files.

The world of tests/test_cli.py (5 stations x 3 components, 9 sources, 900
s at 25 Hz, two events from source 3), written with the JAX package's
writers; `seismic_bpmf_tpu.cli.main` and the port's
``main(["--device", "cpu", ...])`` run on the same files, in process.
BP: the same events (origin sample, source index); MF: every injected
event at the same sample through every template; catalog: the same rows,
`unique_event` flags and origin times within one sample; scan: the same
state keys and a resume that scans 0 days.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")
pd = pytest.importorskip("pandas")

from seismic_bpmf_tpu import cli as jcli  # noqa: E402
from seismic_bpmf_tpu.config import Config  # noqa: E402
from seismic_bpmf_tpu.data import (  # noqa: E402
    Catalog as JCatalog, Network, TravelTimes, data_reader_hdf5,
    write_hdf5_continuous,
)
from seismic_bpmf_tpu.data.stream import Stream, Trace  # noqa: E402
from seismic_bpmf_tpu_torch import cli  # noqa: E402
from seismic_bpmf_tpu_torch import data as tdata  # noqa: E402
from seismic_bpmf_tpu_torch.ops import host_ops  # noqa: E402

SR = 25.0
DAY = 900.0
N_STA = 5
N_SRC = 9
EVENT_TIMES = [200.0, 600.0]
EVENT_SRC = 3
T0 = 1343260800.0


def tmain(args):
    return cli.main(["--device", "cpu", *args])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_cli.py's world, its templates built by the JAX package
    from the JAX CLI's BP events."""
    tmp = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(11)
    cfg = Config(data_buffer_sec=0.0, sampling_rate_hz=SR,
                 template_len_sec=8.0, n_dev_bp_threshold=10.0,
                 n_dev_mf_threshold=8.0)
    cfg.to_file(str(tmp / "params.cfg"))
    md = pd.DataFrame({
        "stations": [f"S{i}" for i in range(N_STA)],
        "networks": ["XX"] * N_STA,
        "latitude": 40.0 + 0.05 * np.arange(N_STA),
        "longitude": 30.0 + 0.05 * np.arange(N_STA),
        "elevation_m": np.zeros(N_STA),
    })
    net = Network.from_dataframe(md)
    net.start_date = np.datetime64("2012-07-26")
    net.end_date = np.datetime64("2012-07-27")
    net.write(str(tmp / "network.tsv"))
    tt_p = {f"S{i}": rng.uniform(1.0, 5.0, N_SRC).astype(np.float32)
            for i in range(N_STA)}
    tt_s = {k: (v * 1.7).astype(np.float32) for k, v in tt_p.items()}
    TravelTimes.write_table(
        str(tmp / "tts.h5"), {"P": tt_p, "S": tt_s},
        {"longitude": np.linspace(30, 30.2, N_SRC),
         "latitude": np.linspace(40, 40.2, N_SRC),
         "depth": np.full(N_SRC, 8.0)},
    )
    n = int(DAY * SR)
    n_w = int(1.5 * SR)
    wavelet = (np.sin(2 * np.pi * 4.0 * np.arange(n_w) / SR)
               * np.hanning(n_w))
    st = Stream()
    for i in range(N_STA):
        sta = f"S{i}"
        for comp in "NEZ":
            x = 0.05 * rng.normal(size=n).astype(np.float32)
            for ev_t in EVENT_TIMES:
                tt = (tt_p[sta][EVENT_SRC] if comp == "Z"
                      else tt_s[sta][EVENT_SRC])
                k = int((ev_t + tt) * SR)
                x[k : k + len(wavelet)] += 4.0 * wavelet
            st += Trace(x, station=sta, network="XX", channel=f"HH{comp}",
                        sampling_rate=SR, starttime=T0)
    write_hdf5_continuous(str(tmp / "day.h5"), st)

    base = ["--config", str(tmp / "params.cfg"), "--data",
            str(tmp / "day.h5"), "--network", str(tmp / "network.tsv")]
    bp = ["backproject", *base, "--travel-times", str(tmp / "tts.h5"),
          "--min-interevent-time", "10"]
    assert jcli.main([*bp, "--output", str(tmp / "bp_jax.h5")]) == 0
    assert tmain([*bp, "--output", str(tmp / "bp_torch.h5")]) == 0

    from seismic_bpmf_tpu.workflow import build_templates

    _, events = JCatalog.read_from_detection_file(
        "bp_jax.h5", db_path=str(tmp), return_events=True,
        extra_attributes=())
    jnet = Network("network.tsv", str(tmp)).read()
    tg = build_templates(events, jnet, cfg=Config.from_file(
        str(tmp / "params.cfg")), data_reader=data_reader_hdf5,
        db_path=str(tmp / "templates"))
    assert tg.n_templates >= 1
    return tmp, base, bp


def _bp_events(tmp, fn):
    _, evs = tdata.Catalog.read_from_detection_file(
        fn, db_path=str(tmp), return_events=True, extra_attributes=())
    return sorted((round((e.origin_time_epoch - T0) * SR),
                   int(e.aux_data["source_index"])) for e in evs)


def _mf_args(tmp, base, db):
    return ["matched-filter", *base, "--templates",
            str(tmp / "templates" / "template*.h5"), "--db", str(tmp / db),
            "--min-channels", "3", "--min-stations", "2", "--max-kurto",
            "1e6"]


def _samples(db, tids):
    """{tid: sorted origin samples} of the detection files under `db`."""
    out = {}
    for tid in tids:
        fn = f"detections_tp{tid}.h5"
        if not os.path.isfile(os.path.join(db, fn)):
            out[tid] = []
            continue
        _, evs = tdata.Catalog.read_from_detection_file(
            fn, db_path=str(db), return_events=True, extra_attributes=())
        out[tid] = sorted(round((e.origin_time_epoch - T0) * SR)
                          for e in evs)
    return out


def test_backproject_matches_the_jax_cli(world):
    tmp, _, _ = world
    jev, tev = _bp_events(tmp, "bp_jax.h5"), _bp_events(tmp, "bp_torch.h5")
    assert len(jev) >= 2
    assert tev == jev
    # each event at its source, within the wavelet's envelope peak (0.75
    # s) of its origin
    for ev_t in EVENT_TIMES:
        assert any(0 <= o - ev_t * SR <= SR and s == EVENT_SRC
                   for o, s in tev), (ev_t, tev)


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_matched_filter_and_catalog_match_the_jax_cli(world, capsys,
                                                      precision):
    tmp, base, _ = world
    jdb, tdb = f"det_jax_{precision}", f"det_torch_{precision}"
    prec = ["--precision", precision]
    assert jcli.main([*_mf_args(tmp, base, jdb), *prec]) == 0
    assert tmain([*_mf_args(tmp, base, tdb), *prec]) == 0
    counts = [line.split(" detections across ")
              for line in capsys.readouterr().out.splitlines()
              if " detections across " in line]
    assert len(counts) == 2 and counts[0][0] == counts[1][0]
    assert counts[1][1].startswith(
        f"{len(list((tmp / 'templates').glob('template*.h5')))} templates")
    tids = sorted(f.name[len("template"):-3]
                  for f in (tmp / "templates").glob("template*.h5"))
    jdet, tdet = _samples(tmp / jdb, tids), _samples(tmp / tdb, tids)
    # the injected events (well separated: the JAX CLI draws its noise
    # table from numpy's global state) at the same sample for every
    # template
    for tid in tids:
        for ev_t in EVENT_TIMES:
            near = [[o for o in d[tid] if abs(o - ev_t * SR) < 5 * SR]
                    for d in (jdet, tdet)]
            assert len(near[0]) == 1 and near[1] == near[0], (tid, ev_t,
                                                               near)

    cat = ["catalog", "--network", str(tmp / "network.tsv"), "--templates",
           str(tmp / "templates" / "template*.h5")]
    assert jcli.main([*cat, "--db", str(tmp / jdb), "--output",
                      str(tmp / f"cat_jax_{precision}.csv")]) == 0
    assert tmain([*cat, "--db", str(tmp / tdb), "--output",
                  str(tmp / f"cat_torch_{precision}.csv")]) == 0
    jcat = pd.read_csv(tmp / f"cat_jax_{precision}.csv")
    tcat = tdata.Catalog.read(str(tmp / f"cat_torch_{precision}.csv"))
    assert tcat.n_events == len(jcat) >= len(EVENT_TIMES)
    np.testing.assert_array_equal(tcat["unique_event"],
                                  jcat["unique_event"].values)
    jt = pd.to_datetime(jcat["origin_time"]).values.astype(
        "datetime64[ns]").astype(np.int64) / 1e9
    np.testing.assert_allclose(tcat.origin_times_epoch, jt, rtol=0,
                               atol=1.0 / SR)
    # --unique-only keeps the unique_event rows
    assert tmain([*cat, "--db", str(tmp / tdb), "--output",
                  str(tmp / "cat_unique.csv"), "--unique-only"]) == 0
    uniq = tdata.Catalog.read(str(tmp / "cat_unique.csv"))
    assert uniq.n_events == int(tcat["unique_event"].sum())
    assert uniq["unique_event"].all()


def test_scan_state_and_resume_match_the_jax_cli(world, capsys):
    tmp, base, _ = world
    scan = ["scan", "--config", str(tmp / "params.cfg"), "--data",
            str(tmp / "day.h5"), "--network", str(tmp / "network.tsv"),
            "--templates", str(tmp / "templates" / "template*.h5"),
            "--min-channels", "3", "--min-stations", "2", "--max-kurto",
            "1e6"]
    for run, tag in ((jcli.main, "jax"), (tmain, "torch")):
        assert run([*scan, "--state", str(tmp / f"state_{tag}.json"),
                    "--db", str(tmp / f"scan_{tag}")]) == 0
    capsys.readouterr()
    jstate = json.loads((tmp / "state_jax.json").read_text())
    tstate = json.loads((tmp / "state_torch.json").read_text())
    assert list(tstate) == list(jstate) and len(tstate) == 1
    assert tstate[list(tstate)[0]]["n_detections"] >= len(EVENT_TIMES)
    assert tmain([*scan, "--state", str(tmp / "state_torch.json"),
                  "--db", str(tmp / "scan_torch")]) == 0
    out = capsys.readouterr().out
    assert "0 new detections over 0 days" in out.splitlines()[-1]


def test_picker_checkpoint_gives_backproject_days_detections(world,
                                                             tmp_path):
    tmp, _, bp = world
    from seismic_bpmf_tpu_torch import workflow
    from seismic_bpmf_tpu_torch.models import init_phasenet, save_variables

    model = init_phasenet(torch.Generator().manual_seed(3), device="cpu")
    ck = save_variables(str(tmp_path / "picker"), model)
    assert tmain([*bp, "--picker-checkpoint", ck, "--output",
                  str(tmp_path / "bp_pn.h5")]) == 0
    got = _bp_events(tmp_path, "bp_pn.h5")

    cfg = cli._load_cfg(str(tmp / "params.cfg"))
    net = cli._load_network(str(tmp / "network.tsv"))
    data = cli._make_data(str(tmp / "day.h5"), cfg)
    tts = cli._load_travel_times(str(tmp / "tts.h5"), ["P", "S"], net, cfg)
    _, dets = workflow.backproject_day(
        data, net, tts, cfg=cfg,
        feature_fn=workflow.phasenet_feature_fn(model),
        minimum_interevent_time=10.0, device="cpu")
    want = sorted((round((e.origin_time_epoch - T0) * SR),
                   int(e.aux_data["source_index"])) for e in dets)
    assert got == want


def test_info_bench_engines_and_the_device_rule(world, capsys, monkeypatch):
    tmp, _, bp = world
    assert tmain(["info"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert list(report) == ["version", "torch", "cuda", "backend",
                            "devices", "host_ops_native"]
    assert report["backend"] == "cpu" and report["devices"] == ["cpu"]
    assert report["torch"] == torch.__version__
    assert report["host_ops_native"] is host_ops.available() is True
    # the XLA engines of the JAX beamformer are refused, not re-routed
    for engine in ("onehot", "gather"):
        assert tmain([*bp, "--engine", engine]) == 2
        assert "--engine auto or pallas" in capsys.readouterr().err
    # bench runs bench_torch.py beside the package, never the JAX bench.py
    real = os.path.isfile
    monkeypatch.setattr(cli.os.path, "isfile",
                        lambda p: False if p.endswith("bench_torch.py")
                        else real(p))
    assert tmain(["bench"]) == 1
    assert "bench_torch.py not found" in capsys.readouterr().err
    monkeypatch.undo()
    # help quotes the port's rungs, no TPU figure
    helps = cli.build_parser().format_help() + "".join(
        a.format_help() for a in cli.build_parser()._subparsers
        ._group_actions[0].choices.values())
    for tpu in ("~2x", "~3x", "6-pass"):
        assert tpu not in helps
    if not torch.cuda.is_available():
        assert cli.main(["info"]) == 1
        assert "CUDA is not available" in capsys.readouterr().err


def test_bench_hands_its_flags_and_the_device_to_bench_torch(monkeypatch,
                                                             capsys):
    """`bench` loads bench_torch.py beside the package and calls its
    `main` with the top-level --device first, then every flag after
    `bench`; its return code is the command's."""
    loaded, calls = [], []
    real = cli.load_bench

    def load(path):
        module = real(path)
        loaded.append(module)
        monkeypatch.setattr(module, "main",
                            lambda argv: calls.append(argv) or len(calls) - 1)
        return module

    monkeypatch.setattr(cli, "load_bench", load)
    assert tmain(["bench", "--check"]) == 0
    assert cli.main(["bench", "--device", "cpu", "--bp", "--n-src",
                     "1000000", "--n-sta=128"]) == 1
    assert tmain(["bench", "--precision", "default", "--no-check",
                  "--extras", "x.json"]) == 2
    assert calls == [
        ["--device", "cpu", "--check"],
        ["--device", "cpu", "--bp", "--n-src", "1000000", "--n-sta=128"],
        ["--device", "cpu", "--precision", "default", "--no-check",
         "--extras", "x.json"]]
    assert os.path.basename(loaded[0].__file__) == "bench_torch.py"
    assert callable(loaded[0].check_parity)
    # the other subcommands still refuse flags they do not know
    with pytest.raises(SystemExit) as e:
        tmain(["info", "--check"])
    assert e.value.code == 2
    assert "unrecognized arguments: --check" in capsys.readouterr().err
