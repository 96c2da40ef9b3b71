"""The port's sharded scans (`seismic_bpmf_tpu_torch.parallel`) on a
virtual 8-device CPU mesh, against the port's unsharded routes and the JAX
package's sharded functions on the 8-device virtual CPU mesh that
tests/conftest.py sets up.  On CPU devices every shard runs the kernels'
plain versions."""

import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from seismic_bpmf_tpu import parallel as jpar  # noqa: E402
from seismic_bpmf_tpu.ops import reference as jref  # noqa: E402
from seismic_bpmf_tpu_torch import workflow  # noqa: E402
from seismic_bpmf_tpu_torch.config import Config  # noqa: E402
from seismic_bpmf_tpu_torch.data import (  # noqa: E402
    Data, Network, Stream, TemplateGroup, Trace, TravelTimes,
)
from seismic_bpmf_tpu_torch.detection import (  # noqa: E402
    Beamformer, MatchedFilter,
)
from seismic_bpmf_tpu_torch.ops import bp, mf  # noqa: E402
from seismic_bpmf_tpu_torch.ops.matched_filter import (  # noqa: E402
    matched_filter as mf_engine,
)
from seismic_bpmf_tpu_torch.parallel import (  # noqa: E402
    Mesh, beamform_sharded, beamform_sharded_pallas, make_mesh,
    matched_filter_sharded, matched_filter_sharded_pallas, sharded,
)

RTOL, ATOL = 1e-4, 1e-5   # the f32 gate of the JAX package's kernel tests
# The plain versions' products are batched matrix products over the
# templates a shard holds; the CPU's blocking of them, and so the last
# bits, depends on that count.  Time shards alone keep every bit.
SHARD_ATOL = 1e-6
CPU8 = [torch.device("cpu")] * 8
REPO = pathlib.Path(__file__).resolve().parent.parent


def _mesh(shape):
    n = int(np.prod(list(shape.values())))
    return make_mesh(shape, devices=CPU8[:n]), jpar.make_mesh(
        shape, devices=jax.devices()[:n])


def _mf_problem(rng, n_tp=5, n_sta=4, n_comp=3, L=32, n_samp=640,
                mv_range=(0, 30)):
    data = rng.normal(size=(n_sta, n_comp, n_samp)).astype(np.float32)
    moveouts = rng.integers(*mv_range, size=(n_tp, n_sta, n_comp)).astype(
        np.int32)
    templates = rng.normal(size=(n_tp, n_sta, n_comp, L)).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, size=(n_tp, n_sta, n_comp)).astype(
        np.float32)
    weights /= weights.sum(axis=(1, 2), keepdims=True)
    return templates, moveouts, weights, data


def _bp_problem(rng, n_src=100, n_sta=5, n_comp=3, n_ph=2, n_samp=1920,
                max_mv=40):
    """Sources 5 and 80 (80 in a later source shard of every mesh here)
    are exact copies, and a spike at sample 1000 makes them the best: the
    tie must go to 5."""
    features = rng.normal(size=(n_sta, n_comp, n_samp)).astype(np.float32)
    moveouts = rng.integers(0, max_mv, size=(n_src, n_sta, n_ph)).astype(
        np.int32)
    w_ph = np.zeros((n_sta, n_comp, n_ph), np.float32)
    w_ph[:, 2, 0] = 1.0
    w_ph[:, :2, 1] = 1.0
    w_src = rng.uniform(0.2, 1.0, size=(n_src, n_sta)).astype(np.float32)
    moveouts[80], w_src[80] = moveouts[5], w_src[5]
    for s in range(n_sta):
        features[s, 2, 1000 + moveouts[5, s, 0]] += 50.0
        features[s, :2, 1000 + moveouts[5, s, 1]] += 50.0
    return features, moveouts, w_ph, w_src


def test_make_mesh_rules():
    mesh = make_mesh({"tp": 2, "time": -1}, devices=CPU8)
    assert isinstance(mesh, Mesh) and mesh.shape == {"tp": 2, "time": 4}
    assert mesh.axis_names == ("tp", "time") and mesh.devices.size == 8
    assert mesh.grid("time", "tp").shape == (4, 2)
    assert mesh.grid("src", "time").shape == (1, 4)    # an axis it lacks
    assert make_mesh(devices=CPU8[:3]).shape == {"work": 3}
    with pytest.raises(ValueError, match="does not match"):
        make_mesh({"tp": 3, "time": 2}, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh({"tp": 1})
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh({"tp": 2}, devices=["cuda:0", "cuda:0"])


def test_halos_against_hand_cut_slices():
    x = np.arange(3 * 40, dtype=np.float32).reshape(3, 40)
    chunks = [torch.from_numpy(x[:, i : i + 10]) for i in range(0, 40, 10)]
    right = sharded._right_halo(chunks, 4)
    both = sharded._both_halos(chunks, 3, 4)
    xp = np.pad(x, ((0, 0), (3, 4)))      # zeros past both ends
    for i in range(4):
        np.testing.assert_array_equal(right[i].numpy(),
                                      np.pad(x, ((0, 0), (0, 4)))[
                                          :, 10 * i : 10 * i + 14])
        np.testing.assert_array_equal(both[i].numpy(),
                                      xp[:, 10 * i : 10 * i + 17])
    # a one-chunk axis: its halos are zeros
    only = sharded._both_halos(chunks[:1], 2, 3)[0].numpy()
    np.testing.assert_array_equal(only, np.pad(x[:, :10], ((0, 0), (2, 3))))


MF_MESHES = {"tp8": {"tp": 8, "time": 1}, "time8": {"tp": 1, "time": 8},
             "tp2_time4": {"tp": 2, "time": 4},
             "ragged_tp3_time2": {"tp": 3, "time": 2}}


@pytest.mark.parametrize("mesh_shape", list(MF_MESHES))
def test_mf_sharded_matches_unsharded_and_jax(mesh_shape):
    """Both sharded routes (the kernels' plain versions per shard, the
    plain-torch engine per shard) against the port's unsharded routes and
    the JAX package's `matched_filter_sharded` on the same mesh."""
    rng = np.random.default_rng(20260816)
    tp, mv, w, data = _mf_problem(rng)
    mesh, jmesh = _mesh(MF_MESHES[mesh_shape])
    want_jax = np.asarray(jpar.matched_filter_sharded(tp, mv, w, data,
                                                      jmesh))
    time_only = MF_MESHES[mesh_shape]["tp"] == 1
    for precision in ("highest", "high"):
        got = matched_filter_sharded_pallas(tp, mv, w, data, mesh,
                                            precision=precision)
        want = mf.matched_filter(tp, mv, w, data, precision=precision,
                                 device="cpu")
        assert got.shape == want.shape == want_jax.shape
        if time_only:
            assert torch.equal(got, want)
        torch.testing.assert_close(got, want, rtol=0, atol=SHARD_ATOL)
        np.testing.assert_allclose(got.numpy(), want_jax, rtol=RTOL,
                                   atol=ATOL)
    got = matched_filter_sharded(tp, mv, w, data, mesh)
    want = mf_engine(tp, mv, w, data, device="cpu")
    if time_only:
        assert torch.equal(got, want)
    torch.testing.assert_close(got, want, rtol=0, atol=SHARD_ATOL)
    np.testing.assert_allclose(got.numpy(), want_jax, rtol=RTOL, atol=ATOL)


def test_mf_sharded_step_decimation():
    rng = np.random.default_rng(20260816)
    tp, mv, w, data = _mf_problem(rng)
    mesh, jmesh = _mesh({"tp": 2, "time": 4})
    want_jax = np.asarray(jpar.matched_filter_sharded(tp, mv, w, data, jmesh,
                                                      step=4))
    want = mf_engine(tp, mv, w, data, step=4, device="cpu")
    for got in (matched_filter_sharded(tp, mv, w, data, mesh, step=4),
                matched_filter_sharded_pallas(tp, mv, w, data, mesh,
                                              step=4)):
        assert got.shape == want.shape == want_jax.shape
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), want_jax, rtol=RTOL,
                                   atol=ATOL)


def test_mf_sharded_precision_ladder_and_negative_moveouts():
    """Negative moveouts: the two-sided halo of the plain-torch route and
    the padded layout of the kernels' route, against the JAX package's
    float64 oracle at the JAX sharded test's gates (5e-6 `highest`, 2e-5
    `high`), its sharded Pallas kernel in interpret mode at `high` and its
    sharded XLA route."""
    rng = np.random.default_rng(7)
    tp, mv, w, data = _mf_problem(rng, n_tp=8, L=40, n_samp=2048,
                                  mv_range=(-30, 60))
    mesh, jmesh = _mesh({"tp": 2, "time": 4})
    ref = jref.matched_filter(tp, mv, w, data)
    for precision, tol in (("highest", 5e-6), ("high", 2e-5)):
        got = matched_filter_sharded_pallas(tp, mv, w, data, mesh,
                                            precision=precision)
        np.testing.assert_allclose(got.numpy(), ref, atol=tol)
    pal = jpar.matched_filter_sharded_pallas(tp, mv, w, data, jmesh,
                                             lag_block=256, interpret=True,
                                             precision="high")
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), rtol=RTOL,
                               atol=ATOL)
    got = matched_filter_sharded(tp, mv, w, data, mesh)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-6)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jpar.matched_filter_sharded(tp, mv, w, data,
                                                            jmesh)),
        rtol=RTOL, atol=ATOL)


def test_mf_time_chunk_smaller_than_halo_raises():
    rng = np.random.default_rng(3)
    tp, mv, w, data = _mf_problem(rng, mv_range=(0, 300))
    mesh, _ = _mesh({"tp": 1, "time": 8})
    with pytest.raises(ValueError, match="smaller than halo"):
        matched_filter_sharded(tp, mv, w, data, mesh)


BP_MESHES = {"src8": {"src": 8, "time": 1}, "time8": {"src": 1, "time": 8},
             "src2_time4": {"src": 2, "time": 4}}


@pytest.mark.parametrize("mesh_shape", list(BP_MESHES))
@pytest.mark.parametrize("oob", ["strict", "flexible"])
def test_bp_sharded_matches_unsharded_and_jax(mesh_shape, oob):
    """reduce='max' bit for bit the port's unsharded route's, the tie
    between sources 5 and 80 (other source shards) to 5; reduce='none'
    stitched bit for bit; under the JAX package's default policy
    ('strict') both against the JAX `beamform_sharded` too (the port's
    unsharded route is held to the JAX package under both policies in
    tests/test_torch_bp.py)."""
    rng = np.random.default_rng(11)
    feats, mv, w_ph, w_src = _bp_problem(rng)
    mesh, jmesh = _mesh(BP_MESHES[mesh_shape])
    want_v, want_i = bp.beamform(feats, mv, w_ph, w_src, out_of_bounds=oob,
                                 device="cpu")
    got_v, got_i = beamform_sharded_pallas(feats, mv, w_ph, w_src, mesh,
                                           out_of_bounds=oob)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    assert int(got_i[1000]) == 5 and not bool((got_i == 80).any())
    got = beamform_sharded(feats, mv, w_ph, w_src, mesh, reduce="none",
                           out_of_bounds=oob, engine="gather")
    want = bp.beamform(feats, mv, w_ph, w_src, reduce="none",
                       out_of_bounds=oob, device="cpu")
    assert torch.equal(got, want)
    if oob != "strict":
        return
    jkw = dict(engine="gather", time_block=2048, src_block=16)
    jv, ji = jpar.beamform_sharded(feats, mv, w_ph, w_src, jmesh, **jkw)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)
    clear = _clear_argmax(feats, mv, w_ph, w_src, oob)
    np.testing.assert_array_equal(got_i.numpy()[clear], np.asarray(ji)[clear])
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jpar.beamform_sharded(
            feats, mv, w_ph, w_src, jmesh, reduce="none", **jkw)),
        rtol=RTOL, atol=ATOL)


def _clear_argmax(feats, mv, w_ph, w_src, oob):
    """Samples whose two best beams differ by more than ATOL: there the
    argmax does not hang on the last bits of the sum's order."""
    beam = np.asarray(jref.beamform(feats, mv, w_ph, w_src, reduce="none",
                                    out_of_bounds=oob))
    top2 = np.sort(beam, axis=0)[-2:]
    return (top2[1] - top2[0]) > ATOL


def test_bp_sharded_origin_masks_at_absolute_samples():
    """One time shard alone: features holding only its columns from an
    absolute origin give the whole day's beam of those samples, 'max' and
    'none', and a window that misses a column the tiles read raises."""
    rng = np.random.default_rng(13)
    feats, mv, w_ph, w_src = _bp_problem(rng, n_samp=2000)
    plan = bp.BeamformPlan(mv, w_ph, w_src, 2000, device="cpu")
    g = plan.fold_and_pad(feats)
    tab = plan.tables
    margin = tab.ext - tab.n_t_blocks * bp.TIME_TILE
    t0 = bp.TIME_TILE
    win = g[:, t0 : t0 + 2 * bp.TIME_TILE + margin].contiguous()
    want_v, want_i = bp.bp_beam(g, tab)
    got_v, got_i = bp.bp_beam(win, tab, tile0=1, n_tt=2, origin=t0)
    assert torch.equal(got_v, want_v[t0 : t0 + 2 * bp.TIME_TILE])
    assert torch.equal(got_i, want_i[t0 : t0 + 2 * bp.TIME_TILE])
    beam = bp.bp_beam(g, tab, reduce="none")
    part = bp.bp_beam(win, tab, reduce="none", tile0=1, n_tt=2, origin=t0)
    assert torch.equal(part, beam[:, t0 : t0 + 2 * bp.TIME_TILE])
    last = bp.bp_beam(g, tab, reduce="none", tile0=4, n_tt=1)
    assert torch.equal(last, beam[:, 4 * bp.TIME_TILE :])
    with pytest.raises(ValueError, match="layout"):
        bp.bp_beam(win[:, :-4].contiguous(), tab, tile0=1, n_tt=2,
                   origin=t0)
    with pytest.raises(ValueError, match="layout"):
        bp.bp_beam(win, tab, tile0=1, n_tt=2, origin=t0 + 4)


def test_first_max_rule():
    vals = torch.tensor([[1.0, 3.0, 2.0], [3.0, 3.0, 1.0], [3.0, 0.0, 2.0]])
    idxs = torch.tensor([[7, 1, 5], [2, 9, 0], [4, 3, 6]], dtype=torch.int32)
    v, i = bp.first_max(vals, idxs)
    assert v.tolist() == [3.0, 3.0, 2.0] and i.tolist() == [2, 1, 5]


# --------------------------------------------------------------------------
# the engines and the campaign on a small world

SR, L, N = 25.0, 50, 12000


def _mf_world():
    rng = np.random.default_rng(0)
    wave = (rng.normal(size=(2, 4, 3, L)) * np.hanning(L) * 20).astype(
        np.float32)
    mv = rng.integers(-10, 60, size=(2, 4, 3))
    x = rng.standard_normal((4, 3, N), dtype=np.float32)
    for o in (3000, 7001):
        for s in range(4):
            for c in range(3):
                x[s, c, o + mv[0, s, c] : o + mv[0, s, c] + L] += wave[0, s, c]
    tpl = np.stack([x[s, c, 3000 + mv[0, s, c] :][:L] for s in range(4)
                    for c in range(3)]).reshape(4, 3, L)
    tg = TemplateGroup.from_arrays(np.stack([tpl, wave[1]]), mv, ["0", "1"],
                                   list("ABCD"), sampling_rate=SR)
    return tg, x


def _reader(x):
    def reader(where, starttime=None, endtime=None, **kw):
        st = Stream()
        for s, sta in enumerate("ABCD"):
            for c, comp in enumerate("NEZ"):
                st += Trace(x[s, c], station=sta, channel="HH" + comp,
                            sampling_rate=SR, starttime=0.0)
        return st
    return reader


def _data(x):
    return Data("1970-01-01", "day", _reader(x), duration=x.shape[-1] / SR,
                sampling_rate=SR).read_waveforms()


def _hits(dets):
    return {t: [(round(e.origin_time_epoch * SR), round(e.aux_data["cc"], 4))
                for e in evs] for t, evs in dets.items()}


@pytest.mark.parametrize("precision", ["screen", "highest"])
def test_matched_filter_engine_with_a_mesh(precision):
    """`MatchedFilter(mesh=)`: the same detections (template, sample, CC)
    as without a mesh, through `preupload_day` + `set_data` (the campaign's
    prefetch) and through `set_data` alone."""
    tg, x = _mf_world()
    cfg = Config(data_buffer_sec=0.0, sampling_rate_hz=SR)
    mesh = make_mesh({"tp": 2, "time": 4}, devices=CPU8)
    found = []
    for m, pre in ((None, False), (mesh, True), (mesh, False)):
        eng = MatchedFilter(tg, cfg=cfg, mesh=m, precision=precision,
                            min_channels=3, min_stations=2, max_kurto=1e6,
                            device=None if m is not None else "cpu")
        data = _data(x)
        if pre:
            eng.preupload_day(data)
        dets = workflow.matched_filter_day(
            tg, data, cfg=cfg, mf=eng, minimum_interevent_time=5.0,
            threshold_window_dur=120.0,
            white_noise=np.random.default_rng(1).normal(size=N).astype(
                np.float32))
        found.append(_hits(dets))
    assert found[0] == found[1] == found[2]
    assert [i for i, _ in found[0]["0"]] == [3000, 7001]
    assert eng.mesh is mesh and eng.device == torch.device("cpu")


def test_engines_refuse_another_kind_of_mesh_or_device():
    tg, _ = _mf_world()
    mesh = make_mesh({"tp": 2}, devices=CPU8[:2])
    with pytest.raises(NotImplementedError, match="process-group mesh"):
        MatchedFilter(tg, mesh=object())
    with pytest.raises(NotImplementedError, match="process-group mesh"):
        Beamformer(mesh=object())
    with pytest.raises(ValueError, match="first device"):
        MatchedFilter(tg, mesh=mesh, device="meta")


def _bp_world():
    rng = np.random.default_rng(5)
    n_src, n_bp = 40, 9000
    sta_x = np.array([0.0, 15.0, 30.0, 45.0])
    src_x = np.linspace(0.0, 45.0, n_src)
    dist = np.hypot(src_x[:, None] - sta_x[None, :], 8.0)
    tts = {"P": {s: dist[:, i] / 6.0 for i, s in enumerate("ABCD")},
           "S": {s: dist[:, i] / 3.4 for i, s in enumerate("ABCD")}}
    tt = TravelTimes.from_arrays(tts, {"longitude": src_x / 111.0,
                                       "latitude": np.zeros(n_src),
                                       "depth": np.full(n_src, 8.0)})
    tt.convert_to_samples(SR)
    net = Network.from_arrays(list("ABCD"), longitude=sta_x / 111.0,
                              latitude=np.zeros(4))
    x = 0.1 * rng.standard_normal((4, 3, n_bp), dtype=np.float32)
    for o, src in ((3000, 11), (6001, 30)):
        for s in range(4):
            for c, ph in ((2, "P"), (0, "S"), (1, "S")):
                a = o + int(tt.travel_times_samp[ph]["ABCD"[s]][src])
                x[s, c, a - 6 : a + 7] += 8.0 * np.hanning(13)
    return net, tt, x


def test_beamformer_with_a_mesh():
    """`Beamformer(mesh=)`: the same (maxbeam, sources) and detections as
    without a mesh; the plan is cached and rebuilt for new weights; the
    'none' beam and `beam_peak` through the mesh."""
    net, tt, x = _bp_world()
    mesh = make_mesh({"src": 2, "time": 4}, devices=CPU8)
    outs = []
    for m in (None, mesh):
        bf = Beamformer(data=_data(x), network=net, phases=["P", "S"],
                        travel_times=tt, mesh=m,
                        device=None if m is not None else "cpu")
        bf.set_weights(weights_phases=workflow.default_weights_phases(4))
        bf.set_weights_sources(method="closest_stations",
                               num_closest_stations=4, normalize=True)
        feats = x ** 2
        mb, ms = bf.backproject(feats)
        dets, peaks, srcs = bf.find_detections(
            bf.compute_detection_threshold(window_sec=120.0), 10.0)
        peak = bf.beam_peak(feats[..., :2000], "strict")
        outs.append((mb, ms, list(peaks), list(srcs), peak[:2], peak[2]))
        if m is not None:
            plans = dict(bf._plans)
            bf.backproject(feats)
            assert all(bf._plans[k] is p for k, p in plans.items())
            bf.set_weights_sources(method="closest_stations",
                                   num_closest_stations=3, normalize=True)
            bf.backproject(feats)
            assert len(bf._plans) == len(plans) + 1
            assert all(isinstance(p, sharded.ShardedBeamformPlan)
                       for p in bf._plans.values())
    (a, b) = outs
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2:5] == b[2:5] and len(a[2]) >= 2
    np.testing.assert_array_equal(a[5], b[5])


@pytest.mark.parametrize("stage", ["mf", "bp"])
def test_scan_days_with_a_mesh(stage):
    """`scan_days(mesh=)` over one small day per stage: the detections of
    the run without a mesh, the engine's mesh kept across days."""
    cfg = Config(data_buffer_sec=0.0, sampling_rate_hz=SR)
    mesh = make_mesh({"tp" if stage == "mf" else "src": 2, "time": 4},
                     devices=CPU8)
    runs = []
    for kw in (dict(device="cpu"), dict(mesh=mesh)):
        if stage == "mf":
            tg, x = _mf_world()
            out = workflow.scan_days(
                ["day", "day2"], lambda d: _data(x), tg, cfg=cfg,
                minimum_interevent_time=5.0, threshold_window_dur=120.0,
                min_channels=3, min_stations=2, max_kurto=1e6,
                rng=np.random.default_rng(1), **kw)
            runs.append({d: _hits(r) for d, r in out.items()})
        else:
            net, tt, x = _bp_world()
            out = workflow.scan_days(
                ["day", "day2"], lambda d: _data(x), cfg=cfg, stage="bp",
                network=net, travel_times=tt, num_closest_stations=4,
                threshold_window_sec=120.0, **kw)
            runs.append({d: [(round(e.origin_time_epoch * SR),
                              e.aux_data["source_index"]) for e in evs]
                         for d, evs in out.items()})
    assert runs[0] == runs[1]
    assert all(len(v) for v in runs[0].values())


SHARDED_PATH = textwrap.dedent("""
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
    from seismic_bpmf_tpu_torch import parallel
    from seismic_bpmf_tpu_torch.ops import bp, mf

    rng = np.random.default_rng(0)
    mesh = parallel.make_mesh({{"tp": 2, "time": 2}},
                              devices=[torch.device("cpu")] * 4)
    tp = rng.normal(size=(3, 2, 3, 20)).astype(np.float32)
    mv = rng.integers(-5, 20, size=(3, 2, 3))
    w = np.full((3, 2, 3), 1 / 6, np.float32)
    x = rng.normal(size=(2, 3, 3000)).astype(np.float32)
    got = parallel.matched_filter_sharded_pallas(tp, mv, w, x, mesh)
    want = mf.matched_filter(tp, mv, w, x, device="cpu")
    assert torch.allclose(got, want, rtol=0, atol=1e-6)
    bmesh = parallel.make_mesh({{"src": 2, "time": 2}},
                               devices=[torch.device("cpu")] * 4)
    bmv = rng.integers(0, 30, size=(70, 2, 2))
    w_ph = np.ones((2, 3, 2), np.float32)
    w_src = np.ones((70, 2), np.float32)
    v, i = parallel.beamform_sharded_pallas(x, bmv, w_ph, w_src, bmesh)
    wv, wi = bp.beamform(x, bmv, w_ph, w_src, device="cpu")
    assert torch.equal(v, wv) and torch.equal(i, wi)
    loaded = sorted(m for m in sys.modules
                    if any(m == b or m.startswith(b + ".") for b in BLOCKED))
    assert not loaded, loaded
    print("SHARDED_PATH_OK")
""")


def test_sharded_path_runs_without_jax_pandas_h5py_ml_dtypes():
    """`parallel` imports neither JAX nor the JAX package, nor pandas,
    h5py or ml_dtypes, and its sharded scans run with all of them
    blocked."""
    blocked = "jax jaxlib pandas h5py ml_dtypes seismic_bpmf_tpu".split()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", SHARDED_PATH.format(blocked=blocked)],
        capture_output=True, text=True, cwd=str(REPO), env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SHARDED_PATH_OK" in proc.stdout
