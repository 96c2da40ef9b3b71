"""The port's backprojection ops against the JAX package, on the CPU.

The same seeded numpy inputs go through both packages: the beamformer's
plain version (`ops.bp`) against `ops.reference.beamform` and the Pallas
kernel in interpret mode, the characteristic functions (`ops.cf`), the BP
threshold and the peak finder (whose native `mpd` suppression is also
held bit for bit to its plain loop, `ops.reference.peak_suppression`).
Beam values within rtol 1e-4, atol 1e-5
(the f32 gate of the JAX package's kernel tests) with identical argmax
indices; envelopes within 1e-4 (two f32 FFT libraries).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seismic_bpmf_tpu.ops import cf as jcf  # noqa: E402
from seismic_bpmf_tpu.ops import reference as jref  # noqa: E402
from seismic_bpmf_tpu.ops.pallas_bp import (  # noqa: E402
    PallasBeamformPlan, beamform_pallas,
)
from seismic_bpmf_tpu.ops.picks import detect_peaks as jdetect_peaks  # noqa: E402
from seismic_bpmf_tpu.ops.thresholds import (  # noqa: E402
    bp_detection_threshold as jbp_threshold,
)

from seismic_bpmf_tpu_torch import _build  # noqa: E402
from seismic_bpmf_tpu_torch.ops import bp, cf, host_ops  # noqa: E402
from seismic_bpmf_tpu_torch.ops.picks import (  # noqa: E402
    detect_peaks, peak_candidates,
)
from seismic_bpmf_tpu_torch.ops.thresholds import (  # noqa: E402
    bp_detection_threshold,
)

RTOL, ATOL = 1e-4, 1e-5


def _problem(seed, n_src=29, n_samp=700, max_mv=60, n_sta=5, sparse=False,
             ties=False):
    rng = np.random.default_rng(seed)
    n_comp, n_ph = 3, 2
    feats = rng.normal(size=(n_sta, n_comp, n_samp)).astype(np.float32)
    mv = rng.integers(0, max_mv, size=(n_src, n_sta, n_ph)).astype(np.int32)
    w_ph = np.zeros((n_sta, n_comp, n_ph), np.float32)
    w_ph[:, 2, 0] = 1.0
    w_ph[:, :2, 1] = 1.0
    w_src = rng.uniform(0.2, 1.0, size=(n_src, n_sta)).astype(np.float32)
    if sparse:
        w_src[:, ::2] = 0.0          # half the stations dead per source
        w_src[3] = 0.0               # a source with no used pair: beam 0
    if ties:
        # exact copies of source 4 later in the grid: equal beams, bit for
        # bit, whose argmax must be the smallest index
        for i in (9, n_src - 1):
            mv[i], w_src[i] = mv[4], w_src[4]
    return feats, mv, w_ph, w_src


CASES = {
    "dense": dict(),
    "sparse": dict(sparse=True, max_mv=300),
    # n_src not a multiple of the 32-source tile; several tiles
    "ragged_tiles": dict(n_src=75, n_samp=1300, sparse=True),
    "ties": dict(ties=True),
}


@pytest.mark.parametrize("oob", ["strict", "flexible"])
@pytest.mark.parametrize("case", list(CASES))
def test_reduce_max_matches_oracle_and_pallas(case, oob):
    feats, mv, w_ph, w_src = _problem(5, **CASES[case])
    want_v, want_i = jref.beamform(feats, mv, w_ph, w_src, reduce="max",
                                   out_of_bounds=oob)
    got_v, got_i = bp.beamform(feats, mv, w_ph, w_src, reduce="max",
                               out_of_bounds=oob, device="cpu")
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    pal_v, pal_i = beamform_pallas(feats, mv, w_ph, w_src, reduce="max",
                                   out_of_bounds=oob, time_block=256,
                                   src_block=16, interpret=True,
                                   precision="highest")
    np.testing.assert_allclose(got_v.numpy(), np.asarray(pal_v), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(pal_i))
    if case == "ties":
        assert not np.isin(got_i.numpy(), [9, mv.shape[0] - 1]).any()
        assert (got_i.numpy() == 4).any()


@pytest.mark.parametrize("oob", ["strict", "flexible"])
@pytest.mark.parametrize("case", ["dense", "sparse", "ragged_tiles"])
def test_reduce_none_matches_oracle_and_pallas(case, oob):
    feats, mv, w_ph, w_src = _problem(6, **CASES[case])
    want = jref.beamform(feats, mv, w_ph, w_src, reduce="none",
                         out_of_bounds=oob)
    got = bp.beamform(feats, mv, w_ph, w_src, reduce="none",
                      out_of_bounds=oob, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    pal = np.asarray(beamform_pallas(feats, mv, w_ph, w_src, reduce="none",
                                     out_of_bounds=oob, time_block=256,
                                     src_block=16, interpret=True))
    np.testing.assert_allclose(got, pal, rtol=RTOL, atol=ATOL)
    if case != "dense":
        assert np.all(got[3] == 0.0)  # no used pair: a beam of 0


@pytest.mark.parametrize("oob", ["strict", "flexible"])
def test_chunked_call_is_the_single_call_bit_for_bit(oob, monkeypatch):
    feats, mv, w_ph, w_src = _problem(7, n_src=75, n_samp=1800, sparse=True)
    plan = bp.BeamformPlan(mv, w_ph, w_src, feats.shape[-1],
                           out_of_bounds=oob, device="cpu")
    g = plan.fold_and_pad(feats)
    v1, i1 = plan.call_folded(g)
    v2, i2 = plan.call_folded_chunked(g, 3)
    assert torch.equal(v1, v2) and torch.equal(i1, i2)
    # a large problem cuts itself into chunks, with the same bits
    monkeypatch.setattr(bp.BeamformPlan, "CHUNK_POINTS", 10_000)
    launches = bp.beamform_plain.calls
    v3, i3 = plan.call_folded(g)
    assert bp.beamform_plain.calls - launches == plan.n_t_blocks
    assert torch.equal(v1, v3) and torch.equal(i1, i3)
    # and the JAX plan agrees
    jplan = PallasBeamformPlan(mv, w_ph, w_src, feats.shape[-1],
                               out_of_bounds=oob, time_block=256,
                               src_block=16, interpret=True,
                               precision="highest")
    jv, ji = jplan.call_folded_chunked(jplan.fold_and_pad(feats), 3)
    np.testing.assert_allclose(v2.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ji))


def test_plan_tables_and_fail_loud_checks():
    feats, mv, w_ph, w_src = _problem(8, n_src=75, sparse=True)
    plan = bp.BeamformPlan(mv, w_ph, w_src, feats.shape[-1], device="cpu")
    tab = plan.tables
    used = (w_src != 0).sum()
    assert tab.n_pairs == 2 * used
    assert tab.n_tiles == -(-75 // bp.SRC_TILE)
    assert tab.n_stages == tab.n_tiles        # few rows: a stage per tile
    assert tab.stage_prog[-1].item() * 4 == tab.prog.numel()
    # every row's used moveouts lie inside its staged words
    assert bool((tab.ent_lo % 4 == 0).all())
    assert int(tab.ent_span.max()) + bp.TIME_TILE < tab.stride
    assert 1.0 <= tab.fma_per_word <= 2.0
    bad = mv.copy()
    bad[2, 1, 0] = -1
    with pytest.raises(ValueError, match="non-negative"):
        bp.BeamformPlan(bad, w_ph, w_src, feats.shape[-1], device="cpu")
    for kw, match in ((dict(precision="fast"), "unknown precision"),
                      (dict(reduce="sum"), "reduce"),
                      (dict(out_of_bounds="wrap"), "out_of_bounds")):
        with pytest.raises(ValueError, match=match):
            bp.BeamformPlan(mv, w_ph, w_src, feats.shape[-1], device="cpu",
                            **kw)
    with pytest.raises(ValueError, match="chunked"):
        bp.BeamformPlan(mv, w_ph, w_src, feats.shape[-1], reduce="none",
                        device="cpu").call_folded_chunked(None, 2)
    with pytest.raises(ValueError, match="samples"):
        plan.fold_and_pad(feats[..., :-1])


def _walk_tables(tab, g):
    """The kernel's walk over a plan's compact tables, in numpy over the
    whole day: source tiles, their stages, a stage's staged rows and, per
    warp, the items of its program.  Returns the 'none' beam (float64
    sums, strict mask) and, per source, the station-phases in the order
    they are summed."""
    g = g.numpy().astype(np.float64)
    n_src, n_samp = tab.n_src, tab.n_samp
    tile_stage, stage_row = tab.tile_stage.numpy(), tab.stage_row.numpy()
    stage_prog, prog = tab.stage_prog.numpy(), tab.prog.numpy()
    ent_sp, ent_lo = tab.ent_sp.numpy(), tab.ent_lo.numpy()
    ent_span = tab.ent_span.numpy()
    mv = tab.mv.numpy()
    head, D = bp._head_words(), bp.WIN_D
    beam = np.zeros((n_src, n_samp))
    order = [[] for _ in range(n_src)]
    words = items = 0
    for tile in range(tab.n_tiles):
        for j in range(tile_stage[tile], tile_stage[tile + 1]):
            assert stage_row[j + 1] - stage_row[j] <= tab.max_rows
            p = prog[4 * stage_prog[j]:4 * stage_prog[j + 1]]
            assert 4 * len(p) <= tab.prog_bytes
            assert p[0] == 0 and p[bp.WARPS + 2] == tile
            assert p[bp.WARPS + 1] == ((j == tile_stage[tile])
                                       + 2 * (j + 1 == tile_stage[tile + 1]))
            el = p[head:].reshape(-1, 4)
            # the loop loads two elements past a part's end mark
            assert p[bp.WARPS] + 2 <= len(el)
            for warp in range(bp.WARPS):
                assert el[p[warp + 1] - 1, 0] == 2 * D + 1    # the end mark
                for code, x, wa, wb in el[p[warp]:p[warp + 1] - 1]:
                    e = stage_row[j] + x // tab.stride
                    base = x % tab.stride
                    assert e < stage_row[j + 1] and 0 <= code <= 2 * D
                    assert ent_lo[e] % 4 == 0 and ent_span[e] < bp.ROW_CAP
                    # (source of the pair, its offset from the window's
                    # start, its weight)
                    delta = code - (D - 1)
                    took = {2 * D - 1: [(0, 0, wa)], 2 * D: [(1, 0, wb)]}.get(
                        code, [(0, max(-delta, 0), wa),
                               (1, max(delta, 0), wb)])
                    for k, d, wbits in took:
                        # the window lies inside its row's staged words
                        assert base + d <= ent_span[e]
                        s = tile * bp.SRC_TILE + 2 * warp + k
                        sp, m = ent_sp[e], ent_lo[e] + base + d
                        assert s < n_src and m == mv[sp, s]
                        w = np.int32(wbits).view(np.float32)
                        assert w != 0.0
                        beam[s] += w * g[sp, m:m + n_samp]
                        order[s].append(sp)
                    assert (wa == 0) == (code == 2 * D)
                    assert (wb == 0) == (code == 2 * D - 1)
                    words += bp.LANE_COLS + max(d for _, d, _ in took)
                    items += 1
    assert words == tab.window_words and items == tab.n_items
    if tab.strict:
        t = np.arange(n_samp)
        lo, hi = tab.lo.numpy()[:, None], tab.hi.numpy()[:, None]
        beam[(t + lo < 0) | (t + hi >= n_samp)] = 0.0
    return beam, order


@pytest.mark.parametrize("case", ["sparse", "all_weighted",
                                  "small_buffers", "dead_tile", "wide_rows",
                                  "every_delta"])
def test_stage_tables_walk_to_the_dense_beam(case, monkeypatch):
    """Every used (source, station-phase) pair is summed once, in ascending
    station-phase order, however a tile's rows are cut into stages and
    whether a warp's two sources share a window: with every one of 32
    stations weighted (64
    rows a tile, more than one slot of the ring holds), with slots cut
    small on purpose, and with station-phases whose moveouts spread over
    more than one staged row."""
    kw = dict(n_src=150, n_samp=900, max_mv=120)
    if case == "sparse":
        kw.update(sparse=True)
    else:
        kw.update(n_sta=32)
    if case == "small_buffers":
        # room for about 5 rows of (120 + TIME_TILE) samples a slot
        monkeypatch.setattr(bp, "SMEM_LIMIT", 60_000)
    feats, mv, w_ph, w_src = _problem(14, **kw)
    if case == "dead_tile":
        # a tile with no used pair: beam 0
        w_src[bp.SRC_TILE:2 * bp.SRC_TILE] = 0.0
    if case == "wide_rows":
        mv[1, 0, 0] = 60_000          # two rows, far apart
        mv[70, 3, 1] = 3 * bp.ROW_CAP
        mv[5:9, 4, 0] += np.arange(4, dtype=np.int32) * (bp.ROW_CAP - 3)
    if case == "every_delta":
        # a warp's second source at -WIN_D - 1 ... WIN_D + 1 from its first
        mv = mv + 2 * bp.WIN_D
        pair = np.arange(mv.shape[0] // 2)
        mv[1::2] = mv[::2] + (pair % (2 * bp.WIN_D + 3)
                              - bp.WIN_D - 1)[:, None, None].astype(np.int32)
    plan = bp.BeamformPlan(mv, w_ph, w_src, feats.shape[-1],
                           reduce="none", device="cpu")
    tab = plan.tables
    if case == "every_delta":
        codes = np.concatenate([
            tab.prog.numpy()[4 * a + bp._head_words():4 * b].reshape(-1, 4)
            for a, b in zip(tab.stage_prog[:-1], tab.stage_prog[1:])])[:, 0]
        assert set(codes.tolist()) >= set(range(2 * bp.WIN_D + 2))
    n_st = np.diff(tab.tile_stage.numpy())
    assert (n_st >= 1).all()
    if case in ("all_weighted", "small_buffers"):
        assert n_st.max() >= (2 if case == "all_weighted" else 10)
    if case == "wide_rows":
        assert _rows_of_first_tile(tab, 0) == 2
        assert _rows_of_first_tile(tab, 8) == 4
        assert int(tab.ent_span.max()) < bp.ROW_CAP
    assert bp._smem_bytes(tab.stride, tab.max_rows,
                          tab.prog_bytes) <= bp.SMEM_LIMIT
    g = plan.fold_and_pad(feats)
    beam, order = _walk_tables(tab, g)
    w = tab.w.numpy()
    for i, sps in enumerate(order):
        assert sps == list(np.flatnonzero(w[:, i]))
    np.testing.assert_allclose(beam, plan.call_folded(g).numpy(), rtol=RTOL,
                               atol=ATOL)
    if case == "dead_tile":
        assert np.all(beam[bp.SRC_TILE:2 * bp.SRC_TILE] == 0.0)


def _rows_of_first_tile(tab, sp):
    """How many staged rows the first source tile has for a station-phase."""
    n = int(tab.stage_row[tab.tile_stage[1]])
    return int((tab.ent_sp[:n] == sp).sum())


def test_a_row_too_wide_for_shared_memory_raises():
    """One moveout 60,000 samples from its tile's others: the plan stages
    that station-phase as two rows (nothing raises any more) and the beam
    is the JAX package's."""
    feats, mv, w_ph, w_src = _problem(15, n_src=40, n_samp=600, max_mv=60)
    mv[1, 0, 0] = 60_000              # one row spread over 60,000 samples
    plan = bp.BeamformPlan(mv, w_ph, w_src, feats.shape[-1], device="cpu")
    assert _rows_of_first_tile(plan.tables, 0) == 2
    assert int(plan.tables.ent_span.max()) < bp.ROW_CAP
    for oob in ("strict", "flexible"):
        want_v, want_i = jref.beamform(feats, mv, w_ph, w_src, reduce="max",
                                       out_of_bounds=oob)
        got_v, got_i = bp.beamform(feats, mv, w_ph, w_src, reduce="max",
                                   out_of_bounds=oob, device="cpu")
        np.testing.assert_allclose(got_v.numpy(), want_v, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(got_i.numpy(), want_i)
        want = jref.beamform(feats, mv, w_ph, w_src, reduce="none",
                             out_of_bounds=oob)
        got = bp.beamform(feats, mv, w_ph, w_src, reduce="none",
                          out_of_bounds=oob, device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("oob", ["strict", "flexible"])
def test_a_wide_row_matches_pallas_in_interpret_mode(oob):
    """The same at a spread the Pallas kernel bears in interpret mode."""
    feats, mv, w_ph, w_src = _problem(15, n_src=40, n_samp=600, max_mv=60)
    mv[1, 0, 0] = 3_000
    plan = bp.BeamformPlan(mv, w_ph, w_src, feats.shape[-1],
                           out_of_bounds=oob, device="cpu")
    assert _rows_of_first_tile(plan.tables, 0) == 2
    got_v, got_i = plan(feats)
    pal_v, pal_i = beamform_pallas(feats, mv, w_ph, w_src, reduce="max",
                                   out_of_bounds=oob, time_block=256,
                                   src_block=16, interpret=True,
                                   precision="highest")
    np.testing.assert_allclose(got_v.numpy(), np.asarray(pal_v), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(pal_i))


def test_non_cpu_tensors_never_take_the_plain_version():
    """The wrapper dispatches on the tensor's device: a non-CPU tensor
    launches the kernel or raises (here: a device it has no kernel for)."""
    feats, mv, w_ph, w_src = _problem(8, n_src=40)
    plan = bp.BeamformPlan(mv, w_ph, w_src, feats.shape[-1], device="cpu")
    g = plan.fold_and_pad(feats)
    calls = bp.beamform_plain.calls
    with pytest.raises(ValueError, match="device"):
        bp.bp_beam(g.to("meta"), plan.tables)
    with pytest.raises(ValueError, match="float32"):
        bp.bp_beam(g.double(), plan.tables)
    with pytest.raises(ValueError, match="layout"):
        bp.bp_beam(g[:, 1:].contiguous(), plan.tables)
    assert bp.beamform_plain.calls == calls


def test_envelope_and_saturated_envelopes_match_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 3, 2047)).astype(np.float32)
    np.testing.assert_allclose(cf.envelope(x, device="cpu").numpy(),
                               np.asarray(jcf.envelope(x)), rtol=1e-4,
                               atol=1e-4)
    x = rng.normal(size=(4, 3, 3000)).astype(np.float32)
    x[1, 2, :] = 0.0                # a dead channel
    x[2, 0, :2000] = 0.0            # a mostly missing channel
    x[3, 1] = 1e-13 * np.sign(x[3, 1])  # an anomalous (tiny MAD) channel
    got, got_av = cf.saturated_envelopes(x, device="cpu")
    want, want_av = jcf.saturated_envelopes(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(got_av.numpy(), np.asarray(want_av))
    assert got.dtype == torch.float32 and got_av.dtype == torch.int32


@pytest.mark.parametrize("w", [20, 50])
def test_kurtosis_matches_jax(w):
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 3, 1500)).astype(np.float32)
    x[0, 1, 700:760] += 8.0 * rng.normal(size=60).astype(np.float32)
    x[1, 2] = 0.0                   # a dead channel: variance <= 1e-6 -> 0
    got = cf.kurtosis(x, w, device="cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(jcf.kurtosis(x, w)),
                               rtol=1e-4, atol=1e-4)
    assert np.all(got[1, 2] == 0.0) and np.all(got[..., :w] == 0.0)


@pytest.mark.parametrize("n,window,overlap", [(20000, 3000, 0.75),
                                              (20011, 4096, 0.5),
                                              (5000, 9000, 0.75)])
def test_bp_detection_threshold_matches_jax(n, window, overlap):
    rng = np.random.default_rng(11)
    x = np.abs(rng.normal(size=n)).astype(np.float32)
    x[n // 3 : n // 3 + 50] += 20.0
    got = bp_detection_threshold(x, window, overlap=overlap, num_dev=12.0,
                                 device="cpu").numpy()
    want = np.asarray(jbp_threshold(x, window, overlap=overlap,
                                    num_dev=12.0))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if window <= n:
        np.testing.assert_allclose(
            got, jref.bp_detection_threshold(x, window, overlap, 12.0),
            rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(mpd=25), dict(mpd=1), dict(mph=1.0),
                                dict(threshold=0.2, edge="both"),
                                dict(valley=True, mpd=10),
                                dict(kpsh=True, mpd=40)])
def test_detect_peaks_matches_jax(kw):
    rng = np.random.default_rng(12)
    x = np.convolve(rng.normal(size=4000), np.hanning(9), "same")
    x[100:104] = x[100]             # a flat top
    x[2000] = np.nan
    np.testing.assert_array_equal(detect_peaks(x, **kw),
                                  jdetect_peaks(x, **kw))


@pytest.mark.parametrize("kpsh", [False, True])
def test_detect_peaks_suppression_matches_jax_on_a_long_series(kpsh):
    """Thousands of peaks, many of equal height (rounded values): the
    neighbour-only suppression keeps the reference's peaks."""
    rng = np.random.default_rng(13)
    x = np.round(np.convolve(rng.normal(size=60_000), np.hanning(7),
                             "same"), 1)
    for mpd in (7, 250):
        np.testing.assert_array_equal(
            detect_peaks(x, mpd=mpd, kpsh=kpsh),
            jdetect_peaks(x, mpd=mpd, kpsh=kpsh))



@pytest.mark.parametrize("edge", [None, "rising", "falling", "both"])
def test_detect_peaks_edges_match_jax_on_flat_tops(edge):
    """Flat tops (rounded values) part the rising, falling and both-edge
    maxima; their union is the reference's, with NaN holes."""
    rng = np.random.default_rng(15)
    x = np.round(np.convolve(rng.normal(size=20_000), np.hanning(7),
                             "same"), 1)
    x[[500, 7001, 7002]] = np.nan
    for mpd in (1, 10):
        np.testing.assert_array_equal(
            detect_peaks(x, mpd=mpd, edge=edge),
            jdetect_peaks(x, mpd=mpd, edge=edge))

def _peak_series(kind):
    rng = np.random.default_rng(14)
    if kind == "smooth":            # ~167,000 distinct local maxima
        return np.convolve(rng.normal(size=500_000), np.hanning(3), "same")
    if kind == "rounded":           # thousands of peaks of equal height
        return np.round(np.convolve(rng.normal(size=60_000), np.hanning(7),
                                    "same"), 1)
    if kind == "none":
        return np.linspace(0.0, 1.0, 1000)
    return np.hanning(1001)         # "one": a single maximum


@pytest.mark.parametrize("kpsh", [False, True])
@pytest.mark.parametrize("kind,mpd", [
    ("smooth", 1), ("smooth", 2), ("smooth", 250), ("smooth", 500_000),
    ("rounded", 7), ("rounded", 250), ("none", 250), ("one", 250),
])
def test_native_peak_suppression_is_the_plain_loop(kind, mpd, kpsh):
    """The native scan's keep mask is the plain loop's, bit for bit, in
    the visiting order `suppress_peaks` gives it (numpy's argsort of the
    heights, reversed)."""
    x, ind = peak_candidates(_peak_series(kind))
    assert len(ind) == {"none": 0, "one": 1}.get(kind, len(ind))
    xpos = x[ind]
    order = np.argsort(xpos)[::-1]
    keep = host_ops.peak_suppression(ind, xpos, order, mpd, kpsh)
    np.testing.assert_array_equal(
        keep, host_ops.peak_suppression_plain(ind, xpos, order, mpd, kpsh))
    assert keep.dtype == bool and keep.shape == ind.shape
    if len(ind):
        assert keep[order[0]]                   # the tallest is kept
    if kind == "smooth" and mpd > 2:
        assert 0 < keep.sum() < len(ind) // 10


def test_the_peak_suppression_raises_without_a_compiler(monkeypatch):
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        detect_peaks(_peak_series("smooth")[:5000], mpd=25)
