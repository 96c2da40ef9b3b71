"""csrc/mf.cu's index maps, mirrored on the CPU.

A torch walk of the kernel's blocks (`_emulate`) stages each channel as the
producer warpgroup does (the pre-pass's TF32 parts of the data span in
16-byte chunks at their 128-byte swizzled places, y with 8 pad words
after every 64, the block's template rows copied into zeroed rows, the
moveouts; the span and y of every stage start as NaN, so a read of a
place no copy wrote shows), gathers the `wgmma` operands as the consumers
do (A from each thread's four registers a k-step: the hi and the lo row
of one shift; B through the descriptor's rows, 32 lags apart), multiplies
by the dh and the dl span, and applies y, the mask and the network sum
through each thread's accumulator fragment.  It must reproduce
`matched_filter_plain`; the warps' shared-memory loads must be free of
bank conflicts; and the pre-pass's plain twin must give the JAX package's
window normalization.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from seismic_bpmf_tpu.ops import pallas_mf as jpmf  # noqa: E402
from seismic_bpmf_tpu_torch.ops import mf  # noqa: E402
from seismic_bpmf_tpu_torch.ops import reference as tref  # noqa: E402

T = mf.LAG_TILE
TPB = mf.BLOCK_TEMPLATES
FRONT = mf.ROW_FRONT
GFRONT = mf.SPLIT_ROW_FRONT


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The walk runs many small torch ops: one intra-op thread, so that
    they do not spin against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _swz(off):
    """Byte offset of a 16-byte chunk in the 128-byte swizzle."""
    return off ^ ((off >> 3) & 0x70)


def _threads():
    """(w, g, q) of a consumer warpgroup's 128 threads, and their shift."""
    lane = torch.arange(128)
    w, g, q = lane // 32, (lane % 32) // 4, lane % 4
    return w, g, q, 8 * w + g


def _layout(L, max_delta):
    """(K, row, span, n_y4) of `mf_layout_n`."""
    K = mf._k_taps(L)
    span = -(-(max_delta + 4 + 32 * 63 + K) // 32) * 32
    n_y4 = -(-(max_delta + 4 + T) // 4) * 4
    return K, mf._row_width(L), span, n_y4


def _a_words(tl, sft, q, dlt, row, ks):
    """Word of each thread's four A registers of k-step ks (in the stage's
    rows: hi rows 0-3, lo rows 4-7): rows 16 w + g (hi) and + 8 (lo) of
    shift sft at k = 8 ks + q and + 4."""
    hi = tl * row + FRONT + q - sft - dlt + 8 * ks
    lo = hi + TPB * row
    return torch.stack([hi, lo, hi + 4, lo + 4], -1)


def _y_words(a, sft, q):
    """Word of y (in the padded y span) each thread reads for tot[2 j + e],
    shape (128, 16), and the lag it belongs to."""
    lags = torch.empty((128, 16), dtype=torch.long)
    for j in range(8):
        for e in range(2):
            lags[:, 2 * j + e] = 256 * j + 64 * q + 32 * e + sft
    r = a + lags
    return r + 8 * (r >> 6), lags


def _emulate(plan, data_pad, stages=2):
    """The kernel's output on `plan` and `data_pad`, walked block by
    block, channel by channel through a ring of `stages` stages; also the
    16-byte phases delta its templates took."""
    L, n_tp, n_corr = plan.L, plan.n_tp, plan.n_corr_unit
    K, row, span, n_y4 = _layout(L, plan.max_delta)
    n_ks = K // 8
    KP = mf._tf32_row_width(L)
    hi, lo, yd = mf.tf32_day_plain(data_pad, L)
    ext_al = hi.shape[1]
    rows, mv_t, tile_lo = plan.filt_rows, plan.mv_table, plan.tile_lo
    w, g, q, sft = _threads()
    out = torch.full((n_tp, n_corr), float("nan"))
    y_len = n_y4 + 8 * (-(-n_y4 // 64))
    # the swizzled place (in floats) of each span element
    chunk = torch.tensor([_swz(16 * u) // 4 for u in range(span // 4)])
    phys = chunk[torch.arange(span) // 4] + torch.arange(span) % 4
    ypos = torch.arange(n_y4) + 8 * (torch.arange(n_y4) >> 6)
    deltas = set()
    for t0 in range(0, n_tp, TPB):
        tile, tt = divmod(t0, mf.TEMPLATE_TILE)
        for b0 in range(0, n_corr, T):
            ring = [dict(hi=torch.full((span,), float("nan")),
                         lo=torch.full((span,), float("nan")),
                         y=torch.full((y_len,), float("nan")),
                         f=torch.zeros(2 * TPB * row))
                    for _ in range(stages)]
            tot = torch.zeros((TPB, 128, 16))
            it = 0
            for c in range(plan.n_ch):
                lo_c = int(tile_lo[c, tile])
                if lo_c < 0:
                    continue
                st = ring[it % stages]
                it += 1
                g0 = (b0 + lo_c) & ~3
                # the producer: data parts, y, rows, moveouts
                gi = g0 + torch.arange(span)
                inside = gi < ext_al
                for name, src in (("hi", hi), ("lo", lo)):
                    st[name][phys] = torch.where(
                        inside, src[c, gi.clamp(max=ext_al - 1)],
                        torch.zeros(()))
                gy = g0 + torch.arange(n_y4)
                st["y"][ypos] = torch.where(
                    gy < ext_al, yd[c, gy.clamp(max=ext_al - 1)],
                    torch.zeros(()))
                for r in range(2 * TPB):
                    part, u = divmod(r, TPB)
                    at = r * row + FRONT - GFRONT
                    st["f"][at : at + KP] = rows[c, tile, part, tt + u]
                mvs = mv_t[c, t0 : t0 + TPB]
                # the consumers
                for tl in range(TPB):
                    mv = int(mvs[tl])
                    used = mv >= 0
                    a = b0 + mv - g0 if used else 0
                    assert 0 <= a < plan.max_delta + 4
                    dlt = a & 3
                    if used:
                        deltas.add(dlt)
                    A = torch.full((64, K), float("nan"))
                    for ks in range(n_ks):
                        wd = _a_words(tl, sft, q, dlt, row, ks)
                        for reg, (dr, dk) in enumerate(
                                ((0, 0), (8, 0), (0, 4), (8, 4))):
                            own = tl * row + (reg & 1) * TPB * row
                            assert bool(((wd[:, reg] >= own)
                                         & (wd[:, reg] < own + row)).all())
                            A[16 * w + g + dr, 8 * ks + q + dk] = (
                                st["f"][wd[:, reg]])
                    n = torch.arange(64)[None, :]
                    k = torch.arange(K)[:, None]
                    e = (a - dlt) + 32 * n + k                   # (K, 64)
                    assert int(e.max()) < span
                    D = A @ st["hi"][phys[e]] + A @ st["lo"][phys[e]]
                    if not used:
                        continue
                    assert not torch.isnan(D).any()
                    words, lags = _y_words(a, sft, q)
                    yv = st["y"][words]
                    assert not torch.isnan(yv).any()
                    v = torch.empty((128, 16))
                    for j in range(8):
                        for ee in range(2):
                            col = 8 * j + 2 * q + ee
                            v[:, 2 * j + ee] = (D[16 * w + g, col]
                                                + D[16 * w + g + 8, col])
                    p = b0 + mv + lags
                    ok = (p >= plan.lo_p) & (p <= plan.hi_p)
                    tot[tl] += torch.where(ok, v * yv, torch.zeros(()))
            for tl in range(TPB):
                if t0 + tl >= n_tp:
                    continue
                _, lags = _y_words(0, sft, q)
                b = b0 + lags
                keep = b < n_corr
                assert bool(torch.isnan(out[t0 + tl, b[keep]]).all())
                out[t0 + tl, b[keep]] = tot[tl][keep]
    return out, deltas


def _world(L, n_tp=13, n_sta=4, n_comp=3, n_samp=5000, seed=0,
           mv_range=(-31, 157)):
    rng = np.random.default_rng(seed)
    tp = rng.normal(size=(n_tp, n_sta, n_comp, L)).astype(np.float32)
    mv = rng.integers(*mv_range, size=(n_tp, n_sta, n_comp))
    w = rng.uniform(0.5, 1.5, (n_tp, n_sta, n_comp)).astype(np.float32)
    w[:, 2, 1] = 0.0                     # a channel no template uses
    w[3, 1, 2] = 0.0                     # mv = -1 on one (template, channel)
    data = rng.normal(size=(n_sta, n_comp, n_samp)).astype(np.float32)
    data[:, :, 2500:3100] = 0.0          # a zero-filled gap
    return tp, mv, w, data


@pytest.mark.parametrize("L,stages", [(200, 2), (37, 3), (45, 1)])
def test_the_tile_walk_gives_the_plain_version(L, stages):
    tp, mv, w, data = _world(L)
    plan = mf.MatchedFilterPlan(tp, mv, w, data.shape[-1],
                                precision="default", device="cpu")
    assert int((plan.tile_lo < 0).sum()) == 1        # one channel skipped
    assert int((plan.mv_table[:, : plan.n_tp] < 0).sum()) == plan.n_tp + 1
    assert plan.n_corr_unit % T and plan.n_corr_unit > 2 * T   # ragged
    assert plan.n_tp % TPB                                       # ragged
    dp = plan.pad_data(data)
    got, deltas = _emulate(plan, dp, stages=stages)
    assert deltas == {0, 1, 2, 3}        # B starts at every 16-byte phase
    want = mf.mf_cc(dp, plan.filt_rows, plan.mv_table, plan.tile_lo,
                    n_tp=plan.n_tp, L=L, n_corr=plan.n_corr_unit,
                    lo_p=plan.lo_p, hi_p=plan.hi_p, max_delta=plan.max_delta)
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert float(got[:, 2540:2740].abs().max()) == 0.0   # inside the gap


@pytest.mark.parametrize("L", [37, 200])
@pytest.mark.parametrize("dlt", range(4))
def test_the_warps_loads_are_free_of_bank_conflicts(L, dlt):
    """Every warp's A loads (each register, each k-step) touch 11
    neighbouring words of one row, so no two of its words share a bank;
    its y loads (each accumulator pair) touch 32 words in 32 banks, for
    every 16-byte phase delta of the template in the span."""
    K, row, _, _ = _layout(L, 450)
    w, g, q, sft = _threads()
    for tl in (0, 3):
        for ks in range(K // 8):
            words = _a_words(tl, sft, q, dlt, row, ks)
            for reg in range(4):
                for warp in range(4):
                    ws = words[w == warp, reg].unique()
                    assert len(ws) == 11
                    assert len(ws) == len((ws % 32).unique())
    for a in (dlt, 4 + dlt, 60 + dlt, 453):
        words, _ = _y_words(a, sft, q)
        for warp in range(4):
            for r in range(16):
                ws = words[w == warp, r]
                assert len(ws.unique()) == 32 == len((ws % 32).unique())


@pytest.mark.parametrize("L", [200, 37])
def test_the_prepass_twin_gives_the_jax_window_normalization(L):
    """`tf32_day_plain`'s y (csrc/mf_window.cuh's partial order, the same
    as `split_day_plain`'s) against the window normalization of the JAX
    package's kernels (its sliding sums and rsqrt, in interpret mode); hi
    and lo are `split_tf32` of the day, zeros past it."""
    rng = np.random.default_rng(2)
    n_ch, ext = 3, 2000
    x = rng.normal(size=(n_ch, ext)).astype(np.float32) * 3.0
    x[1, 700:1100] = 0.0
    hi, lo, y = mf.tf32_day_plain(torch.from_numpy(x), L)
    W = hi.shape[1] + 128
    assert W % 128 == 0 and hi.shape == lo.shape == y.shape == (n_ch, W - 128)
    assert hi.dtype == lo.dtype == torch.float32
    h2, l2 = mf.split_tf32(torch.from_numpy(x))
    assert torch.equal(hi[:, :ext], h2) and torch.equal(lo[:, :ext], l2)
    assert not hi[:, ext:].any() and not lo[:, ext:].any()
    assert torch.equal(y, mf.split_day_plain(torch.from_numpy(x), L)[2])

    def kern(x_ref, o_ref):
        d = x_ref[...]
        r1 = jpmf._sliding_sum(d, L, W)
        r2 = jpmf._sliding_sum(d * d, L, W)
        var = r2 - r1 * r1 * (1.0 / L)
        o_ref[...] = jnp.where(var > 1e-10,
                               jax.lax.rsqrt(jnp.abs(var) + 1e-30), 0.0)

    xp = np.zeros((8, W), np.float32)
    xp[:n_ch, :ext] = x
    want = np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((8, W), jnp.float32),
        interpret=True)(jnp.asarray(xp)))[:n_ch, : ext - L + 1]
    got = y[:, : ext - L + 1].numpy()
    assert (got[1, 700:1100 - L + 1] == 0).all()
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)


def test_smem_and_stages():
    """The ring's depth and shared memory: four stages at the main path's
    shape (L = 200, max_delta = 450), fewer at wider spans, one at the
    widest, and a span no stage holds; K = 240 and rows of 280."""
    # data hi and lo: 2,720 f32 each in 11 KB; 4 templates x 2 rows of
    # 280 f32; y: 2,504 words and 40 x 8 pads; 4 moveouts
    assert (mf._k_taps(200), mf._row_width(200)) == (240, 280)
    assert mf._stage_bytes(200, 450) == 43008 == 1024 * -(
        -(2 * 11264 + 4 * 2 * 4 * 280 + 4 * (2504 + 8 * 40) + 16) // 1024)
    assert mf.stages(200, 450) == 4
    assert mf._smem_bytes(200, 450) == 1024 + 4 * (43008 + 16)
    assert [mf.stages(200, d) for d in (2000, 6000, 9000)] == [3, 2, 1]
    assert mf._smem_bytes(200, 15000) <= mf.SMEM_LIMIT
    assert mf._smem_bytes(200, 16000) > mf.SMEM_LIMIT
    tp, mv, w, data = _world(40, n_tp=4, n_samp=3000)
    mv[1, 0, 0] = 16000
    with pytest.raises(ValueError, match="shared memory"):
        mf.MatchedFilterPlan(tp, mv, w, 20000, precision="default",
                             device="cpu")
    mf.MatchedFilterPlan(tp, mv, w, 20000, precision="high", device="cpu")


def test_the_plain_version_adds_the_lo_lo_product():
    """`matched_filter_plain` adds fl*dl as csrc/mf.cu does (the three
    products of csrc/mf_highest.cu give other bits); both lie within 1e-6
    of the float64 oracle."""
    tp, mv, w, data = _world(40, n_tp=4, n_samp=3000)
    plan = mf.MatchedFilterPlan(tp, mv, w, data.shape[-1],
                                precision="default", device="cpu")
    dp = plan.pad_data(data)
    fh, fl = mf.tf32_rows_parts(plan.filt_rows, plan.L)
    kw = dict(n_tp=plan.n_tp, L=plan.L, n_corr=plan.n_corr_unit,
              lo_p=plan.lo_p, hi_p=plan.hi_p, lag_block=4096)
    four = mf.matched_filter_plain(dp, fh, fl, plan.mv_table, **kw)
    three = mf._parts_plain(mf.split_tf32, dp, fh, fl, plan.mv_table,
                            lolo=False, **kw)
    assert torch.equal(plan(dp), four) and not torch.equal(four, three)
    exact = tref.matched_filter(tp, mv, w, data)
    for got in (four, three):
        np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=1e-6)
