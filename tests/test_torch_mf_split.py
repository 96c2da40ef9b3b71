"""csrc/mf_split.cu's index maps, mirrored on the CPU.

A torch walk of the kernel's blocks (`_emulate`) stages each channel as the
producer warp does (the data span's 16-byte chunks at their 128-byte
swizzled places, y with 8 pad words after every 128, the block's template
rows, the moveouts; every stage starts as NaN, so a read of a place no
copy wrote shows), gathers the `wgmma` operands as the consumers do (A
from each thread's four registers a k-step, B through the descriptor's
rows), multiplies, and applies y, the mask and the network sum through
each thread's accumulator fragment.  It must reproduce
`matched_filter_split_plain`; the warps' shared-memory loads must be free
of bank conflicts; and the pre-pass's plain twin must give the JAX
package's window normalization.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from seismic_bpmf_tpu.ops import pallas_mf as jpmf  # noqa: E402
from seismic_bpmf_tpu_torch.ops import mf  # noqa: E402

T = mf.SPLIT_LAG_TILE
TPB = mf.SPLIT_BLOCK_TEMPLATES
OFF = mf.SPLIT_ROW_OFF


def _swz(off):
    """Byte offset of a 16-byte chunk in the 128-byte swizzle."""
    return off ^ ((off >> 3) & 0x70)


def _threads():
    """(w, g, q) of a consumer warpgroup's 128 threads, and row m."""
    lane = torch.arange(128)
    w, g, q = lane // 32, (lane % 32) // 4, lane % 4
    return w, g, q, 16 * w + g


def _layout(L, max_delta):
    K = mf._split_k(L)
    span = -(-(max_delta + 8 + T - 64 + K) // 64) * 64
    n_y4 = -(-(max_delta + 8 + T) // 4) * 4
    return K, mf._split_row_width(L), span, n_y4


def _a_words(m, q, dlt, row, ks):
    """Word index (in a template's staged rows) of each thread's four A
    registers of k-step ks, hi part: rows m, m + 8 at k = 16 ks + 2q and
    + 8."""
    par = (m + dlt) & 1
    x0 = 2 * q - m - dlt + OFF - par
    base = par * (row // 2) + x0 // 2 + 8 * ks
    return torch.stack([base, base - 4, base + 4, base], -1)


def _y_words(a, m, q):
    """Word of y (in the padded y span) each thread reads for acc[4 j + 2 h
    + e], shape (128, 32), and the lag it belongs to."""
    words = torch.empty((128, 32), dtype=torch.long)
    lags = torch.empty((128, 32), dtype=torch.long)
    for j in range(8):
        for h in range(2):
            for e in range(2):
                r = a + m + 8 * h + 64 * e
                words[:, 4 * j + 2 * h + e] = (r + 8 * (r >> 7) + 136 * q
                                               + 544 * j)
                lags[:, 4 * j + 2 * h + e] = (512 * j + 128 * q + 64 * e + m
                                              + 8 * h)
    return words, lags


def _emulate(plan, data_pad, stages=2):
    """The kernel's output on `plan` and `data_pad`, walked block by
    block, channel by channel through a ring of `stages` stages."""
    L, n_tp, n_corr = plan.L, plan.n_tp, plan.n_corr_unit
    K, row, span, n_y4 = _layout(L, plan.max_delta)
    n_ks = K // 16
    hi, lo, yd = mf.split_day_plain(data_pad, L)
    ext_al = hi.shape[1]
    rows = plan.filt_rows.reshape(plan.n_ch, plan.mv_table.shape[1], -1)
    mv_t, tile_lo = plan.mv_table, plan.tile_lo
    w, g, q, m = _threads()
    out = torch.full((n_tp, n_corr), float("nan"))
    y_len = n_y4 + 8 * (-(-n_y4 // 128))
    for t0 in range(0, n_tp, TPB):
        tile = t0 // mf.TEMPLATE_TILE
        for b0 in range(0, n_corr, T):
            ring = [dict(hi=torch.full((span,), float("nan")),
                         lo=torch.full((span,), float("nan")),
                         y=torch.full((y_len,), float("nan")))
                    for _ in range(stages)]
            tot = torch.zeros((TPB, 128, 32))
            it = 0
            for c in range(plan.n_ch):
                lo_c = int(tile_lo[c, tile])
                if lo_c < 0:
                    continue
                st = ring[it % stages]
                it += 1
                g0 = (b0 + lo_c) & ~7
                # the producer: data parts, y, rows, moveouts
                for u in range(span // 8):
                    gi = g0 + 8 * u
                    p = _swz(16 * u) // 2
                    for name, src in (("hi", hi), ("lo", lo)):
                        st[name][p : p + 8] = (
                            src[c, gi : gi + 8].float() if gi < ext_al
                            else torch.zeros(8))
                for u in range(n_y4 // 4):
                    gi = g0 + 4 * u
                    p = 4 * u + 8 * (u >> 5)
                    st["y"][p : p + 4] = (yd[c, gi : gi + 4] if gi < ext_al
                                          else torch.zeros(4))
                f_rows = rows[c, t0 : t0 + TPB].float()   # (TPB, 4 row)
                mvs = mv_t[c, t0 : t0 + TPB]
                # the consumers
                for tl in range(TPB):
                    mv = int(mvs[tl])
                    if mv < 0:
                        continue
                    a = b0 + mv - g0
                    assert 0 <= a < plan.max_delta + 8
                    dlt = a & 7
                    fw = f_rows[tl]
                    A = {}
                    for part in (0, 1):
                        Ap = torch.full((64, K), float("nan"))
                        for ks in range(n_ks):
                            wd = _a_words(m, q, dlt, row, ks) + part * row
                            for reg, (dr, dk) in enumerate(
                                    ((0, 0), (8, 0), (0, 8), (8, 8))):
                                for i in (0, 1):
                                    Ap[m + dr, 16 * ks + 2 * q + dk + i] = (
                                        fw[2 * wd[:, reg] + i])
                        A[part] = Ap
                    n = torch.arange(64)[None, :]
                    k = torch.arange(K)[:, None]
                    e = (a - dlt) + 64 * n + k                   # (K, 64)
                    phys = torch.tensor(
                        [_swz(16 * int(x)) // 2 for x in range(span // 8)]
                    )[e // 8] + e % 8
                    B = {name: st[name][phys] for name in ("hi", "lo")}
                    D = (A[0] @ B["hi"] + A[0] @ B["lo"] + A[1] @ B["hi"])
                    assert not torch.isnan(D).any()
                    words, lags = _y_words(a, m, q)
                    acc = torch.empty((128, 32))
                    for j in range(8):
                        for h in range(2):
                            for ee in range(2):
                                acc[:, 4 * j + 2 * h + ee] = D[
                                    m + 8 * h, 8 * j + 2 * q + ee]
                    yv = st["y"][words]
                    assert not torch.isnan(yv).any()
                    p = b0 + mv + lags
                    ok = (p >= plan.lo_p) & (p <= plan.hi_p)
                    tot[tl] += torch.where(ok, acc * yv, torch.zeros(()))
            for tl in range(TPB):
                if t0 + tl >= n_tp:
                    continue
                _, lags = _y_words(0, m, q)
                b = b0 + lags
                keep = b < n_corr
                out[t0 + tl, b[keep]] = tot[tl][keep]
    return out


def _world(L, n_tp=13, n_sta=4, n_comp=3, n_samp=9000, seed=0,
           mv_range=(-31, 157)):
    rng = np.random.default_rng(seed)
    tp = rng.normal(size=(n_tp, n_sta, n_comp, L)).astype(np.float32)
    mv = rng.integers(*mv_range, size=(n_tp, n_sta, n_comp))
    mv[:, 0, 0] = mv[0, 0, 0] | 1                       # odd, shared
    w = rng.uniform(0.5, 1.5, (n_tp, n_sta, n_comp)).astype(np.float32)
    w[:, 2, 1] = 0.0                     # a channel no template uses
    w[3, 1, 2] = 0.0                     # mv = -1 on one (template, channel)
    data = rng.normal(size=(n_sta, n_comp, n_samp)).astype(np.float32)
    data[:, :, 4000:4600] = 0.0          # a zero-filled gap
    return tp, mv, w, data


@pytest.mark.parametrize("L,stages", [(200, 2), (37, 3)])
def test_the_tile_walk_gives_the_plain_version(L, stages):
    tp, mv, w, data = _world(L)
    plan = mf.MatchedFilterPlan(tp, mv, w, data.shape[-1], precision="high",
                                device="cpu")
    assert int((plan.tile_lo < 0).sum()) == 1        # one channel skipped
    assert int((plan.mv_table[:, : plan.n_tp] < 0).sum()) == plan.n_tp + 1
    assert plan.n_corr_unit % T and plan.n_corr_unit > 2 * T   # ragged
    dp = plan.pad_data(data)
    got = _emulate(plan, dp, stages=stages)
    want = mf.mf_cc_split(dp, plan.filt_rows, plan.mv_table, plan.tile_lo,
                          n_tp=plan.n_tp, L=L, n_corr=plan.n_corr_unit,
                          lo_p=plan.lo_p, hi_p=plan.hi_p,
                          max_delta=plan.max_delta)
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert float(got[:, 4040:4240].abs().max()) == 0.0   # inside the gap


@pytest.mark.parametrize("L", [37, 200])
@pytest.mark.parametrize("dlt", range(8))
def test_the_warps_loads_are_free_of_bank_conflicts(L, dlt):
    """Every warp's A loads (each register, each k-step) and y loads (each
    accumulator) touch each bank with one word at most, for every 16-byte
    phase delta of the template in the span."""
    K, row, _, _ = _layout(L, 450)
    w, g, q, m = _threads()
    for ks in range(K // 16):
        words = _a_words(m, q, dlt, row, ks)
        for reg in range(4):
            for warp in range(4):
                ws = words[w == warp, reg].unique()
                assert len(ws) == len((ws % 32).unique())
    for a in (dlt, 8 + dlt, 120 + dlt, 455):
        words, _ = _y_words(a, m, q)
        for warp in range(4):
            for r in range(32):
                ws = words[w == warp, r]
                assert len(ws.unique()) == 32 == len((ws % 32).unique())


@pytest.mark.parametrize("L", [200, 37])
def test_the_prepass_twin_gives_the_jax_window_normalization(L):
    """`split_day_plain`'s y (csrc/mf_window.cuh's partial order) against
    the window normalization of the JAX package's kernels (its sliding
    sums and rsqrt, in interpret mode); hi and lo are `split_bf16`."""
    rng = np.random.default_rng(1)
    n_ch, ext = 3, 2000
    x = rng.normal(size=(n_ch, ext)).astype(np.float32) * 3.0
    x[1, 700:1100] = 0.0
    hi, lo, y = mf.split_day_plain(torch.from_numpy(x), L)
    W = hi.shape[1] + 128
    assert W % 128 == 0 and hi.shape == lo.shape == y.shape == (n_ch, W - 128)
    h2, l2 = mf.split_bf16(torch.from_numpy(x))
    assert torch.equal(hi[:, :ext], h2) and torch.equal(lo[:, :ext], l2)
    assert not hi[:, ext:].float().any() and not lo[:, ext:].float().any()

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


def test_split_smem_and_stages():
    """The ring's depth and shared memory: three stages at the main path's
    shape (L = 200, max_delta = 450) and at wider spans, one stage at the
    widest, and a span no stage holds."""
    # data hi and lo: 4,800 bf16 each in 10 KB; 4 templates x 4 rows of
    # 352 bf16; y: 4,556 words and 36 x 8 pads; 4 moveouts
    assert mf._split_stage_bytes(200, 450) == 51200 == 1024 * -(
        -(2 * 10240 + 4 * 8 * 352 + 4 * (4556 + 8 * 36) + 16) // 1024)
    assert mf.split_stages(200, 450) == 3
    assert mf._split_smem_bytes(200, 450) == 1024 + 3 * (51200 + 16)
    assert [mf.split_stages(200, d) for d in (2000, 3000, 9000)] == [3, 3, 1]
    assert mf._split_smem_bytes(200, 9000) <= mf.SMEM_LIMIT
    assert mf._split_smem_bytes(200, 30000) > mf.SMEM_LIMIT
