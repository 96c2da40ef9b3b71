"""csrc/mf.cu's index maps and both its builds' sums, mirrored on the CPU.

A torch walk of the kernel's blocks (`_emulate`) stages each channel as the
producer warpgroup does (the pre-pass's TF32 parts of the data span in
16-byte chunks at their 128-byte swizzled places, y with 8 pad words
after every 64, the block's template rows copied into zeroed rows, the
moveouts; the span and y of every stage start as NaN, so a read of a
place no copy wrote shows), gathers the `wgmma` operands as the consumers
do (A from each thread's four registers a k-step: the hi and the lo row
of one shift; B through the descriptor's rows, 32 lags apart), multiplies
by the dh and the dl span, and applies y, the mask and the network sum
through each thread's accumulator fragment; for the 'highest' build it
sums the k-steps in the groups and the order of that build's partial walk
(`_partial_walk`).  It must reproduce `matched_filter_plain`; the warps'
shared-memory loads must be free of bank conflicts; and the pre-pass's
plain twin must give the JAX package's window normalization.  A numpy
model of the tensor cores' truncating additions (`_cc_model`) shows why the
'highest' build sums its partials outside them: at a planted repeat the
partials stay within the rung's 1e-6 of the float64 oracle, one
accumulator carried through the k-steps does not.
"""

import re


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
G = mf.HIGHEST_PARTIAL_STEPS
ATOL_HIGHEST = 1e-6         # the 'highest' rung against the float64 oracle


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


def _partial_walk(n_ks, g):
    """What a consumer warpgroup of the 'highest' build does with its
    template on one stage, in csrc/mf.cu's order (MF_PARTIAL): for each
    group of `g` k-steps (then one k-step a group) ("issue", products) with
    products [(k-step, "dl" or "dh", scale-d)], ("wait", 0) and ("add",)."""
    ev = []
    n_grp = n_ks // g
    for ks, nk in ([(g * i, g) for i in range(n_grp)]
                   + [(k, 1) for k in range(g * n_grp, n_ks)]):
        ev.append(("issue", [p for k in range(ks, ks + nk)
                             for p in ((k, "dl", int(k > ks)),
                                       (k, "dh", 1))]))
        ev += [("wait", 0), ("add",)]
    return ev


def _play(walk):
    """Runs a walk as the tensor cores would: groups complete in the order
    they were committed, `wait n` leaves the newest n in flight.  Checks
    that no partial is read while a group is in flight (ptxas would
    serialize the products) and none is overwritten before it was added;
    returns the groups (their products) in the order they were added."""
    flight, done, added = [], [], []
    for e in walk:
        if e[0] == "issue":
            assert not done
            flight.append(e[1])
        elif e[0] == "wait":
            while len(flight) > e[1]:
                done.append(flight.pop(0))
        else:
            assert not flight and len(done) == 1
            added.append(done.pop())
    assert not flight and not done
    return added


def _emulate(plan, data_pad, stages=2, build="default"):
    """The kernel's output on `plan` and `data_pad`, walked block by
    block, channel by channel through a ring of `stages` stages; also the
    16-byte phases delta its templates took.  `build` 'highest' sums each
    template's products as its consumer's partial walk does."""
    L, n_tp, n_corr = plan.L, plan.n_tp, plan.n_corr_unit
    K, row, span, n_y4 = _layout(L, plan.max_delta)
    n_ks = K // 8
    KP = mf._tf32_row_width(L)
    groups = _play(_partial_walk(n_ks, G))
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
                    if build == "highest":
                        # each group summed from zero, then added into
                        # the running sum
                        D = torch.zeros((64, 64))
                        for prods in groups:
                            part = torch.zeros((64, 64))
                            for ks, name, _ in prods:
                                k = slice(8 * ks, 8 * ks + 8)
                                b = st[{"dh": "hi", "dl": "lo"}[name]]
                                part = part + A[:, k] @ b[phys[e[k]]]
                            D = D + part
                    else:
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


@pytest.mark.parametrize("L,stages,build", [
    (200, 2, "default"), (37, 3, "default"), (45, 1, "default"),
    (200, 2, "highest"), (45, 3, "highest")])
def test_the_tile_walk_gives_the_plain_version(L, stages, build):
    tp, mv, w, data = _world(L)
    plan = mf.MatchedFilterPlan(tp, mv, w, data.shape[-1],
                                precision=build, device="cpu")
    assert int((plan.tile_lo < 0).sum()) == 1        # one channel skipped
    assert int((plan.mv_table[:, : plan.n_tp] < 0).sum()) == plan.n_tp + 1
    assert plan.n_corr_unit % T and plan.n_corr_unit > 2 * T   # ragged
    assert plan.n_tp % TPB                                       # ragged
    dp = plan.pad_data(data)
    got, deltas = _emulate(plan, dp, stages=stages, build=build)
    assert deltas == {0, 1, 2, 3}        # B starts at every 16-byte phase
    wrapper = mf.mf_cc_highest if build == "highest" else mf.mf_cc
    want = wrapper(dp, plan.filt_rows, plan.mv_table, plan.tile_lo,
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
    """`matched_filter_plain` adds fl*dl as both builds of csrc/mf.cu do
    (the three products fh*dh + fh*dl + fl*dh give other bits); both lie
    within 1e-6 of the float64 oracle."""
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


# --------------------------------------------------------------------------
# the 'highest' build: its partial walk, its registers, and why it sums
# outside the tensor cores
@pytest.mark.parametrize("n_ks, g", [(30, G), (30, 5), (30, 6), (11, 2),
                                     (7, 5)])
def test_the_partial_walk_covers_each_k_step_once(n_ks, g):
    """The groups are the template's k-steps in order, `g` a group and then
    one a group, each started by B = dl with scale-d 0 and each k-step's dl
    product before its dh product; every partial is added once, after the
    wait for its group and with nothing in flight (`_play`)."""
    groups = _play(_partial_walk(n_ks, g))
    n_grp = n_ks // g
    assert [sorted({ks for ks, _, _ in prods}) for prods in groups] == (
        [list(range(g * i, g * i + g)) for i in range(n_grp)]
        + [[ks] for ks in range(g * n_grp, n_ks)])
    for prods in groups:
        assert [(n, sd) for _, n, sd in prods[:2]] == [("dl", 0), ("dh", 1)]
        assert all(sd == 1 for _, _, sd in prods[1:])
        assert prods == sorted(prods, key=lambda p: (p[0], p[1] == "dh"))


def test_the_highest_build_stages_what_the_default_build_does():
    """The 'highest' build's layout and threads are the default build's
    (one ring, one `_smem_bytes`; 128 producer threads at 32 registers and
    four consumer warpgroups at 112 fill the 96 a thread that ptxas gives
    640 threads); a consumer's f32 state (the sum, the partial, the
    network sum and two sets of A operands) leaves room for its addresses;
    ops.mf mirrors the source's default group size."""
    with open(mf.__file__.replace("ops/mf.py", "csrc/mf.cu")) as f:
        text = f.read()

    def define(name):
        return int(re.search(rf"^#define {name} (\d+)", text, re.M)[1])

    assert define("MF_ACC_G") == G == 2
    cwg, prod, cons = (define(n) for n in ("MF_CWG", "MF_PRODUCER_REGS",
                                           "MF_CONSUMER_REGS"))
    threads = 128 * (cwg + 1)
    assert (cwg, 65536 // threads // 8 * 8) == (4, 96)
    assert 128 * prod + 128 * cwg * cons == 96 * threads
    assert 32 + 32 + 16 + 2 * 4 == 88 <= cons - 16    # sum, part, tot, A
    assert mf._smem_bytes(200, 450) == 1024 + 4 * (43008 + 16)
    tp, mv, w, data = _world(40, n_tp=4, n_samp=3000)
    plans = [mf.MatchedFilterPlan(tp, mv, w, data.shape[-1], precision=p,
                                  device="cpu") for p in ("highest",
                                                          "default")]
    assert torch.equal(plans[0].filt_rows, plans[1].filt_rows)
    assert plans[0].max_delta == plans[1].max_delta


def _toward_zero(x: float) -> np.float32:
    """x rounded to f32 toward zero, as the tensor cores' additions."""
    f = np.float32(x)
    return np.nextafter(f, np.float32(0)) if abs(float(f)) > abs(x) else f


def _planted_repeat(seed=0, n_sta=10, n_comp=3, L=200, n_samp=3000):
    """One template planted at 10 times the noise: every product of a
    channel has one sign."""
    rng = np.random.default_rng(seed)
    tp = rng.normal(size=(1, n_sta, n_comp, L)).astype(np.float32)
    mv = rng.integers(-50, 400, size=(1, n_sta, n_comp))
    w = np.full((1, n_sta, n_comp), 1.0 / (n_sta * n_comp), np.float32)
    data = rng.normal(size=(n_sta, n_comp, n_samp)).astype(np.float32)
    lag = 1000 + int(rng.integers(0, 64))
    for s in range(n_sta):
        for c in range(n_comp):
            st = lag + mv[0, s, c]
            data[s, c, st : st + L] += 10.0 * tp[0, s, c]
    return tp, mv, w, data, lag


def _cc_model(tp, mv, w, data, lag, g=None):
    """CC of the planted template at `lag` as csrc/mf.cu sums it, in numpy:
    each channel's taps at the shift and 16-byte phase its lag takes in the
    kernel's blocks, every k-step's 8 products summed exactly and added
    into an f32 sum truncated toward zero (the tensor cores), the hi and lo
    rows apart, y and the network sum in round-to-nearest f32.  `g` None:
    one accumulator carried through all k-steps, B = dh then dl (the
    'default' build); else the 'highest' build's partial walk with `g`
    k-steps a group, each partial from zero and added in round-to-nearest
    f32."""
    plan = mf.MatchedFilterPlan(tp, mv, w, data.shape[-1], device="cpu")
    L, dp = plan.L, plan.pad_data(data)
    n_ks = mf._k_taps(L) // 8
    fh, fl = (f.double().numpy() for f in mf.tf32_rows_parts(plan.filt_rows,
                                                               L))
    dh, dl, y = mf.tf32_day_plain(dp, L)
    d = {"dh": dh.double().numpy(), "dl": dl.double().numpy()}
    if g is not None:
        groups = _play(_partial_walk(n_ks, g))
    b0 = lag // T * T
    tot = np.float32(0)
    for c in range(plan.n_ch):
        m = int(plan.mv_table[c, 0])
        a = b0 + m - ((b0 + int(plan.tile_lo[c, 0])) & ~3)
        off = (lag - b0) % 32 + (a & 3)      # tap j sits at k = j + off
        p = lag + m
        rows = []
        for f in (fh[c, 0], fl[c, 0]):
            A = np.zeros(8 * n_ks)
            A[off : off + L] = f[:L]
            B = {}
            for name, x in d.items():
                B[name] = np.zeros(8 * n_ks)
                B[name][off : off + L] = x[c, p : p + L]

            def prod(ks, name):
                return float(A[8 * ks : 8 * ks + 8] @ B[name][8 * ks : 8 * ks + 8])

            if g is None:
                acc = np.float32(0)
                for ks in range(n_ks):
                    for name in ("dh", "dl"):
                        acc = _toward_zero(float(acc) + prod(ks, name))
            else:
                acc = np.float32(0)
                for prods in groups:
                    part = np.float32(0)
                    for ks, name, _ in prods:
                        part = _toward_zero(float(part) + prod(ks, name))
                    acc = np.float32(acc + part)
            rows.append(acc)
        tot = np.float32(tot + np.float32(rows[0] + rows[1]) * y[c, p].item())
    return float(tot)


@pytest.mark.parametrize("g", [G, 5, 6])
def test_partials_summed_outside_the_tensor_cores_meet_the_gate(g):
    """At a planted repeat the 'highest' build's sums (each group of `g`
    k-steps truncated at its own scale, the partials added to nearest)
    stay within the rung's 1e-6 of the float64 oracle."""
    tp, mv, w, data, lag = _planted_repeat()
    exact = float(tref.matched_filter_at(tp[0], mv[0], w[0], data,
                                         np.array([lag]))[0])
    assert exact > 0.99
    assert abs(_cc_model(tp, mv, w, data, lag, g) - exact) < ATOL_HIGHEST / 3


def test_one_truncating_accumulator_misses_the_gate():
    """The same model with one accumulator through a channel's 60
    products loses a little at each, always toward zero: more than the
    'highest' rung's 1e-6 at the same repeat, and below the oracle."""
    tp, mv, w, data, lag = _planted_repeat()
    exact = float(tref.matched_filter_at(tp[0], mv[0], w[0], data,
                                         np.array([lag]))[0])
    assert _cc_model(tp, mv, w, data, lag) < exact - ATOL_HIGHEST
