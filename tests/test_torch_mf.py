"""The port's matched filter (`seismic_bpmf_tpu_torch.ops.mf`) against the
JAX package's Pallas kernel (interpret mode) and the NumPy oracle.

On the CPU the port runs the kernel's plain PyTorch version; the CUDA
kernel itself is compared with it on a card by tests/test_torch_cuda.py
and chip_smoke.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seismic_bpmf_tpu.ops import matched_filter as jmf_engine  # noqa: E402
from seismic_bpmf_tpu.ops import reference as jref  # noqa: E402
from seismic_bpmf_tpu.ops.pallas_mf import (  # noqa: E402
    PallasMatchedFilterPlan, _split_bf16, matched_filter_pallas,
)

from seismic_bpmf_tpu_torch.ops import matched_filter as tmf_engine  # noqa: E402
from seismic_bpmf_tpu_torch.ops import mf  # noqa: E402
from seismic_bpmf_tpu_torch.ops import reference as tref  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5  # the f32 gate of the JAX package's kernel tests
# the JAX package's gate of the `high` rung against the oracle
# (tests/test_pallas.py): both sides sum the same three bf16 products in
# f32, in different orders, and drop the lo*lo term (~2^-18 of a product)
ATOL_HIGH = 5e-6


def _bank(seed, n_tp=5, n_sta=3, n_comp=2, L=40, n_samp=1500,
          mv_range=(-30, 200)):
    rng = np.random.default_rng(seed)
    tp = rng.normal(size=(n_tp, n_sta, n_comp, L)).astype(np.float32)
    mv = rng.integers(*mv_range, size=(n_tp, n_sta, n_comp)).astype(np.int32)
    w = rng.uniform(0.1, 1, size=(n_tp, n_sta, n_comp)).astype(np.float32)
    w /= w.sum(axis=(1, 2), keepdims=True)
    data = rng.normal(size=(n_sta, n_comp, n_samp)).astype(np.float32)
    return tp, mv, w, data


def _scaled_rows(tp, w, n_tp_pad, width):
    """The plan's f32 rows, (n_ch, n_tp_pad, width): each template channel
    demeaned and scaled by weight over norm, zero-padded."""
    n_tp, n_sta, n_comp, L = tp.shape
    flat = tp.reshape(n_tp, n_sta * n_comp, L)
    dm = flat - flat.mean(-1, keepdims=True)
    norm = np.sqrt((dm.astype(np.float64) ** 2).sum(-1)).astype(np.float32)
    wf = w.reshape(n_tp, -1)
    scale = np.where(norm > 0, wf / np.maximum(norm, 1e-30), 0.0)
    rows = np.zeros((n_sta * n_comp, n_tp_pad, width), np.float32)
    rows[:, :n_tp, :L] = np.transpose(
        (dm * scale[:, :, None]).astype(np.float32), (1, 0, 2))
    return rows


def _negative_moveouts(seed):
    return _bank(seed)


def _zero_variance(seed):
    tp, mv, w, data = _bank(seed, mv_range=(0, 60))
    data[:, :, 400:700] = 0.0        # a zero-filled gap
    data[1, 0, 900:1100] = 2.5       # a constant (zero-variance) stretch
    return tp, mv, w, data


def _out_of_bounds(seed):
    # moveouts near the day's length: most lags leave the data
    return _bank(seed, n_samp=900, mv_range=(-400, 700))


def _dead_channels(seed):
    tp, mv, w, data = _bank(seed)
    w[0, 1] = 0.0                    # zero-weight station
    tp[1, 2, 0] = 7.0                # zero-norm template channel
    data[0, 0] = 0.0                 # dead data channel
    return tp, mv, w, data


CASES = {
    "negative_moveouts": _negative_moveouts,
    "zero_variance_windows": _zero_variance,
    "out_of_bounds_lags": _out_of_bounds,
    "dead_channels": _dead_channels,
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_and_oracle(case):
    tp, mv, w, data = CASES[case](7)
    got = mf.matched_filter(tp, mv, w, data, device="cpu").numpy()
    pallas = np.asarray(matched_filter_pallas(tp, mv, w, data,
                                              lag_block=512, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, jref.matched_filter(tp, mv, w, data),
                               rtol=RTOL, atol=ATOL)


def test_zero_gap_gives_exact_zero():
    tp, mv, w, data = _zero_variance(8)
    cc = mf.matched_filter(tp, mv, w, data, device="cpu").numpy()
    # every channel's window lies inside the gap: CC is 0, not noise
    assert np.all(cc[:, 400:700 - 60 - tp.shape[-1]] == 0.0)


@pytest.mark.parametrize("step", [2, 3])
def test_step(step):
    tp, mv, w, data = _bank(9, mv_range=(0, 40))
    got = mf.matched_filter(tp, mv, w, data, step=step, device="cpu").numpy()
    pallas = np.asarray(matched_filter_pallas(
        tp, mv, w, data, step=step, lag_block=512, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got, jref.matched_filter(tp, mv, w, data, step=step),
        rtol=RTOL, atol=ATOL)


def test_template_chunks_and_rungs():
    """Plans cut the bank into chunks; 'highest' and 'default' run the
    same f32-class computation (TF32 parts), 'high' the bf16-split one: a
    coarser split, so its result differs, inside its gate."""
    tp, mv, w, data = _bank(10, n_tp=9)
    full = mf.matched_filter(tp, mv, w, data, device="cpu").numpy()
    for prec in ("highest", "default"):
        got = mf.matched_filter(tp, mv, w, data, precision=prec,
                                device="cpu").numpy()
        np.testing.assert_array_equal(got, full)
    high = mf.matched_filter(tp, mv, w, data, precision="high",
                             device="cpu").numpy()
    assert np.abs(high - full).max() > 0
    oracle = jref.matched_filter(tp, mv, w, data)
    np.testing.assert_allclose(high, oracle, rtol=0, atol=ATOL_HIGH)
    np.testing.assert_allclose(full, oracle, rtol=RTOL, atol=ATOL)
    chunked = mf.matched_filter(tp, mv, w, data, template_chunk=4,
                                device="cpu").numpy()
    np.testing.assert_allclose(chunked, full, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="precision"):
        mf.MatchedFilterPlan(tp, mv, w, data.shape[-1], precision="screen",
                             device="cpu")


def test_insufficient_overrides_fail_loud():
    tp, mv, w, data = _bank(11, mv_range=(-30, 60))
    mv[0, 0, 0] = -30
    with pytest.raises(ValueError, match="pad_left"):
        mf.MatchedFilterPlan(tp, mv, w, data.shape[-1], pad_left=10,
                             device="cpu")
    mv[0, 0, 0] = 59
    with pytest.raises(ValueError, match="max_moveout"):
        mf.MatchedFilterPlan(tp, mv, w, data.shape[-1], max_moveout=40,
                             device="cpu")
    # a bank whose moveout span cannot fit one kernel tile raises
    mv_wide = mv.copy()
    mv_wide[1, 0, 0] = 200000
    with pytest.raises(ValueError, match="shared memory"):
        mf.MatchedFilterPlan(tp, mv_wide, w, 300000, device="cpu")


def test_shared_layout_overrides():
    """Plans built with the bank-wide overrides consume one padded layout
    and give the same CC as a plan sized to its own chunk."""
    tp, mv, w, data = _bank(12)
    n_samp = data.shape[-1]
    pad_left, max_mv = int(-min(0, mv.min())), int(mv.max())
    plan = mf.MatchedFilterPlan(tp[:2], mv[:2], w[:2], n_samp,
                                pad_left=pad_left, max_moveout=max_mv,
                                device="cpu")
    assert mf.MatchedFilterPlan.data_layout(
        n_samp, tp.shape[-1], pad_left, max_mv) == (plan.pad_left, plan.ext)
    own = mf.MatchedFilterPlan(tp[:2], mv[:2], w[:2], n_samp, device="cpu")
    np.testing.assert_allclose(plan(plan.pad_data(data)).numpy(),
                               own(own.pad_data(data)).numpy(),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="layout"):
        plan(plan.pad_data(data)[:, 1:])


def test_bf16_upload_rounds_like_ml_dtypes():
    """The `screen` upload rounds on the host with torch's
    round-to-nearest-even; it must equal ml_dtypes' bf16 bit for bit,
    ties and tiny values included."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    rng = np.random.default_rng(13)
    n_ch, n_samp = 2, 4096
    x = (rng.normal(size=(n_ch, n_samp))
         * 10.0 ** rng.integers(-40, 30, size=(n_ch, n_samp))).astype(
        np.float32)
    bits = x.view(np.uint32)
    bits[0, :512] = (bits[0, :512] & 0xFFFF0000) | 0x8000   # exact ties
    bits[1, :256] = rng.integers(0, 1 << 23, 256)           # subnormals
    pad = mf.pad_day_data(x, n_ch, n_samp, pad_left=3, ext=n_samp + 3,
                          dtype="bfloat16", device="cpu")
    assert pad.dtype == torch.float32
    want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(pad[:, 3:].numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert np.all(pad[:, :3].numpy() == 0.0)


def test_oracle_copies_match():
    tp, mv, w, data = _bank(14, n_tp=2, L=24, n_samp=400)
    np.testing.assert_array_equal(tref.matched_filter(tp, mv, w, data),
                                  jref.matched_filter(tp, mv, w, data))
    idx = np.array([0, 3, 100, 376])
    np.testing.assert_array_equal(
        tref.matched_filter_at(tp[1], mv[1], w[1], data, idx),
        jref.matched_filter_at(tp[1], mv[1], w[1], data, idx))


def test_cuda_tensors_never_take_the_plain_version():
    """The wrapper dispatches on the tensor's device: a non-CPU tensor
    launches the kernel or raises (here: a device it has no kernel for)."""
    tp, mv, w, data = _bank(15, n_tp=2)
    plan = mf.MatchedFilterPlan(tp, mv, w, data.shape[-1], device="cpu")
    meta = lambda t: t.to("meta")  # noqa: E731
    calls = mf.matched_filter_plain.calls
    with pytest.raises(ValueError, match="device"):
        mf.mf_cc(meta(plan.pad_data(data)), meta(plan.filt_rows),
                 meta(plan.mv_table), meta(plan.tile_lo), n_tp=plan.n_tp,
                 L=plan.L, n_corr=plan.n_corr_unit, lo_p=plan.lo_p,
                 hi_p=plan.hi_p, max_delta=plan.max_delta)
    assert mf.matched_filter_plain.calls == calls


def _planted_repeats(seed, n_tp=4, n_sta=10, n_comp=3, L=200,
                     n_samp=12000, per_template=3):
    """A day of Gaussian noise with each template's waveform planted
    `per_template` times at its moveouts (CC ~0.98), and the planted lags:
    the shape where every channel's products near a detection share one
    sign."""
    rng = np.random.default_rng(seed)
    mv = rng.integers(0, 400, size=(n_tp, n_sta, n_comp))
    wave = (8.0 * rng.normal(size=(n_tp, n_sta, n_comp, L))
            * np.hanning(L)).astype(np.float32)
    w = np.full((n_tp, n_sta, n_comp), 1.0 / (n_sta * n_comp), np.float32)
    data = rng.standard_normal((n_sta, n_comp, n_samp), dtype=np.float32)
    lags = np.stack([200 + 2800 * np.arange(per_template) + 700 * i
                     for i in range(n_tp)])
    for i in range(n_tp):
        for o in lags[i]:
            for s in range(n_sta):
                for c in range(n_comp):
                    st = o + mv[i, s, c]
                    data[s, c, st : st + L] += wave[i, s, c]
    return wave, mv, w, data, lags


def test_highest_plain_is_exact_at_planted_repeats():
    """The 'highest' rung's arithmetic (the products of TF32 parts, f32
    sums) lies within 5e-7 of the float64 oracle at every planted repeat:
    the split is exact enough, so what the kernel's 'highest' build must
    repair is how the tensor cores accumulate, not the split."""
    tp, mv, w, data, lags = _planted_repeats(41)
    got = mf.matched_filter(tp, mv, w, data, precision="highest",
                            device="cpu").numpy()
    worst = 0.0
    for i in range(tp.shape[0]):
        exact = jref.matched_filter_at(tp[i], mv[i], w[i], data, lags[i])
        assert np.all(exact > 0.95)
        worst = max(worst, float(np.abs(got[i, lags[i]] - exact).max()))
    assert worst < 5e-7, worst


@pytest.mark.parametrize("precision, route", [
    ("highest", "mf_cc_highest"), ("default", "mf_cc"),
    ("screen", "mf_cc"), ("high", "mf_cc_split")])
def test_rungs_route_to_their_builds(monkeypatch, precision, route):
    """Each rung reaches its kernel's wrapper through the engine: 'highest'
    csrc/mf.cu's 'highest' build, 'default' and 'screen' its default build,
    'high' csrc/mf_split.cu; no other."""
    from seismic_bpmf_tpu_torch.detection import MatchedFilter
    from seismic_bpmf_tpu_torch.config import Config
    from seismic_bpmf_tpu_torch.data import TemplateGroup

    seen = []
    for name in ("mf_cc", "mf_cc_highest", "mf_cc_split"):
        orig = getattr(mf, name)

        def rec(*a, _name=name, _orig=orig, **k):
            seen.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(mf, name, rec)
    tp, mv, w, data = _bank(42, n_tp=3, n_sta=4, n_comp=3, L=30,
                            n_samp=4000, mv_range=(0, 40))
    tg = TemplateGroup.from_arrays(tp, mv, ["0", "1", "2"],
                                   ["A", "B", "C", "D"], sampling_rate=25.0)
    eng = MatchedFilter(tg, cfg=Config(data_buffer_sec=0.0,
                                       sampling_rate_hz=25.0),
                        precision=precision, device="cpu", min_channels=3,
                        min_stations=2, max_kurto=1e6)
    eng.set_data(SimpleNamespace(
        duration=4000 / 25.0, sr=25.0, where="day", date_epoch=0.0,
        get_np_array=lambda stations, components=None: data))
    eng.set_weights_channels(method="simple", normalize=True)
    eng.run_matched_filter_search(5.0, threshold_window_dur=60.0,
                                  white_noise=np.ones(300, np.float32),
                                  verbose=-1)
    assert seen and set(seen) == {route}


# --------------------------------------------------------------------------
# the f32-class kernels: TF32 parts and the plan's rows (csrc/mf.cu's index
# maps and both builds' sums: tests/test_torch_mf_tc.py)
def _tf32_rna_reference(x):
    """Round to TF32 (10 stored mantissa bits), to nearest with ties away
    from zero, computed in float64 from the value, not from its bits."""
    x = np.asarray(x, np.float32).astype(np.float64)
    _, e = np.frexp(x)                       # |x| = m 2^e, m in [0.5, 1)
    ulp = np.ldexp(1.0, np.maximum(e - 1, -126) - 10)
    r = np.floor(np.abs(x) / ulp + 0.5) * ulp
    return np.copysign(r, x).astype(np.float32)


def test_split_tf32_rounds_like_cvt_rna_bit_for_bit():
    rng = np.random.default_rng(31)
    x = (rng.normal(size=8192)
         * 10.0 ** rng.integers(-30, 30, size=8192)).astype(np.float32)
    bits = x.view(np.uint32)
    bits[:1024] = (bits[:1024] & 0xFFFFE000) | 0x1000   # exact ties, both
    bits[:512] |= 0x2000                                # parities of hi
    bits[1024:1280] = rng.integers(1, 1 << 23, 256)     # subnormals
    bits[1280:1408] |= 0x80000000                       # negatives
    bits[1408:1536] = (rng.integers(0x7E800000, 0x7F000000, 128)
                       .astype(np.uint32))              # exponents near max
    x[-2:] = (0.0, -0.0)
    hi, lo = mf.split_tf32(torch.from_numpy(x))
    assert hi.dtype == lo.dtype == torch.float32
    h, lo_ = hi.numpy(), lo.numpy()
    np.testing.assert_array_equal(h.view(np.uint32),
                                  _tf32_rna_reference(x).view(np.uint32))
    np.testing.assert_array_equal(
        lo_.view(np.uint32),
        _tf32_rna_reference(x - h).view(np.uint32))
    assert np.all(h.view(np.uint32) & 0x1FFF == 0)
    assert np.all(lo_.view(np.uint32) & 0x1FFF == 0)
    # ties go away from zero
    tie = np.float32(1.0 + 2.0**-11)
    got = mf.split_tf32(torch.tensor([tie, -tie]))[0].numpy()
    np.testing.assert_array_equal(got, [1.0 + 2.0**-10, -1.0 - 2.0**-10])
    normal = np.abs(x) >= 2.0**-100
    rest = x.astype(np.float64) - h - lo_.astype(np.float64)
    assert np.all(np.abs(rest[normal])
                  <= 2.0**-22 * np.abs(x[normal].astype(np.float64)))
    assert np.any(lo_ != 0.0)


def test_tf32_plain_is_a_real_split():
    """The f32 rungs' plain version keeps the lo parts: dropping the day's
    lo part costs ~2^-11 of a product, far outside the f32 gate the full
    split meets."""
    tp, mv, w, data = _bank(32)
    plan = mf.MatchedFilterPlan(tp, mv, w, data.shape[-1], device="cpu")
    filt_hi, filt_lo = mf.tf32_rows_parts(plan.filt_rows, plan.L)
    assert bool((filt_lo != 0).any())
    dp = plan.pad_data(data)
    kw = dict(n_tp=plan.n_tp, L=plan.L, n_corr=plan.n_corr_unit,
              lo_p=plan.lo_p, hi_p=plan.hi_p)
    full = mf.matched_filter_plain(dp, filt_hi, filt_lo, plan.mv_table,
                                   **kw).numpy()
    hi_only = mf.matched_filter_plain(mf.split_tf32(dp)[0], filt_hi,
                                      filt_lo, plan.mv_table, **kw).numpy()
    oracle = jref.matched_filter(tp, mv, w, data)
    err = np.abs(full - oracle).max()
    assert err < 1e-6
    assert np.abs(hi_only - oracle).max() > 10 * err
    np.testing.assert_array_equal(plan(dp).numpy(), full)


def test_staged_tf32_rows_layout():
    """The rows as the kernel stages them: hi and lo behind 8 zeros, each
    (channel, tile) block contiguous."""
    tp, mv, w, data = _bank(33, n_tp=40, L=37)
    plan = mf.MatchedFilterPlan(tp, mv, w, data.shape[-1], device="cpu")
    rows = plan.filt_rows
    KP = 48 + 8                       # round_up(37 + 7, 8) + 8
    assert rows.shape == (plan.n_ch, 2, 2, mf.TEMPLATE_TILE, KP)
    assert rows.dtype == torch.float32 and rows.is_contiguous()
    parts = mf.split_tf32(torch.from_numpy(_scaled_rows(tp, w, 64, 37)))
    assert bool((parts[1] != 0).any())
    for part, f in enumerate(parts):
        f4 = f.reshape(plan.n_ch, 2, mf.TEMPLATE_TILE, 37)
        staged = rows[:, :, part]
        assert torch.equal(staged[..., 8 : 8 + 37], f4)
        assert bool((staged[..., :8] == 0).all())
        assert bool((staged[..., 8 + 37 :] == 0).all())
    hi, lo = mf.tf32_rows_parts(rows, plan.L)
    assert torch.equal(hi, parts[0]) and torch.equal(lo, parts[1])
    # L = 49: the plan's 64-wide f32 rows are wider than K = 56
    tp, mv, w, data = _bank(34, L=49)
    plan = mf.MatchedFilterPlan(tp, mv, w, data.shape[-1], device="cpu")
    assert plan.filt_rows.shape[-1] == 56 + 8
    np.testing.assert_allclose(plan(plan.pad_data(data)).numpy(),
                               jref.matched_filter(tp, mv, w, data),
                               rtol=RTOL, atol=ATOL)


def test_smem_mirror_and_limit():
    """A 'highest' plan takes what csrc/mf.cu's ring holds, as a 'default'
    one does (its 'highest' build stages the same: `_smem_bytes`): four
    stages at the main path's shape, one block a SM; and it refuses a span
    that cannot fit."""
    assert mf._smem_bytes(200, 450) == 1024 + 4 * (43008 + 16)
    assert mf._smem_bytes(200, 450) <= mf.SMEM_LIMIT < 2 * (
        mf._smem_bytes(200, 450) + 1024)
    tp, mv, w, data = _bank(35, mv_range=(-30, 60))
    mv[1, 0, 0] = 15000                  # four stages do not fit, one does
    plan = mf.MatchedFilterPlan(tp, mv, w, 30000, device="cpu")
    assert plan.precision_name == "highest"
    assert mf.stages(plan.L, plan.max_delta) == 1
    mv[1, 0, 0] = 200000
    with pytest.raises(ValueError, match="shared memory"):
        mf.MatchedFilterPlan(tp, mv, w, 300000, device="cpu")


# --------------------------------------------------------------------------
# the `high` rung: the bf16-split kernel's plain version
def test_split_bf16_equals_the_jax_split_bit_for_bit():
    rng = np.random.default_rng(21)
    x = (rng.normal(size=8192)
         * 10.0 ** rng.integers(-20, 20, size=8192)).astype(np.float32)
    bits = x.view(np.uint32)
    bits[:1024] = (bits[:1024] & 0xFFFF0000) | 0x8000   # exact ties, both
    bits[:512] |= 0x00010000                            # parities of hi
    x[-1] = 0.0
    hi, lo = mf.split_bf16(torch.from_numpy(x))
    assert hi.dtype == lo.dtype == torch.bfloat16
    jhi, jlo = _split_bf16(x)
    for got, want in ((hi, jhi), (lo, jlo)):
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(),
            np.asarray(want).view(np.int16))
    rest = x - hi.float().numpy() - lo.float().numpy()
    assert np.all(np.abs(rest) <= 2.0 ** -17 * np.abs(x))
    assert np.any(lo.float().numpy() != 0.0)


def _odd_even_moveouts(seed):
    tp, mv, w, data = _bank(seed, n_tp=6)
    mv[0] = 2 * (mv[0] // 2)         # a template with even moveouts only
    mv[1] = 2 * (mv[1] // 2) + 1     # and one with odd ones only
    return tp, mv, w, data


HIGH_CASES = dict(CASES, odd_and_even_moveouts=_odd_even_moveouts)


@pytest.mark.parametrize("case", list(HIGH_CASES))
def test_high_plain_matches_pallas_split_and_oracle(case):
    tp, mv, w, data = HIGH_CASES[case](22)
    n_samp = data.shape[-1]
    plan = mf.MatchedFilterPlan(tp, mv, w, n_samp, precision="high",
                                device="cpu")
    calls = mf.matched_filter_split_plain.calls
    got = plan(plan.pad_data(data)).numpy()
    assert mf.matched_filter_split_plain.calls == calls + 1
    jplan = PallasMatchedFilterPlan(tp, mv, w, n_samp, lag_block=512,
                                    interpret=True, precision="high")
    pallas = np.asarray(jplan(jplan.pad_data(data)))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL_HIGH)
    np.testing.assert_allclose(got, jref.matched_filter(tp, mv, w, data),
                               rtol=0, atol=ATOL_HIGH)


def test_high_zero_gap_gives_exact_zero():
    tp, mv, w, data = _zero_variance(23)
    cc = mf.matched_filter(tp, mv, w, data, precision="high",
                           device="cpu").numpy()
    assert np.all(cc[:, 400:700 - 60 - tp.shape[-1]] == 0.0)


@pytest.mark.parametrize("step", [2, 3])
def test_high_step(step):
    tp, mv, w, data = _bank(24, mv_range=(0, 40))
    got = mf.matched_filter(tp, mv, w, data, step=step, precision="high",
                            device="cpu").numpy()
    pallas = np.asarray(matched_filter_pallas(
        tp, mv, w, data, step=step, lag_block=512, interpret=True,
        precision="high"))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL_HIGH)


def test_high_shared_layout_overrides():
    tp, mv, w, data = _bank(25)
    n_samp = data.shape[-1]
    pad_left, max_mv = int(-min(0, mv.min())), int(mv.max())
    plan = mf.MatchedFilterPlan(tp[:2], mv[:2], w[:2], n_samp,
                                pad_left=pad_left, max_moveout=max_mv,
                                precision="high", device="cpu")
    own = mf.MatchedFilterPlan(tp[:2], mv[:2], w[:2], n_samp,
                               precision="high", device="cpu")
    np.testing.assert_allclose(plan(plan.pad_data(data)).numpy(),
                               own(own.pad_data(data)).numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        plan(plan.pad_data(data)).numpy(),
        jref.matched_filter(tp[:2], mv[:2], w[:2], data),
        rtol=0, atol=ATOL_HIGH)


def test_split_wrapper_never_takes_the_plain_version_off_the_cpu():
    tp, mv, w, data = _bank(26, n_tp=2)
    plan = mf.MatchedFilterPlan(tp, mv, w, data.shape[-1], precision="high",
                                device="cpu")
    filt_hi, filt_lo = mf.split_rows_parts(plan.filt_rows, plan.L)
    assert filt_hi.dtype == filt_lo.dtype == torch.bfloat16
    assert bool((filt_lo.float() != 0).any())
    meta = lambda t: t.to("meta")  # noqa: E731
    calls = mf.matched_filter_split_plain.calls
    with pytest.raises(ValueError, match="device"):
        mf.mf_cc_split(meta(plan.pad_data(data)), meta(plan.filt_rows),
                       meta(plan.mv_table),
                       meta(plan.tile_lo), n_tp=plan.n_tp, L=plan.L,
                       n_corr=plan.n_corr_unit, lo_p=plan.lo_p,
                       hi_p=plan.hi_p, max_delta=plan.max_delta)
    assert mf.matched_filter_split_plain.calls == calls


def test_staged_split_rows_layout():
    """The rows as the kernel stages them: hi and lo, each as it is behind
    72 zeros and one element on, every template's four rows in a row."""
    tp, mv, w, data = _bank(29, n_tp=40, L=37)
    plan = mf.MatchedFilterPlan(tp, mv, w, data.shape[-1], precision="high",
                                device="cpu")
    rows = plan.filt_rows
    ROW = 192 + 32                    # round_up(112 + 40, 64) + 32
    assert rows.shape == (plan.n_ch, 64, 2, 2, ROW)
    assert rows.dtype == torch.bfloat16 and rows.is_contiguous()
    parts = mf.split_bf16(torch.from_numpy(_scaled_rows(tp, w, 64, 48)))
    assert bool((parts[1].float() != 0).any())
    for part, f in enumerate(parts):
        f = f.float()
        as_is = rows[:, :, part, 0].float()
        shifted = rows[:, :, part, 1].float()
        assert torch.equal(as_is[..., 72 : 72 + f.shape[-1]], f)
        assert bool((as_is[..., :72] == 0).all())
        assert bool((as_is[..., 72 + 37 :] == 0).all())
        assert torch.equal(shifted[..., :-1], as_is[..., 1:])
        assert bool((shifted[..., -1] == 0).all())
    hi, lo = mf.split_rows_parts(rows, plan.L)
    assert torch.equal(hi, parts[0][..., : plan.L])
    assert torch.equal(lo, parts[1][..., : plan.L])


def test_split_smem_mirror_and_limit():
    """The Python mirror of the split kernel's shared-memory size, at the
    main path's shape, and the plan's refusal of a span that cannot fit."""
    # three ring stages of: data hi and lo (4,800 bf16 each, 10 KB), 4
    # templates x 4 rows of 352 bf16, y (4,556 words and 36 x 8 pads), 4
    # moveouts, rounded up to 1 KB; 1 KB of alignment, 3 x 2 mbarriers;
    # for L = 200, max_delta = 450
    assert mf._split_smem_bytes(200, 450) == 1024 + 3 * (50 * 1024 + 16)
    assert 50 * 1024 == -(-(2 * 10240 + 4 * 8 * 352 + 4 * (4556 + 8 * 36)
                            + 16) // 1024) * 1024
    tp, mv, w, data = _bank(27, mv_range=(-30, 60))
    mv[1, 0, 0] = 200000
    with pytest.raises(ValueError, match="shared memory"):
        mf.MatchedFilterPlan(tp, mv, w, 300000, precision="high",
                             device="cpu")


# --------------------------------------------------------------------------
# the plain-ops engine (`ops.matched_filter`)
@pytest.mark.parametrize("network_sum", [True, False])
@pytest.mark.parametrize("step", [1, 3])
def test_plain_engine_matches_jax(network_sum, step):
    tp, mv, w, data = _dead_channels(28)
    data[:, :, 500:640] = 0.0
    want = np.asarray(jmf_engine(tp, mv, w, data, step=step,
                                 network_sum=network_sum))
    got = tmf_engine(tp, mv, w, data, step=step, network_sum=network_sum,
                     device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(),
        jref.matched_filter(tp, mv, w, data, step=step,
                            network_sum=network_sum),
        rtol=1e-4, atol=1e-5)
    # the lag block is a memory knob only
    blocked = tmf_engine(tp, mv, w, data, step=step,
                         network_sum=network_sum, n_corr_block=200,
                         device="cpu")
    np.testing.assert_allclose(blocked.numpy(), got.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_host_route_dedups_like_the_device_route_at_a_fractional_window(
        monkeypatch):
    """At step 2 the search window is fractional (5 samples / 2): the
    native dedup of the host route (taken on a candidate overflow) keeps
    the device route's detections."""
    from seismic_bpmf_tpu_torch.config import Config
    from seismic_bpmf_tpu_torch.data.groups import TemplateGroup
    from seismic_bpmf_tpu_torch.detection.matched_filter import MatchedFilter

    tp, mv, w, data = _bank(5, n_tp=2, n_sta=4, n_comp=3, L=30,
                            n_samp=6000, mv_range=(0, 3))
    for at in (800, 2400, 4100):                 # repeats of template 0
        for s in range(4):
            for c in range(3):
                a = at + mv[0, s, c]
                data[s, c, a:a + 30] += 3.0 * tp[0, s, c]
    tg = TemplateGroup.from_arrays(tp, mv, ["0", "1"], ["A", "B", "C", "D"],
                                   sampling_rate=25.0)

    def detect():
        eng = MatchedFilter(tg, cfg=Config(data_buffer_sec=0.0,
                                           sampling_rate_hz=25.0,
                                           n_dev_mf_threshold=1.5),
                            step=2, device="cpu", min_channels=3,
                            min_stations=2, max_kurto=1e6)
        eng.set_data(SimpleNamespace(
            duration=6000 / 25.0, sr=25.0, where="day", date_epoch=0.0,
            get_np_array=lambda stations, components=None: data))
        eng.set_weights_channels(method="simple", normalize=True)
        res = eng.run_matched_filter_search(
            0.2, threshold_window_dur=60.0,
            white_noise=np.ones(300, np.float32), verbose=-1)
        assert eng._search_win(0) == 2.5
        return {t: [e.origin_time_epoch for e in evs]
                for t, evs in res.items()}

    device = detect()
    # every row overflows the batched extraction's candidates
    monkeypatch.setattr(MatchedFilter, "MAX_CANDIDATES", 2)
    host_rows = []
    select = MatchedFilter.select_cc_indexes

    def spy(self, cc_t, *a):
        host_rows.append(len(cc_t))
        return select(self, cc_t, *a)

    monkeypatch.setattr(MatchedFilter, "select_cc_indexes", spy)
    host = detect()
    assert len(host_rows) == 2 and min(host_rows) > 2900
    assert sum(map(len, device.values())) > 10
    assert host == device
