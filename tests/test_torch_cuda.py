"""Tests of the port that need a CUDA card: the hand-written kernels have
no CPU mode.  They skip without one.  This file imports neither JAX nor the
JAX package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest configures JAX.)  The port's own
oracle copy stands for the reference; tests/test_torch_mf.py pins that
copy to the JAX package's.
"""

import copy
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seismic_bpmf_tpu_torch import workflow  # noqa: E402
from seismic_bpmf_tpu_torch.config import Config  # noqa: E402
from seismic_bpmf_tpu_torch.data import (  # noqa: E402
    Data, Network, Stream, TemplateGroup, Trace, TravelTimes,
)
from seismic_bpmf_tpu_torch.detection import MatchedFilter  # noqa: E402
from seismic_bpmf_tpu_torch.models import phasenet  # noqa: E402
from seismic_bpmf_tpu_torch.ops import bp, mf  # noqa: E402
from seismic_bpmf_tpu_torch.ops import picks, signal  # noqa: E402
from seismic_bpmf_tpu_torch.ops import reference as tref  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5  # the f32 gate of the JAX package's kernel tests


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    # the plain version's products must run in f32, not TF32
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _bank(seed, n_tp=5, n_sta=3, n_comp=2, L=40, n_samp=1500,
          mv_range=(-30, 200)):
    rng = np.random.default_rng(seed)
    tp = rng.normal(size=(n_tp, n_sta, n_comp, L)).astype(np.float32)
    mv = rng.integers(*mv_range, size=(n_tp, n_sta, n_comp)).astype(np.int32)
    w = rng.uniform(0.1, 1, size=(n_tp, n_sta, n_comp)).astype(np.float32)
    w /= w.sum(axis=(1, 2), keepdims=True)
    data = rng.normal(size=(n_sta, n_comp, n_samp)).astype(np.float32)
    return tp, mv, w, data


def _zero_variance(seed):
    tp, mv, w, data = _bank(seed, mv_range=(0, 60))
    data[:, :, 400:700] = 0.0        # a zero-filled gap
    data[1, 0, 900:1100] = 2.5       # a constant (zero-variance) stretch
    return tp, mv, w, data


def _dead_channels(seed):
    tp, mv, w, data = _bank(seed)
    w[0, 1] = 0.0                    # zero-weight station
    tp[1, 2, 0] = 7.0                # zero-norm template channel
    data[0, 0] = 0.0                 # dead data channel
    return tp, mv, w, data


CASES = {
    "negative_moveouts": _bank,
    "zero_variance_windows": _zero_variance,
    "out_of_bounds_lags": lambda s: _bank(s, n_samp=900,
                                          mv_range=(-400, 700)),
    "dead_channels": _dead_channels,
    # more than one template tile, L not a multiple of the tap padding
    "two_template_tiles": lambda s: _bank(s, n_tp=40, L=37, n_samp=3000),
}


def _odd_moveouts_ragged(seed):
    """Odd and even moveouts, L not a multiple of 16 (an odd number of
    k-steps in csrc/mf.cu), a ragged last lag tile and a ragged template
    tile."""
    tp, mv, w, data = _bank(seed, n_tp=37, L=43, n_samp=2 * 512 + 301)
    mv[0] = 2 * (mv[0] // 2)
    mv[1] = 2 * (mv[1] // 2) + 1
    return tp, mv, w, data


SPLIT_CASES = dict(CASES, odd_moveouts_ragged_edges=_odd_moveouts_ragged,
                   taps_fill_the_band=lambda s: _bank(s, L=41),
                   long_template=lambda s: _bank(s, L=200, n_samp=5000))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_kernel_matches_plain_on_card(card, case):
    """Both builds of csrc/mf.cu, each after the pre-pass: 'highest' (the
    partials summed outside the tensor cores) and 'default'."""
    tp, mv, w, data = SPLIT_CASES[case](16)
    for precision, wrapper in (("highest", mf.mf_cc_highest),
                               ("default", mf.mf_cc)):
        plan = mf.MatchedFilterPlan(tp, mv, w, data.shape[-1],
                                    precision=precision, device=card)
        dp = plan.pad_data(data)
        counts = [mf.mf_cc.launches, mf.mf_cc_highest.launches,
                  mf.matched_filter_plain.calls, mf.tf32_day.launches]
        got = plan(dp)
        counts[wrapper is mf.mf_cc_highest] += 1
        counts[3] += 1
        assert [mf.mf_cc.launches, mf.mf_cc_highest.launches,
                mf.matched_filter_plain.calls,
                mf.tf32_day.launches] == counts
        filt_hi, filt_lo = mf.tf32_rows_parts(plan.filt_rows, plan.L)
        want = mf.matched_filter_plain(
            dp, filt_hi, filt_lo, plan.mv_table, n_tp=plan.n_tp, L=plan.L,
            n_corr=plan.n_corr_unit, lo_p=plan.lo_p, hi_p=plan.hi_p)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.cpu().numpy(),
                                   tref.matched_filter(tp, mv, w, data),
                                   rtol=RTOL, atol=ATOL)


def _planted_repeats(seed, n_tp=4, n_sta=10, n_comp=3, L=200,
                     n_samp=12000, per_template=3):
    """Noise with each template's waveform planted `per_template` times at
    its moveouts (CC ~0.98), and the planted lags (as in
    tests/test_torch_mf.py)."""
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


def _widest_span(L):
    """The largest max_delta whose ring of csrc/mf.cu (one stage) fits
    shared memory."""
    lo, hi = 0, 1 << 16
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = ((mid, hi) if mf._smem_bytes(L, mid) <= mf.SMEM_LIMIT
                  else (lo, mid))
    return lo


def _tf32_ring_case(case):
    T = mf.LAG_TILE
    if case == "one_channel":
        return _bank(70, n_tp=9, n_sta=1, n_comp=1, L=200, n_samp=T + 500)
    if case == "channel_skipped_in_the_ring":
        tp, mv, w, data = _bank(71, n_tp=6, n_sta=4, n_comp=2, L=64,
                                n_samp=T + 900)
        w[:, 2, 1] = 0.0             # no template uses channel 5 of 8
        return tp, mv, w, data
    if case in ("ragged_templates_and_lags", "screen_upload"):
        # 13 templates: the last block of 4 holds one; n_corr not a
        # multiple of the lag tile
        return _bank(72, n_tp=13, n_sta=3, n_comp=3, L=51,
                     n_samp=2 * T + 301 + 50, mv_range=(-41, 333))
    # the widest moveout span inside a template tile that shared memory
    # holds (a ring of one stage)
    L = 40
    span = _widest_span(L)
    tp, mv, w, data = _bank(73, n_tp=4, n_sta=2, n_comp=2, L=L,
                            n_samp=span + T + 700, mv_range=(0, span))
    mv[0, 0, 0], mv[1, 1, 1] = 0, span
    return tp, mv, w, data


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_channel", "channel_skipped_in_the_ring",
                                  "ragged_templates_and_lags",
                                  "widest_span", "screen_upload"])
def test_kernel_ring_edges_on_card(card, case):
    """csrc/mf.cu's ring at its edges against the plain version: a single
    channel, a channel the tile skips between used ones, template and lag
    counts that are not multiples of the block's, the widest span that
    fits (one stage), and a `screen` upload (the day rounded to bf16, so
    its TF32 lo parts are 0)."""
    tp, mv, w, data = _tf32_ring_case(case)
    plan = mf.MatchedFilterPlan(tp, mv, w, data.shape[-1],
                                precision="default", device=card)
    n_stages = mf.stages(plan.L, plan.max_delta)
    assert n_stages == (1 if case == "widest_span" else mf.STAGES)
    if case == "channel_skipped_in_the_ring":
        assert plan.tile_lo[:, 0].tolist().count(-1) == 1
        assert int(plan.tile_lo[5, 0]) == -1
    if case == "ragged_templates_and_lags":
        assert plan.n_tp % mf.BLOCK_TEMPLATES
        assert plan.n_corr_unit % mf.LAG_TILE
    dp = plan.pad_data(data, dtype="bfloat16" if case == "screen_upload"
                       else "float32")
    if case == "screen_upload":
        assert not bool(mf.split_tf32(dp)[1].any())
    pre = mf.tf32_day.launches
    got = plan(dp)
    assert mf.tf32_day.launches == pre + 1
    want = mf.matched_filter_plain(
        dp, *mf.tf32_rows_parts(plan.filt_rows, plan.L), plan.mv_table,
        n_tp=plan.n_tp, L=plan.L, n_corr=plan.n_corr_unit, lo_p=plan.lo_p,
        hi_p=plan.hi_p)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [200, 37])
def test_prepass_on_card_matches_its_twin(card, L):
    """csrc/mf.cu's pre-pass: its TF32 parts equal the plain twin's bit for
    bit; its y lies within 2 ulp of the twin's (the same partial order and
    fused multiply-adds; the card's rsqrtf within 2 ulp of the twin's
    once-rounded one), 0 at the same window starts."""
    tp, mv, w, data = _zero_variance(74)
    plan = mf.MatchedFilterPlan(tp, mv, w, data.shape[-1],
                                precision="default", device=card)
    dp = plan.pad_data(data)
    hi, lo, y = mf.tf32_day(dp, L)
    h2, l2, y2 = mf.tf32_day_plain(dp.cpu(), L)
    torch.cuda.synchronize()
    assert torch.equal(hi.cpu(), h2) and torch.equal(lo.cpu(), l2)
    y = y.cpu()
    assert torch.equal(y == 0, y2 == 0) and bool((y >= 0).all())
    ulp = (y.view(torch.int32) - y2.view(torch.int32)).abs()
    assert int(ulp.max()) <= 2
    # the same y as the split kernel's pre-pass: one shared code
    assert torch.equal(y, mf.split_day(dp, L)[2].cpu())


@pytest.mark.cuda
def test_highest_build_is_exact_at_detections(card):
    """At planted repeats (every channel's products of one sign) the
    'highest' build lies within 1e-6 of the float64 oracle, and closer to
    it than the default build, whose products run through the tensor
    cores' truncating accumulator."""
    tp, mv, w, data, lags = _planted_repeats(41, per_template=6,
                                             n_samp=20000)
    worst = {}
    for precision in ("highest", "default"):
        cc = mf.matched_filter(tp, mv, w, data, precision=precision,
                               device=card).cpu().numpy()
        worst[precision] = max(
            float(np.abs(cc[i, lags[i]] - tref.matched_filter_at(
                tp[i], mv[i], w[i], data, lags[i])).max())
            for i in range(tp.shape[0]))
    assert worst["highest"] <= 1e-6, worst
    assert worst["highest"] < worst["default"], worst


@pytest.mark.cuda
def test_kernel_step_matches_oracle(card):
    tp, mv, w, data = _bank(17, mv_range=(0, 40))
    got = mf.matched_filter(tp, mv, w, data, step=3, device=card)
    np.testing.assert_allclose(got.cpu().numpy(),
                               tref.matched_filter(tp, mv, w, data, step=3),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_kernel_matches_plain_on_card(card, case):
    tp, mv, w, data = SPLIT_CASES[case](16)
    plan = mf.MatchedFilterPlan(tp, mv, w, data.shape[-1], precision="high",
                                device=card)
    filt_hi, filt_lo = mf.split_rows_parts(plan.filt_rows, plan.L)
    assert bool((filt_lo.float() != 0).any())
    dp = plan.pad_data(data)
    counts = (mf.mf_cc_split.launches, mf.mf_cc.launches,
              mf.matched_filter_split_plain.calls)
    got = plan(dp)
    assert (mf.mf_cc_split.launches, mf.mf_cc.launches,
            mf.matched_filter_split_plain.calls) == (
        counts[0] + 1, counts[1], counts[2])
    want = mf.matched_filter_split_plain(
        dp, filt_hi, filt_lo, plan.mv_table, n_tp=plan.n_tp,
        L=plan.L, n_corr=plan.n_corr_unit, lo_p=plan.lo_p, hi_p=plan.hi_p)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    # the JAX package's gate of this rung against the oracle
    np.testing.assert_allclose(got.cpu().numpy(),
                               tref.matched_filter(tp, mv, w, data),
                               rtol=0, atol=5e-6)
    # a real split: not the f32 kernel's bits, and the data's lo parts count
    f32 = mf.MatchedFilterPlan(tp, mv, w, data.shape[-1], device=card)(dp)
    assert not torch.equal(got, f32)
    hi_only = mf.matched_filter_split_plain(
        mf.split_bf16(dp)[0].float(), filt_hi, filt_lo, plan.mv_table,
        n_tp=plan.n_tp, L=plan.L, n_corr=plan.n_corr_unit,
        lo_p=plan.lo_p, hi_p=plan.hi_p)
    assert float((got - want).abs().max()) < float(
        (got - hi_only).abs().max())
    with pytest.raises(ValueError, match="bfloat16"):
        mf.mf_cc_split(dp, plan.filt_rows.float(), plan.mv_table,
                       plan.tile_lo, n_tp=plan.n_tp, L=plan.L,
                       n_corr=plan.n_corr_unit, lo_p=plan.lo_p,
                       hi_p=plan.hi_p, max_delta=plan.max_delta)


def _widest_split_span(L):
    """The largest max_delta whose ring (one stage) fits shared memory."""
    lo, hi = 0, 1 << 16
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = ((mid, hi) if mf._split_smem_bytes(L, mid) <= mf.SMEM_LIMIT
                  else (lo, mid))
    return lo


def _ring_case(case):
    T = mf.SPLIT_LAG_TILE
    if case == "one_channel":
        return _bank(60, n_tp=9, n_sta=1, n_comp=1, L=200, n_samp=T + 500)
    if case == "channel_skipped_in_the_ring":
        tp, mv, w, data = _bank(61, n_tp=6, n_sta=4, n_comp=2, L=64,
                                n_samp=T + 900)
        w[:, 2, 1] = 0.0             # no template uses channel 5 of 8
        return tp, mv, w, data
    if case == "ragged_templates_and_lags":
        return _bank(62, n_tp=13, n_sta=3, n_comp=3, L=51,
                     n_samp=2 * T + 301 + 50, mv_range=(-41, 333))
    # the widest moveout span inside a template tile that shared memory
    # holds (a ring of one stage)
    L = 40
    span = _widest_split_span(L)
    tp, mv, w, data = _bank(63, n_tp=4, n_sta=2, n_comp=2, L=L,
                            n_samp=span + T + 700, mv_range=(0, span))
    mv[0, 0, 0], mv[1, 1, 1] = 0, span
    return tp, mv, w, data


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_channel", "channel_skipped_in_the_ring",
                                  "ragged_templates_and_lags",
                                  "widest_span"])
def test_split_kernel_ring_edges_on_card(card, case):
    """csrc/mf_split.cu's ring at its edges against the plain version: a
    single channel, a channel the tile skips between used ones, template
    and lag counts that are not multiples of the block's, the widest span
    that fits (one stage)."""
    tp, mv, w, data = _ring_case(case)
    plan = mf.MatchedFilterPlan(tp, mv, w, data.shape[-1], precision="high",
                                device=card)
    stages = mf.split_stages(plan.L, plan.max_delta)
    assert stages == (1 if case == "widest_span" else mf.SPLIT_STAGES)
    if case == "channel_skipped_in_the_ring":
        assert plan.tile_lo[:, 0].tolist().count(-1) == 1
        assert int(plan.tile_lo[5, 0]) == -1
    dp = plan.pad_data(data)
    pre = mf.split_day.launches
    got = plan(dp)
    assert mf.split_day.launches == pre + 1
    want = mf.matched_filter_split_plain(
        dp, *mf.split_rows_parts(plan.filt_rows, plan.L), plan.mv_table,
        n_tp=plan.n_tp, L=plan.L, n_corr=plan.n_corr_unit, lo_p=plan.lo_p,
        hi_p=plan.hi_p)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [200, 37])
def test_split_prepass_on_card_matches_its_twin(card, L):
    """The pre-pass's bf16 parts equal the plain twin's; its y lies within
    2 ulp of the twin's (the same partial order and fused multiply-adds;
    the card's rsqrtf within 2 ulp of the twin's once-rounded one), 0 at
    the same window starts."""
    tp, mv, w, data = _zero_variance(64)
    plan = mf.MatchedFilterPlan(tp, mv, w, data.shape[-1], precision="high",
                                device=card)
    dp = plan.pad_data(data)
    hi, lo, y = mf.split_day(dp, L)
    h2, l2, y2 = mf.split_day_plain(dp.cpu(), L)
    torch.cuda.synchronize()
    assert torch.equal(hi.cpu(), h2) and torch.equal(lo.cpu(), l2)
    y = y.cpu()
    assert torch.equal(y == 0, y2 == 0) and bool((y >= 0).all())
    ulp = (y.view(torch.int32) - y2.view(torch.int32)).abs()
    assert int(ulp.max()) <= 2


@pytest.mark.cuda
def test_plain_engine_on_card_matches_oracle(card):
    from seismic_bpmf_tpu_torch.ops.matched_filter import matched_filter

    tp, mv, w, data = _dead_channels(22)
    for network_sum in (True, False):
        got = matched_filter(tp, mv, w, data, step=2,
                             network_sum=network_sum, device=card)
        np.testing.assert_allclose(
            got.cpu().numpy(),
            tref.matched_filter(tp, mv, w, data, step=2,
                                network_sum=network_sum),
            rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high", "screen"])
def test_matched_filter_on_card_matches_cpu(card, precision):
    """The whole engine (kernel, device threshold and extraction, host
    refine) on the card gives the CPU run's detections."""
    sr, L, n = 25.0, 50, 30000
    rng = np.random.default_rng(18)
    mv = rng.integers(-10, 60, size=(3, 4, 3))
    data = rng.standard_normal((4, 3, n), dtype=np.float32)
    wave = (rng.normal(size=(3, 4, 3, L)) * np.hanning(L) * 20).astype(
        np.float32)
    for i, origins in enumerate(([3000, 17003], [9000], [25011])):
        for o in origins:
            for s in range(4):
                for c in range(3):
                    data[s, c, o + mv[i, s, c]: o + mv[i, s, c] + L] += (
                        wave[i, s, c])
    tg = TemplateGroup.from_arrays(wave, mv, ["0", "1", "2"],
                                   ["A", "B", "C", "D"], sampling_rate=sr)
    cfg = Config(data_buffer_sec=0.0, sampling_rate_hz=sr)
    noise = rng.normal(size=500).astype(np.float32)

    day = SimpleNamespace(duration=n / sr, sr=sr, where="day",
                          date_epoch=0.0,
                          get_np_array=lambda stations, components=None: data)

    found = {}
    for dev in ("cpu", "cuda"):
        eng = MatchedFilter(tg, cfg=cfg, precision=precision, device=dev,
                            min_channels=3, min_stations=2, max_kurto=1e6)
        eng.set_data(day)
        eng.set_weights_channels(method="simple", normalize=True)
        wrapper = {"high": mf.mf_cc_split, "highest": mf.mf_cc_highest,
                   "screen": mf.mf_cc}[precision]
        launches = wrapper.launches
        dets = eng.run_matched_filter_search(
            5.0, threshold_window_dur=120.0, white_noise=noise, verbose=-1)
        assert (wrapper.launches > launches) == (dev == "cuda")
        found[dev] = {t: [(round(e.origin_time_epoch * sr),
                           e.aux_data["cc"]) for e in evs]
                      for t, evs in dets.items()}
    assert set(found["cpu"]) == set(found["cuda"])
    for t, hits in found["cpu"].items():
        assert [i for i, _ in hits] == [i for i, _ in found["cuda"][t]]
        np.testing.assert_allclose([c for _, c in found["cuda"][t]],
                                   [c for _, c in hits], atol=1e-5)
    assert [i for i, _ in found["cuda"]["0"]] == [3000, 17003]


def _bp_problem(seed, n_src=75, n_sta=6, n_samp=1700, max_mv=300):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n_sta, 3, n_samp)).astype(np.float32)
    mv = rng.integers(0, max_mv, size=(n_src, n_sta, 2)).astype(np.int32)
    w_ph = np.zeros((n_sta, 3, 2), np.float32)
    w_ph[:, 2, 0] = 1.0
    w_ph[:, :2, 1] = 1.0
    w_src = rng.uniform(0.2, 1.0, size=(n_src, n_sta)).astype(np.float32)
    w_src[:, ::2] = 0.0              # sparse weights
    w_src[3] = 0.0                   # no used pair: a beam of 0
    for i in (40, n_src - 1):        # exact copies of source 9: ties
        mv[i], w_src[i] = mv[9], w_src[9]
    return feats, mv, w_ph, w_src


@pytest.mark.cuda
@pytest.mark.parametrize("oob", ["strict", "flexible"])
def test_bp_kernel_matches_plain_on_card(card, oob):
    feats, mv, w_ph, w_src = _bp_problem(19)
    for reduce in ("max", "none"):
        plan = bp.BeamformPlan(mv, w_ph, w_src, feats.shape[-1],
                               reduce=reduce, out_of_bounds=oob, device=card)
        g = plan.fold_and_pad(feats)
        launches, calls = bp.bp_beam.launches, bp.beamform_plain.calls
        got = plan.call_folded(g)
        assert bp.bp_beam.launches == launches + 1
        assert bp.beamform_plain.calls == calls
        want = bp.beamform_plain(g, plan.tables, reduce=reduce)
        torch.cuda.synchronize()
        if reduce == "none":
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
            assert bool((got[3] == 0).all())
            continue
        torch.testing.assert_close(got[0], want[0][: plan.n_samp],
                                   rtol=RTOL, atol=ATOL)
        assert torch.equal(got[1], want[1][: plan.n_samp])
        assert not bool(torch.isin(got[1], torch.tensor(
            [40, mv.shape[0] - 1], device=card)).any())
        v2, i2 = plan.call_folded_chunked(g, 3)
        assert torch.equal(v2, got[0]) and torch.equal(i2, got[1])
        with pytest.raises(ValueError, match="float32"):
            bp.bp_beam(g.double(), plan.tables)


def _hold_bp_to_plain(card, feats, mv, w_ph, w_src, **kw):
    """The kernel against the plain version on the card, 'max' (values,
    argmax, the 3-chunk call bit for bit) and 'none'; returns the 'max'
    plan."""
    for reduce in ("none", "max"):
        plan = bp.BeamformPlan(mv, w_ph, w_src, feats.shape[-1],
                               reduce=reduce, device=card, **kw)
        g = plan.fold_and_pad(feats)
        launches = bp.bp_beam.launches
        got = plan.call_folded(g)
        assert bp.bp_beam.launches == launches + 1
        want = bp.beamform_plain(g, plan.tables, reduce=reduce)
        torch.cuda.synchronize()
        if reduce == "none":
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
            continue
        torch.testing.assert_close(got[0], want[0][: plan.n_samp],
                                   rtol=RTOL, atol=ATOL)
        assert torch.equal(got[1], want[1][: plan.n_samp])
        v2, i2 = plan.call_folded_chunked(g, 3)
        assert torch.equal(v2, got[0]) and torch.equal(i2, got[1])
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_weighted", "small_buffers"])
def test_bp_kernel_with_staged_rows_matches_plain_on_card(card, case,
                                                          monkeypatch):
    """Every one of 32 stations weighted: a tile's 64 rows are staged in
    parts, and with the ring's slots cut small on purpose in many parts."""
    feats, mv, w_ph, w_src = _bp_problem(21, n_src=150, n_sta=32, max_mv=120)
    w_src[:] = 1.0 / 32
    if case == "small_buffers":
        monkeypatch.setattr(bp, "SMEM_LIMIT", 60_000)
    plan = _hold_bp_to_plain(card, feats, mv, w_ph, w_src)
    n_st = plan.tables.tile_stage.diff()
    assert int(n_st.max()) >= (2 if case == "all_weighted" else 10)


@pytest.mark.cuda
@pytest.mark.parametrize("oob", ["strict", "flexible"])
@pytest.mark.parametrize("case", ["wide_rows", "equal_moveouts",
                                  "widest_row", "far_apart_in_a_warp",
                                  "every_delta"])
def test_bp_kernel_rows_and_windows_on_card(card, case, oob):
    """The shapes a row and a warp's window of it can take: a
    station-phase staged as several rows (one moveout 60,000 samples from
    its tile's others), every source of a tile at the same moveouts (the
    two sources of a warp read one window, and their equal beams tie), a
    row at the largest spread one staged row may have, a warp's two
    sources far apart on every row (each an item of its own), and every
    difference between a warp's two sources from -WIN_D - 1 to WIN_D + 1
    (every block of the kernel's item loop)."""
    feats, mv, w_ph, w_src = _bp_problem(23, n_src=150, n_sta=6, max_mv=90)
    if case == "wide_rows":
        mv[1, 1, 0] = 60_000
        mv[5:9, 3, 1] += np.arange(4, dtype=np.int32) * (bp.ROW_CAP - 3)
    elif case == "equal_moveouts":
        mv[: bp.SRC_TILE] = mv[0]
        w_src[: bp.SRC_TILE] = w_src[0]
        mv[bp.SRC_TILE:, 3] = mv[bp.SRC_TILE, 3]
    elif case == "widest_row":
        mv[:, 1, 0] = np.maximum(mv[:, 1, 0], 3)
        mv[2, 1, 0], mv[11, 1, 0] = 3, 3 + bp.ROW_CAP - 4
    elif case == "far_apart_in_a_warp":
        mv[:, 1::2] += (120 * np.arange(mv.shape[0], dtype=np.int32)
                        % 1999)[:, None, None]
    else:
        mv = mv + 2 * bp.WIN_D
        pair = np.arange(mv.shape[0] // 2)
        mv[1::2] = mv[::2] + (pair % (2 * bp.WIN_D + 3)
                              - bp.WIN_D - 1)[:, None, None].astype(np.int32)
    plan = _hold_bp_to_plain(card, feats, mv, w_ph, w_src, out_of_bounds=oob)
    tab = plan.tables
    if case == "wide_rows":
        first = tab.ent_sp[: int(tab.stage_row[tab.tile_stage[1]])]
        assert int((first == 2).sum()) == 2 and int((first == 7).sum()) == 4
    elif case == "equal_moveouts":
        assert tab.n_items < 0.8 * tab.n_pairs
    elif case == "widest_row":
        assert int(tab.ent_span.max()) == bp.ROW_CAP - 1
        assert int((tab.ent_sp[: int(tab.stage_row[tab.tile_stage[1]])]
                    == 2).sum()) == 1
    elif case == "far_apart_in_a_warp":
        assert tab.n_items > 0.9 * tab.n_pairs
    else:
        codes = tab.prog.cpu().numpy()
        seen = set()
        for j in range(tab.n_stages):
            p = codes[4 * int(tab.stage_prog[j]):4 * int(tab.stage_prog[j + 1])]
            seen |= set(p[bp._head_words():].reshape(-1, 4)[:, 0].tolist())
        assert seen >= set(range(2 * bp.WIN_D + 2))


def _bp_world(seed=20, n_samp=12000, sr=25.0):
    """A 60-source line under 5 stations, in memory; two events a day."""
    rng = np.random.default_rng(seed)
    sta_x = np.linspace(0.0, 48.0, 5)
    src_x = np.linspace(0.0, 48.0, 60)
    dist = np.hypot(src_x[:, None] - sta_x[None, :], 8.0)
    names = [f"S{i}" for i in range(5)]
    tts = {"P": {s: dist[:, i] / 6.0 for i, s in enumerate(names)},
           "S": {s: dist[:, i] / 3.4 for i, s in enumerate(names)}}
    tt = TravelTimes.from_arrays(tts, {"longitude": src_x / 111.0,
                                       "latitude": np.zeros(60),
                                       "depth": np.full(60, 8.0)})
    tt.convert_to_samples(sr)
    net = Network.from_arrays(names, longitude=sta_x / 111.0,
                              latitude=np.zeros(5))
    days = {}
    for key, events in (("d1", [(3000, 11), (8000, 40)]),
                        ("d2", [(5003, 25), (10007, 52)])):
        x = 0.1 * rng.standard_normal((5, 3, n_samp), dtype=np.float32)
        for o, src in events:
            for s, sta in enumerate(names):
                for c, ph in ((2, "P"), (0, "S"), (1, "S")):
                    a = o + int(tt.travel_times_samp[ph][sta][src])
                    x[s, c, a - 6: a + 7] += 8.0 * np.hanning(13)
        days[key] = x

    def reader(where, starttime=None, endtime=None, **kw):
        st = Stream()
        for s, sta in enumerate(names):
            for c, comp in enumerate("NEZ"):
                st += Trace(days[where][s, c], station=sta,
                            channel="HH" + comp, sampling_rate=sr,
                            starttime=0.0)
        return st

    def make_data(key):
        return Data("1970-01-01", key, reader, duration=n_samp / sr,
                    sampling_rate=sr).read_waveforms()

    return net, tt, make_data


@pytest.mark.cuda
def test_backproject_day_on_card_matches_cpu(card):
    """The whole BP day (envelopes, kernel, threshold, peaks) on the card
    gives the CPU run's detections."""
    net, tt, make_data = _bp_world()
    cfg = Config(sampling_rate_hz=25.0)
    found = {}
    for dev in ("cpu", "cuda"):
        launches = bp.bp_beam.launches
        out = workflow.scan_days(["d1", "d2"], make_data, cfg=cfg,
                                 stage="bp", network=net, travel_times=tt,
                                 device=dev, num_closest_stations=4,
                                 threshold_window_sec=120.0)
        assert (bp.bp_beam.launches - launches >= 2) == (dev == "cuda")
        found[dev] = {d: [(round(e.origin_time_epoch * 25.0),
                           e.aux_data["source_index"],
                           e.aux_data["maxbeam"]) for e in evs]
                      for d, evs in out.items()}
    for d in ("d1", "d2"):
        assert [x[:2] for x in found["cuda"][d]] == [
            x[:2] for x in found["cpu"][d]]
        np.testing.assert_allclose([x[2] for x in found["cuda"][d]],
                                   [x[2] for x in found["cpu"][d]],
                                   rtol=1e-4, atol=1e-5)
    assert {x[0] for x in found["cuda"]["d1"]} >= {3000, 8000}


@pytest.mark.cuda
@pytest.mark.parametrize("target_sr", [None, 100.0])
def test_preprocess_and_normalize_on_card_match_float64(card, target_sr):
    """`preprocess_batch` and `normalize_batch` on the card (f32) against
    the same functions in float64 on the CPU: within 1e-4 of the traces'
    maximum."""
    rng = np.random.default_rng(30)
    x = (rng.normal(size=(3, 3, 60000)) * 50 + 7).astype(np.float32)
    got = signal.preprocess_batch(x, 25.0, 2.0, 12.0, target_sr=target_sr,
                                  device=card)
    want = signal.preprocess_batch(torch.from_numpy(x.astype(np.float64)),
                                   25.0, 2.0, 12.0, target_sr=target_sr)
    assert got.is_cuda and got.dtype == torch.float32
    assert float((got.cpu().double() - want).abs().max()) <= (
        1e-4 * float(want.abs().max()))
    got = picks.normalize_batch(want.float().to(card))
    want = picks.normalize_batch(want)
    assert got.is_cuda and got.dtype == torch.float32
    assert float((got.cpu().double() - want).abs().max()) <= (
        1e-4 * float(want.abs().max()))


def _seisbench_model(seed):
    torch.manual_seed(seed)
    model = phasenet.SeisBenchPhaseNet()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0.0, 0.3, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return model.eval()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phasenet", "seisbench"])
def test_phasenet_on_card_matches_float64(card, arch):
    """Both architectures' day probabilities on the card (f32, IEEE
    convolutions even with the global TF32 flag on) against float64 on the
    CPU within 1e-5; the flag is the caller's again afterwards; the host
    normalized route agrees too."""
    if arch == "phasenet":
        model = phasenet.init_phasenet(torch.Generator().manual_seed(31),
                                       device=card)
    else:
        model = _seisbench_model(32).to(card)
    model64 = phasenet.SeisBenchPhaseNet() if arch != "phasenet" else (
        phasenet.PhaseNet())
    model64.load_state_dict(model.state_dict())
    model64 = model64.double().eval()
    x = np.random.default_rng(33).normal(size=(2, 3, 9000)).astype(
        np.float32)
    x[1] *= 30.0
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = phasenet.phasenet_probas_device(model, x)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    want = phasenet.phasenet_probas_device(
        model64, torch.from_numpy(x.astype(np.float64)))
    assert got.is_cuda and got.dtype == torch.float32
    assert float((got.cpu().double() - want).abs().max()) <= 1e-5
    assert float((got.sum(dim=1) - 1.0).abs().max()) <= 1e-5
    host = phasenet.sliding_window_probas(model, x)
    assert float(np.abs(host - want.numpy()).max()) <= 1e-5


@pytest.mark.cuda
def test_phasenet_backproject_day_on_card_matches_cpu(card):
    """A PhaseNet BP day (preprocessing, probabilities, kernel #3, the
    threshold, the peaks) on the card gives the CPU run's detections, one
    set of weights on both."""
    net, tt, make_data = _bp_world(seed=34)
    cfg = Config(sampling_rate_hz=25.0, n_dev_bp_threshold=3.0)
    model = phasenet.init_phasenet(torch.Generator().manual_seed(35),
                                   device="cpu")
    found = {}
    for dev in ("cpu", "cuda"):
        pn = workflow.phasenet_feature_fn(copy.deepcopy(model).to(dev))

        def feature_fn(arr):
            return pn(signal.preprocess_batch(arr, 25.0, 2.0, 12.0,
                                              device=dev))

        launches = bp.bp_beam.launches
        _, dets = workflow.backproject_day(
            make_data("d1"), net, tt, cfg=cfg, device=dev,
            feature_fn=feature_fn, num_closest_stations=4,
            threshold_window_sec=120.0)
        assert (bp.bp_beam.launches - launches >= 1) == (dev == "cuda")
        found[dev] = [(round(e.origin_time_epoch * 25.0),
                       e.aux_data["source_index"], e.aux_data["maxbeam"])
                      for e in dets]
    assert found["cpu"]
    assert [x[:2] for x in found["cuda"]] == [x[:2] for x in found["cpu"]]
    np.testing.assert_allclose([x[2] for x in found["cuda"]],
                               [x[2] for x in found["cpu"]],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_eikonal_on_card_matches_cpu(card):
    """The eikonal solver on the card: a batch of f32 solves within 1e-5 s
    of the CPU's (IEEE ops on both), each batch row the one-grid solve,
    and float64 within 1e-9 s; the station tables equal the CPU's."""
    from seismic_bpmf_tpu_torch.location import eikonal

    v = np.full((21, 19, 23), 4.0, np.float32)
    v[:, :, 11:] = 6.5
    srcs = [(0, 0, 0), (10, 9, 3), (20, 18, 22)]
    got = eikonal.travel_time_grids([v] * 3, srcs, 0.8, n_iters=120,
                                    device=card)
    want = eikonal.travel_time_grids([v] * 3, srcs, 0.8, n_iters=120,
                                     device="cpu")
    assert got.is_cuda and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-5)
    one = eikonal.travel_time_grid(v, srcs[1], 0.8, n_iters=120,
                                   device=card)
    np.testing.assert_array_equal(one, got[1].cpu().numpy())
    g64 = eikonal.travel_time_grids([v] * 3, srcs, 0.8, n_iters=120,
                                    device=card, dtype=torch.float64)
    w64 = eikonal.travel_time_grids([v] * 3, srcs, 0.8, n_iters=120,
                                    device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(g64.cpu().numpy(), w64.numpy(), rtol=0,
                               atol=1e-9)
    net = Network.from_arrays(["A", "B"], latitude=[40.0, 40.2],
                              longitude=[30.05, 30.3])
    lons, lats = np.linspace(30.0, 30.4, 9), np.linspace(40.0, 40.3, 7)
    deps = np.linspace(0.0, 10.0, 6)
    models = eikonal.layered_velocity_grid(
        np.array([0.0, 5.0]), np.array([5.0, 6.0]), np.array([2.9, 3.4]),
        deps, (9, 7))
    tc, _ = eikonal.build_travel_time_tables(net, lons, lats, deps, models,
                                             n_iters=60, device=card)
    tp, _ = eikonal.build_travel_time_tables(net, lons, lats, deps, models,
                                             n_iters=60, device="cpu")
    for ph in tp:
        for sta in tp[ph]:
            np.testing.assert_allclose(tc[ph][sta], tp[ph][sta], rtol=0,
                                       atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["spatial", "temporal"])
def test_relocate_beam_on_card_matches_cpu(card, method):
    """A small dense world scanned and its best detection relocated on the
    card (kernel #3, the flexible policy, the device argmax for 'spatial')
    and on the CPU: the same hypocentre and origin time, the uncertainties
    within 1e-5 relative, the same arrival-time table."""
    from seismic_bpmf_tpu_torch.ops.cf import saturated_envelopes
    from seismic_bpmf_tpu_torch.tools.dense_world import build_world

    w = build_world(n_sta=12, n_src=3000, scan_sec=600.0)
    env = saturated_envelopes(w.data.get_np_array(w.network.stations),
                              device="cpu")[0]
    out = {}
    for dev in ("cpu", "cuda"):
        bf, dets = workflow.backproject_day(
            w.data, w.network, w.travel_times, cfg=w.cfg, device=dev,
            num_closest_stations=12, minimum_interevent_time=20.0,
            threshold_window_sec=600.0)
        ev = copy.deepcopy(max(dets, key=lambda d: d.aux_data["maxbeam"]))
        k0 = int((ev.origin_time_epoch - w.data.date_epoch - 10.0) * 25.0)
        launches = bp.bp_beam.launches
        ev.relocate(bf, env[..., k0:k0 + 1500].to(dev), routine="beam",
                    uncertainty_method=method,
                    features_starttime=w.data.date_epoch + k0 / 25.0)
        assert (bp.bp_beam.launches - launches == 1) == (dev == "cuda")
        assert not hasattr(bf, "beam")
        out[dev] = ev
    c, g = out["cpu"], out["cuda"]
    assert (g.longitude, g.latitude, g.depth, g.origin_time) == (
        c.longitude, c.latitude, c.depth, c.origin_time)
    for k in ("hmax_unc", "vmax_unc", "maxbeam_reloc"):
        np.testing.assert_allclose(g.aux_data[k], c.aux_data[k], rtol=1e-5)
    for col in c.arrival_times_table.columns:
        np.testing.assert_array_equal(g.arrival_times_table[col],
                                      c.arrival_times_table[col])


@pytest.mark.cuda
def test_response_removal_and_spectra_on_the_card(card):
    """The magnitude path's device work: the response deconvolution
    (float32 / complex64) within 1e-5 of the CPU result's maximum, and the
    tapered float64 FFT spectra within 1e-10 (relative), at the shape the
    path gives them (10 stations x 3 components x 400 samples)."""
    from seismic_bpmf_tpu_torch.data import ChannelResponse
    from seismic_bpmf_tpu_torch.ops import response
    from seismic_bpmf_tpu_torch.source import Spectrum
    from seismic_bpmf_tpu_torch.tools import magnitude_world as mw

    rng = np.random.default_rng(8)
    counts = rng.normal(size=(10, 3, 400)).cumsum(-1) * 50.0
    resp = [ChannelResponse(sensitivity=float(s), sensitivity_frequency=5.0,
                            poles=mw.POLES, zeros=mw.ZEROS,
                            normalization_factor=mw.a0())
            for s in rng.uniform(1e8, 4e8, 30)]
    pre_filt = (0.2, 0.5, 45.0, 49.0)
    n0 = response.apply_spectral_filter.launches
    got = response.remove_response_arr(counts, resp, 100.0,
                                       pre_filt=pre_filt, device=card)
    assert response.apply_spectral_filter.launches == n0 + 1
    want = response.remove_response_arr(counts, resp, 100.0,
                                        pre_filt=pre_filt, device="cpu")
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    windows = {p: got * (1.0 + k) for k, p in enumerate(("noise", "p", "s"))}
    stations = [f"S{i}" for i in range(10)]
    for stack in (True, False):
        a, b = Spectrum(), Spectrum()
        a.compute_spectrum(windows, stations, 100.0, stack_components=stack,
                           device=card)
        b.compute_spectrum(windows, stations, 100.0, stack_components=stack,
                           device="cpu")
        for p in windows:
            x, y = a.spectra[p].values, b.spectra[p].values
            assert np.abs(x - y).max() <= 1e-10 * np.abs(y).max()


def _adam_first(g, lr):
    """Adam's first update from a gradient (torch's and optax's)."""
    return lr * g / (g.abs() + 1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phasenet", "seisbench"])
def test_train_step_on_card_matches_cpu(card, arch):
    """One `make_train_step` step from one set of weights on one batch, on
    the card (IEEE f32 convolutions, with the global TF32 flag on) and on
    the CPU: the loss within 1e-5, every gradient within 1e-4 of the
    largest, the running statistics within 1e-4 (relative), and the
    weights within 1e-6 of the difference Adam's first update makes of the
    two gradients (where |g| is rounding noise, lr sign(g) may flip)."""
    lr = 1e-3
    model = (phasenet.init_phasenet(torch.Generator().manual_seed(41),
                                    device="cpu") if arch == "phasenet"
             else _seisbench_model(42))
    rng = np.random.default_rng(43)
    x = torch.from_numpy(rng.normal(size=(8, 3, 3001)).astype(np.float32))
    picks = np.stack([rng.uniform(200, 1500, 8), rng.uniform(1600, 2800, 8)],
                     axis=1)
    labels = torch.from_numpy(phasenet.gaussian_pick_labels(picks, 3001))
    out = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
        opt = torch.optim.Adam(m.parameters(), lr=lr)
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            loss = phasenet.make_train_step(m, opt)((x.to(dev),
                                                     labels.to(dev)))
            assert torch.backends.cudnn.allow_tf32
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        out[dev] = (float(loss),
                    {n: p.grad.double().cpu() for n, p in m.named_parameters()},
                    {n: t.double().cpu() for n, t in m.state_dict().items()
                     if t.is_floating_point()})
    (lh, gh, wh), (lc, gc, wc) = out["cpu"], out["cuda"]
    assert abs(lc - lh) <= 1e-5
    scale = max(float(g.abs().max()) for g in gh.values())
    for n in gh:
        assert float((gc[n] - gh[n]).abs().max()) <= 1e-4 * scale, n
        want = _adam_first(gh[n], lr) - _adam_first(gc[n], lr)
        assert float(((wc[n] - wh[n]) - want).abs().max()) <= 1e-6, n
    for n in wh:
        if "running_" in n:
            rel = (wc[n] - wh[n]).abs() / wh[n].abs().clamp(min=1e-3)
            assert float(rel.max()) <= 1e-4, n


@pytest.mark.cuda
def test_train_phasenet_and_checkpoint_on_card(card, tmp_path):
    """`train_phasenet` on the card: its weights stay there, the loss
    falls; a checkpoint loaded into a fresh model on the card gives the
    same probabilities bit for bit."""
    from seismic_bpmf_tpu_torch.models import (
        load_variables, save_variables, train_phasenet,
    )

    rng = np.random.default_rng(44)
    x = rng.normal(size=(32, 3, 3001)).astype(np.float32)
    picks = np.stack([rng.uniform(200, 1500, 32),
                      rng.uniform(1600, 2800, 32)], axis=1)
    for k, (p, s) in enumerate(picks.astype(int)):
        x[k, 2, p: p + 40] += 5.0 * np.hanning(40)
        x[k, :2, s: s + 40] += 5.0 * np.hanning(40)
    model, _, losses = train_phasenet(x, picks, n_epochs=3, batch_size=8,
                                      verbose=False)
    assert next(model.parameters()).is_cuda
    assert losses[-1] < losses[0]
    path = save_variables(str(tmp_path / "ckpt"), model)
    back = phasenet.PhaseNet().to(card)
    load_variables(path, target=back)
    day = rng.normal(size=(2, 3, 20000)).astype(np.float32)
    assert torch.equal(phasenet.phasenet_probas_device(model, day),
                       phasenet.phasenet_probas_device(back, day))


@pytest.mark.cuda
def test_svdwf_on_card_matches_the_host_version(card):
    """The batched float64 SVD and Wiener filter on the card against the
    scipy route on the host, within 1e-9 of the stacks' maximum; one SVD
    launch on the card for every panel."""
    from seismic_bpmf_tpu_torch.utils import stacking

    rng = np.random.default_rng(45)
    t = np.arange(500) / 25.0
    burst = np.sin(2 * np.pi * 4.0 * t) * np.exp(-((t - 8.0) ** 2))
    panels = (rng.uniform(0.5, 2.0, size=(30, 12, 1)) * burst
              + 0.3 * rng.normal(size=(30, 12, 500)))
    for kw in ({}, dict(freqmin=2.0, freqmax=10.0, sampling_rate=25.0,
                        max_singular_values=3, expl_var=0.8)):
        launches = stacking.svdwf_panels.launches
        got = stacking.svdwf_panels(panels, device=card, **kw)
        assert stacking.svdwf_panels.launches == launches + 1
        want = stacking.svdwf_panels_host(panels, **kw)
        assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


@pytest.mark.cuda
def test_a_300_template_scan_crosses_a_plan_cut_on_card(card):
    """300 tid-distinct copies of the year world's two templates on a
    3,600 s day at 'screen': two plans (256 + 44) in one extraction chunk,
    every template finds both injected events within a sample, and the
    detections equal those of the two sub-banks scanned alone."""
    from seismic_bpmf_tpu_torch.tools import year_scan
    from seismic_bpmf_tpu_torch.tools.year_world import (
        T0_EPOCH, build_bank, build_world,
    )

    w = build_world(day_sec=3600.0)
    bank = build_bank(w, 300)
    noise = np.random.default_rng(46).normal(size=500).astype(np.float32)
    sr = w.cfg.sampling_rate_hz

    def scan(tg):
        launches = mf.mf_cc.launches
        res = year_scan.campaign(w, tg, ["day000"], device=card,
                                 white_noise=noise)["day000"]
        return mf.mf_cc.launches - launches, {
            str(t): [round((e.origin_time_epoch - T0_EPOCH) * sr)
                     for e in evs] for t, evs in res.items()}

    n, whole = scan(bank)
    assert n == 2 and sorted(whole, key=int) == [str(i) for i in range(300)]
    for tid, hits in whole.items():
        for ev_t in w.event_times:
            assert sum(abs(i - ev_t * sr) <= 1 for i in hits) == 1, (tid,
                                                                     hits)
    parts = {}
    for lo, hi in ((0, 256), (256, 300)):
        parts.update(scan(TemplateGroup(bank.templates[lo:hi],
                                        w.network))[1])
    assert parts == whole


MESHES = {"tp2_time4": {"tp": 2, "time": 4}, "ragged_tp3_time2":
          {"tp": 3, "time": 2}}


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", list(MESHES))
@pytest.mark.parametrize("precision", ["highest", "default", "high"])
def test_sharded_mf_kernels_match_unsharded_on_card(card, mesh_shape,
                                                    precision):
    """Each rung's kernel per (template shard, time shard) of a virtual
    mesh on the one card, at the shard's lag offset: the stitched CC is
    the unsharded kernel's, bit for bit (every shard's lag tiles are the
    unsharded scan's, and the window sums depend on the window only)."""
    from seismic_bpmf_tpu_torch.parallel import make_mesh, sharded

    tp, mv, w, data = _bank(21, n_tp=40, L=37, n_samp=6000)
    shape = MESHES[mesh_shape]
    mesh = make_mesh(shape, devices=[card] * (shape["tp"] * shape["time"]))
    want = mf.matched_filter(tp, mv, w, data, precision=precision,
                             device=card)
    wrapper = {"highest": mf.mf_cc_highest, "default": mf.mf_cc,
               "high": mf.mf_cc_split}[precision]
    plan = sharded.ShardedMatchedFilterPlan(tp, mv, w, data.shape[-1], mesh,
                                            precision=precision)
    day = plan.pad_data(data)
    launches = wrapper.launches
    got = plan(day)
    n_shards = len(plan.shards) * sum(
        plan.n_lags(t) > 0 for t in range(plan.layout.n_t))
    assert wrapper.launches == launches + n_shards > launches + 1
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got, want), float((got - want).abs().max())
    got2 = sharded.matched_filter_sharded_pallas(tp, mv, w, data, mesh,
                                                 step=3, precision=precision)
    assert torch.equal(got2, want[:, ::3])


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", [{"src": 2, "time": 4},
                                        {"src": 3, "time": 2},
                                        {"src": 1, "time": 4}])
@pytest.mark.parametrize("oob", ["strict", "flexible"])
def test_sharded_bp_kernel_matches_unsharded_on_card(card, mesh_shape, oob):
    """The BP kernel per (source shard, time shard) of a virtual mesh, each
    time shard holding only its columns and a halo from its absolute
    origin: 'max' equal to the unsharded kernel's bit for bit, the tie
    between the copies of source 9 (40 and 74, in another source shard)
    going to 9; 'none' equal block by block."""
    from seismic_bpmf_tpu_torch.parallel import make_mesh, sharded

    feats, mv, w_ph, w_src = _bp_problem(19)
    n_dev = int(np.prod(list(mesh_shape.values())))
    mesh = make_mesh(mesh_shape, devices=[card] * n_dev)
    for reduce in ("max", "none"):
        want = bp.beamform(feats, mv, w_ph, w_src, reduce=reduce,
                           out_of_bounds=oob, device=card)
        plan = sharded.ShardedBeamformPlan(mv, w_ph, w_src, feats.shape[-1],
                                           mesh, reduce=reduce,
                                           out_of_bounds=oob)
        launches, calls = bp.bp_beam.launches, bp.beamform_plain.calls
        got = plan(feats)
        assert bp.bp_beam.launches > launches + 1
        assert bp.beamform_plain.calls == calls
        torch.cuda.synchronize()
        if reduce == "none":
            assert torch.equal(got, want)
            continue
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert not bool(torch.isin(got[1], torch.tensor(
            [40, mv.shape[0] - 1], device=card)).any())


# launches (kernels and graphs) a warm step of the sharded step issues
# from the host at full width on a virtual {"data": 4} mesh: the CUDA
# graph of the shards' forward and backward and Adam's seven foreach
# kernels (the eager step: 1,480)
SHARDED_STEP_LAUNCHES = 8


def _adam_update(g, m, v, t, lr):
    """torch's Adam update (betas 0.9, 0.999, eps 1e-8) of gradient `g`
    from moments `m`, `v` at its `t`-th step, in float64."""
    m, v = 0.9 * m + 0.1 * g, 0.999 * v + 0.001 * g * g
    return lr * (m / (1 - 0.9 ** t)) / ((v / (1 - 0.999 ** t)).sqrt() + 1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("n_dev, width", [(2, "depth 3"), (4, "depth 3"),
                                          (4, "full")])
def test_sharded_train_step_on_a_virtual_card_mesh(card, n_dev, width):
    """`make_sharded_train_step` on a virtual mesh of the card against the
    unsharded step on the card, three steps on three batches, the sharded
    model's weights, running statistics and Adam moments set in place to
    the unsharded model's before each (the graph reads them where they
    lie): after each step the loss within 1e-5, the gradients within 1e-4
    of the largest, the weights within 1e-6 beyond Adam's update of the
    two gradients, the running statistics within 1e-4 (chip_smoke.py
    phase 22's gates).  At full width (`PhaseNet()`, 32 windows of 3,001)
    the sharded step takes its batches from the host, and a warm step
    issues at most `SHARDED_STEP_LAUNCHES` launches: it is captured."""
    from seismic_bpmf_tpu_torch.models import training
    from seismic_bpmf_tpu_torch.parallel import make_mesh
    from seismic_bpmf_tpu_torch.tools.mesh_days import step_profile

    full = width == "full"
    n, w = (32, phasenet.WINDOW) if full else (8, 600)
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(3):
        x = torch.from_numpy(rng.normal(size=(n, 3, w)).astype(np.float32))
        picks_ = np.stack([rng.uniform(0.1 * w, 0.45 * w, n),
                           rng.uniform(0.5 * w, 0.9 * w, n)], 1)
        batches.append((x, torch.from_numpy(
            phasenet.gaussian_pick_labels(picks_, w))))
    models = [phasenet.init_weights(
        phasenet.PhaseNet() if full else phasenet.PhaseNet(depth=3),
        torch.Generator().manual_seed(0)).to(card) for _ in range(2)]
    opts = [torch.optim.Adam(m.parameters(), lr=1e-3) for m in models]
    mesh = make_mesh({"data": n_dev}, devices=[card] * n_dev)
    steps = [phasenet.make_train_step(models[0], opts[0]),
             training.make_sharded_train_step(models[1], opts[1], mesh)]
    m, sm = models
    for t, (x, y) in enumerate(batches, 1):
        with torch.no_grad():
            for p, sp in zip(m.parameters(), sm.parameters()):
                sp.copy_(p)
                for key in ("exp_avg", "exp_avg_sq"):
                    if p in opts[0].state:
                        opts[1].state[sp][key].copy_(opts[0].state[p][key])
            for b, sb in zip(m.buffers(), sm.buffers()):
                sb.copy_(b)
        moments = {k: [opts[0].state[p][key].double().clone()
                       if p in opts[0].state else 0.0
                       for key in ("exp_avg", "exp_avg_sq")]
                   for k, p in m.named_parameters()}
        loss = float(steps[0]((x.to(card), y.to(card))))
        sloss = float(steps[1]((x, y) if full else (x.to(card), y.to(card))))
        assert abs(sloss - loss) <= 1e-5, t
        grads = {k: p.grad.double() for k, p in m.named_parameters()}
        sgrads = {k: p.grad.double() for k, p in sm.named_parameters()}
        scale = max(float(g.abs().max()) for g in grads.values())
        sd, ssd = m.state_dict(), sm.state_dict()
        for k, (mom, vel) in moments.items():
            assert float((sgrads[k] - grads[k]).abs().max()) <= \
                1e-4 * scale, (t, k)
            du = (_adam_update(grads[k], mom, vel, t, 1e-3)
                  - _adam_update(sgrads[k], mom, vel, t, 1e-3))
            assert float(((ssd[k].double() - sd[k].double()) - du)
                         .abs().max()) <= 1e-6, (t, k)
        for k in sd:
            if "running" in k:
                assert torch.allclose(ssd[k], sd[k], rtol=1e-4,
                                      atol=1e-6), (t, k)
    if full:
        prof = step_profile(steps[1], batches[0], [card])
        assert prof["launches"] <= SHARDED_STEP_LAUNCHES, prof


@pytest.mark.cuda
def test_mesh_days_on_every_card():
    """`tools/mesh_days.py` on a cut world over every visible card: the
    sharded MF (all three builds) and BP days bit-equal to one card's,
    every shard's tensors on its card, each card launching each kernel,
    the campaigns' detections and the sharded training steps.  Needs two
    cards or more, e.g. four H100s of one host."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    from seismic_bpmf_tpu_torch.tools import mesh_days

    assert mesh_days.main(["--cut"]) == 0


@pytest.mark.cuda
def test_sharded_training_step_on_every_card_is_no_slower_than_one():
    """ROADMAP Queue 3 #5: a `make_sharded_train_step` step of 256
    windows split over every visible card takes no longer than the
    unsharded step on one card.  The eager step failed it on four H100s
    (58.1-64.5 ms against 37.0-37.6): the shards' ~1,450 launches a step
    came from one host thread, where the captured step issues one graph
    launch.  Needs two cards or more."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    from seismic_bpmf_tpu_torch.models import training
    from seismic_bpmf_tpu_torch.parallel import make_mesh
    from seismic_bpmf_tpu_torch.tools.mesh_days import wall_ms

    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n, w = 256 // len(devs) * len(devs), phasenet.WINDOW
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(n, 3, w)).astype(np.float32))
    picks_ = np.stack([rng.uniform(200, 1400, n),
                       rng.uniform(1500, 2800, n)], 1)
    batch = (x.to(devs[0]),
             torch.from_numpy(phasenet.gaussian_pick_labels(picks_, w))
             .to(devs[0]))
    ms = {}
    for where in ("one card", "mesh"):
        m = phasenet.init_weights(phasenet.PhaseNet(),
                                  torch.Generator().manual_seed(0))
        m = m.to(devs[0])
        opt = torch.optim.Adam(m.parameters(), lr=1e-3)
        step = (phasenet.make_train_step(m, opt) if where == "one card"
                else training.make_sharded_train_step(
                    m, opt, make_mesh({"data": len(devs)}, devs)))
        ms[where] = wall_ms(lambda: step(batch), devs, 5)
    assert ms["mesh"] <= ms["one card"], (
        f"a step of {n} windows on {len(devs)} cards {ms['mesh']:.2f} ms, "
        f"on one {ms['one card']:.2f}")
