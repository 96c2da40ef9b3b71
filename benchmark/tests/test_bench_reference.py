"""The plain reference against hand-checked tiny cases: the CC of a
template by loops, and the beam by loops with its strict end and its
first argmax."""

import types

import numpy as np
import pytest
import torch

from benchmark.generators.pool import DayPool
from benchmark.reference import bp as ref_bp
from benchmark.reference import mf as ref_mf


def _mf_world(templates, moveouts, day):
    pool = DayPool([day], ["A", "B"], 25.0, "2012-07-26", 0.0, 1.0)
    return types.SimpleNamespace(
        templates=templates, moveouts=moveouts, pool=pool,
        sizes={"scan_kwargs": {"min_channels": 3, "min_stations": 2}})


def _pearson_sum(tpl, mv, w, x, lag):
    """sum_c w_c corr(template_c, x_c[lag + mv_c : + L]) by loops."""
    n, L = x.shape[-1], tpl.shape[-1]
    total = 0.0
    for s in range(tpl.shape[0]):
        for c in range(tpl.shape[1]):
            a = lag + mv[s, c]
            if w[s, c] == 0 or a < 0 or a + L > n:
                continue
            u = tpl[s, c] - tpl[s, c].mean()
            v = x[s, c, a:a + L] - x[s, c, a:a + L].mean()
            if (v * v).sum() <= 1e-10:
                continue
            total += w[s, c] * (u * v).sum() / np.sqrt((u * u).sum()
                                                       * (v * v).sum())
    return total


def test_the_cc_is_the_weighted_pearson_sum_by_loops():
    rng = np.random.default_rng(3)
    tpl = rng.normal(size=(1, 2, 3, 6)).astype(np.float32)
    tpl[0, 1, 0] = 0.0                                    # a channel w/o data
    mv = np.array([[[0, 2, 1], [3, 0, 5]]], np.int32)
    day = rng.normal(size=(2, 3, 20)).astype(np.float32)
    day[1, 2, 4:12] = 0.0                                 # a flat stretch
    ref = ref_mf.Reference(_mf_world(tpl, mv, day), "cpu")
    w = ref_mf.channel_weights(tpl, 3, 2)[0]
    assert w.sum() == pytest.approx(1.0) and w[1, 0] == 0.0
    x = ref_mf.normalized_day(day).astype(np.float64)
    lags = np.arange(0, 20)
    got = ref.cc_at(ref.day(0, False), np.zeros(20, int), lags)
    want = [_pearson_sum(tpl[0].astype(np.float64), mv[0], w, x, lag)
            for lag in lags]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_a_planted_copy_reads_one_and_bf16_rounds_as_torch():
    rng = np.random.default_rng(4)
    tpl = rng.normal(size=(1, 2, 3, 8)).astype(np.float32)
    mv = np.array([[[1, 0, 2], [0, 3, 1]]], np.int32)
    day = rng.normal(size=(2, 3, 40)).astype(np.float32) * 1e-3
    for s in range(2):
        for c in range(3):
            a = 10 + mv[0, s, c]
            day[s, c, a:a + 8] = tpl[0, s, c] * (1 + s + c)
    ref = ref_mf.Reference(_mf_world(tpl, mv, day), "cpu")
    assert ref.cc_at(ref.day(0, False), [0], [10])[0] == pytest.approx(1.0)
    x = rng.normal(size=1000).astype(np.float32)
    np.testing.assert_array_equal(
        ref_mf.bf16_round(x),
        torch.from_numpy(x).to(torch.bfloat16).float().numpy())


def _beam_by_loops(g, mv, w, t):
    """(n_src,) beam at lag t, strict: 0 where a used channel leaves."""
    n = g.shape[-1]
    out = np.zeros(mv.shape[0])
    for i in range(mv.shape[0]):
        acc, ok = 0.0, True
        for s in range(mv.shape[1]):
            if w[i, s] == 0:
                continue
            for p in range(2):
                j = t + mv[i, s, p]
                if j >= n:
                    ok = False
                else:
                    acc += w[i, s] * g[s, p, j]
        out[i] = acc if ok else 0.0
    return out


def test_the_beam_by_loops_with_its_strict_end_and_first_argmax():
    rng = np.random.default_rng(5)
    n_src, n_sta, n = 6, 4, 64
    tt = rng.uniform(0.0, 0.8, size=(n_src, n_sta, 2)).astype(np.float32)
    tt[3] = tt[1]                         # a copy: the first index wins
    day = rng.normal(size=(n_sta, 3, n)).astype(np.float32)
    world = types.SimpleNamespace(
        tt=tt, pool=DayPool([day], list("ABCD"), 25.0, "2012-07-26", 0.0,
                            1.0),
        sizes={"sampling_rate_hz": 25.0,
               "scan_kwargs": {"num_closest_stations": 2}})
    ref = ref_bp.Reference(world, "cpu")
    mv = ref_bp.moveouts_of(tt, 25.0)
    w = ref_bp.closest_station_weights(mv, 2)
    f = ref_bp.features(day, "cpu", "f64").numpy()
    g = np.stack([f[:, 2], f[:, 0] + f[:, 1]], axis=1)
    lags = np.arange(n)
    best, arg, picked = ref.beam_at(0, lags, pick=np.full(n, 3))
    for t in lags:
        beam = _beam_by_loops(g, mv, w, t)
        assert best[t].item() == pytest.approx(beam.max(), abs=1e-12)
        assert picked[t].item() == pytest.approx(beam[3], abs=1e-12)
        if beam.max() > 0:
            assert arg[t].item() == int(np.argmax(beam))
    assert best[-1].item() == 0.0 or mv.max() == 0


def test_bpmf_rounding_of_travel_times():
    tt = np.array([7.9999999, 0.04, 0.03, -0.05], np.float32)
    np.testing.assert_array_equal(ref_bp.tt_to_samples(tt, 25.0),
                                  [200, 1, 0, -1])


def test_features_are_mad_standardized_envelopes():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(1, 3, 256)).astype(np.float32)
    f = ref_bp.features(x, "cpu", "f64").numpy()
    from scipy.signal import hilbert

    env = np.abs(hilbert(x.astype(np.float64), axis=-1))
    med = np.median(env, axis=-1, keepdims=True)
    mad = np.median(np.abs(env - med), axis=-1, keepdims=True)
    np.testing.assert_allclose(f, (env - med) / mad, rtol=1e-10,
                               atol=1e-10)
