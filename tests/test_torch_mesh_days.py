"""The worlds that `chip_smoke.py` and `tools/mesh_days.py` share
(`tools/mf_world.py`, `tools/bp_world.py`) at a cut size, and the
four-card tool's mesh shapes and per-card launch check (the tool itself
runs on the cards: tests/test_torch_cuda.py).
"""

import collections
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seismic_bpmf_tpu_torch.tools import mesh_days  # noqa: E402
from seismic_bpmf_tpu_torch.tools.bp_world import BURST, BPWorld  # noqa: E402
from seismic_bpmf_tpu_torch.tools.mf_world import (  # noqa: E402
    L, N_COMP, N_STA, SR, MFWorld, day_start,
)

SEED = 7


def test_mf_world_injects_its_events_and_cuts_its_bank():
    w = MFWorld(SEED, n_tp=3, day_sec=3000.0,
                repeats=[("d1", 1, 39000), ("d2", 2, 60000)])
    noise = {k: np.random.default_rng(SEED + 10 + k).standard_normal(
        (N_STA, N_COMP, w.n_samp), dtype=np.float32) for k in (1, 2)}
    d2 = w.day("d2") - noise[2]
    assert np.count_nonzero(d2) == np.count_nonzero(w.wave[2])
    s, c = 4, 1
    at = 60000 + w.mv[2, s, c]
    np.testing.assert_array_equal(w.day("d2")[s, c, at:at + L],
                                  noise[2][s, c, at:at + L] + w.wave[2, s, c])
    templates, tg = w.bank()
    assert templates.shape == (3, N_STA, N_COMP, L)
    at = w.origins[1] + w.mv[1, s, c]
    np.testing.assert_array_equal(templates[1, s, c],
                                  w.day("d1")[s, c, at:at + L])
    assert list(tg.tids) == ["0", "1", "2"]
    st = w.reader("memory/d2")
    assert len(st) == N_STA * N_COMP
    assert all(float(tr.stats.starttime) == day_start("d2") for tr in st)
    assert day_start("d2") - day_start("d1") == 86400.0


def test_bp_world_injects_bursts_at_the_arrivals():
    events = {"d1": [(5000, 17)]}
    w = BPWorld(SEED, n_src=200, n_sta=5, day_sec=800.0, events=events)
    assert w.mv.shape == (200, 5, 2) and w.w_src.shape == (200, 5)
    noise = np.random.default_rng(SEED + 21).standard_normal(
        (5, 3, w.n_samp), dtype=np.float32)
    x = w.day("d1") - noise
    for s, name in enumerate(w.stations):
        a = 5000 + int(w.travel.travel_times_samp["S"][name][17])
        np.testing.assert_allclose(x[s, 0, a - 6:a + 7], BURST, atol=1e-5)
    assert (np.count_nonzero(np.abs(x) > 1e-5)
            == 5 * 3 * np.count_nonzero(BURST))
    assert len(w.reader("bp/d1")) == 15


def test_the_tools_meshes_span_every_device():
    devs = [torch.device("cpu")] * 4
    for mesh in mesh_days.mf_meshes(devs).values():
        assert mesh.devices.size in (4, 8)
    shapes = [m.shape for m in mesh_days.mf_meshes(devs).values()]
    assert shapes == [{"tp": 2, "time": 2}, {"time": 4}, {"tp": 4},
                      {"tp": 2, "time": 4}]
    assert [m.shape for m in mesh_days.bp_meshes(devs).values()] == [
        {"src": 2, "time": 2}, {"src": 4}, {"time": 4}]


def test_each_card_must_launch():
    cards = [torch.device("cuda", i) for i in range(3)]
    wrapper = SimpleNamespace(launches_on=collections.Counter({0: 5, 1: 2}))
    before = {0: 4, 1: 2}
    with pytest.raises(AssertionError, match="no launch"):
        mesh_days.launched_everywhere(wrapper, before, cards[:2], "x")
    wrapper.launches_on.update({1: 1, 2: 1})
    assert mesh_days.launched_everywhere(wrapper, before, cards, "x") == {
        "cuda:0": 1, "cuda:1": 1, "cuda:2": 1}
