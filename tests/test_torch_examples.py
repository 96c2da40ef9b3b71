"""The port's example scripts against the JAX package's.

`examples/synthetic_day_torch.py` builds in memory the world that
`examples/synthetic_day.py` writes to HDF5 (seed 42; 20 stations x 3
components, 4 h at 25 Hz, 64 sources): the day bit for bit, the travel
times (float32) and their samples equal, the same network.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")
pytest.importorskip("pandas")

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synthetic_day_world_matches_the_jax_example(tmp_path):
    jex, tex = _load("synthetic_day"), _load("synthetic_day_torch")
    for k in ("SR", "DAY", "N_STA", "N_SRC", "EVENT_TIMES", "EVENT_SRC"):
        assert getattr(tex, k) == getattr(jex, k), k
    jcfg, jnet, jdata, jtts = jex.build_world(str(tmp_path))
    cfg, net, data, tts, _ = tex.build_world()
    assert vars(cfg) == vars(jcfg)
    assert list(net.stations) == list(jnet.stations)
    for k in ("latitude", "longitude", "depth"):
        np.testing.assert_array_equal(getattr(net, k),
                                      np.asarray(getattr(jnet, k)))
    stations = list(net.stations)
    day, jday = data.get_np_array(stations), jdata.get_np_array(stations)
    assert day.shape == jday.shape == (20, 3, int(4 * 3600 * 25))
    np.testing.assert_array_equal(day, jday)
    assert data.date == np.datetime64(jdata.date, "ns")
    for ph in ("P", "S"):
        for s in stations:
            got, want = tts.travel_times[ph][s], jtts.travel_times[ph][s]
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(tts.travel_times_samp[ph][s],
                                          jtts.travel_times_samp[ph][s])
    for k in ("longitude", "latitude", "depth"):
        np.testing.assert_array_equal(tts.source_coordinates[k],
                                      np.asarray(jtts.source_coordinates[k]))
