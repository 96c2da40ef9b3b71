"""The port's PhaseNet (`models/phasenet.py`) against the JAX package's
Flax models, on the CPU.

- Forward parity in float64, atol 1e-10: the port's `PhaseNet` with
  `from_flax_variables` against Flax `PhaseNet` under `jax.enable_x64`,
  on lengths 3001 and 3072 (random BatchNorm statistics, so every BN is
  exercised); the port's `SeisBenchPhaseNet` with a random SeisBench-layout
  state dict loaded as it is, against Flax `SeisBenchPhaseNet` with the
  same dict through the JAX `convert_seisbench_weights`.
- Serving at float32, atol 1e-5: `phasenet_probas_device` and
  `sliding_window_probas` against the JAX functions on (2, 3, 8000).
- A state dict through `.npz` and `.pt` files gives the same model.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch import nn  # noqa: E402

from seismic_bpmf_tpu.models import phasenet as jpn  # noqa: E402
from seismic_bpmf_tpu_torch.models import phasenet as tpn  # noqa: E402

ATOL64, ATOL32 = 1e-10, 1e-5


def _flax_variables(seed, dtype=np.float64):
    """Flax PhaseNet variables with random BatchNorm statistics and
    affines, as numpy arrays of `dtype`."""
    _, variables = jpn.init_phasenet(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    draw = {"var": lambda s: rng.uniform(0.5, 2.0, s),
            "mean": lambda s: rng.normal(0.0, 0.3, s),
            "scale": lambda s: rng.normal(1.0, 0.2, s),
            "bias": lambda s: rng.normal(0.0, 0.2, s)}

    def walk(d):
        return {k: walk(v) if isinstance(v, dict) else
                (draw[k](np.shape(v)) if k in draw else np.asarray(v))
                .astype(dtype) for k, v in d.items()}

    return walk(jax.tree.map(np.asarray, variables))


def _seisbench_state_dict(seed, dtype=torch.float64):
    """A random SeisBench-layout state dict (random BN statistics)."""
    torch.manual_seed(seed)
    model = tpn.SeisBenchPhaseNet().to(dtype)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm1d):
                m.running_mean.normal_(0.0, 0.3, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
                m.weight.normal_(1.0, 0.2, generator=g)
                m.bias.normal_(0.0, 0.2, generator=g)
    return model.state_dict()


def _port(arch, state_dict, dtype=torch.float64):
    model = (tpn.PhaseNet() if arch == "phasenet"
             else tpn.SeisBenchPhaseNet()).to(dtype)
    model.load_state_dict(state_dict)
    return model.eval()


@pytest.mark.parametrize("n", [3001, 3072])
def test_phasenet_forward_matches_flax_float64(n):
    variables = _flax_variables(1)
    model = _port("phasenet", tpn.from_flax_variables(variables))
    x = np.random.default_rng(2).normal(size=(2, 3, n))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jpn.PhaseNet().apply(
            variables, np.transpose(x, (0, 2, 1)), train=False))
    np.testing.assert_allclose(got, want.transpose(0, 2, 1), rtol=0,
                               atol=ATOL64)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-12)


@pytest.mark.parametrize("n", [3001, 3072])
def test_seisbench_forward_matches_flax_float64(n):
    sd = _seisbench_state_dict(3)
    model = _port("seisbench", sd)
    variables = jpn.convert_seisbench_weights(sd)
    # the port's converter is the inverse of the JAX one
    back = tpn.from_flax_variables(variables, arch="seisbench")
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k].to(sd[k].dtype), sd[k]), k
    x = np.random.default_rng(4).normal(size=(2, 3, n))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        want = np.asarray(jpn.SeisBenchPhaseNet().apply(
            v64, np.transpose(x, (0, 2, 1)), train=False))
    np.testing.assert_allclose(got, want.transpose(0, 2, 1), rtol=0,
                               atol=ATOL64)


def _pair(arch):
    """(JAX model, its variables, the port's f32 model) with one set of
    weights."""
    if arch == "phasenet":
        variables = _flax_variables(5, np.float32)
        return (jpn.PhaseNet(), variables,
                _port(arch, tpn.from_flax_variables(variables),
                      torch.float32))
    sd = _seisbench_state_dict(6, torch.float32)
    return (jpn.SeisBenchPhaseNet(), jpn.convert_seisbench_weights(sd),
            _port(arch, sd, torch.float32))


@pytest.mark.parametrize("arch", ["phasenet", "seisbench"])
def test_serving_matches_jax_float32(arch):
    jmodel, variables, model = _pair(arch)
    x = np.random.default_rng(7).normal(size=(2, 3, 8000)).astype(np.float32)
    x[1] *= 40.0
    want_dev = np.asarray(jpn.phasenet_probas_device(jmodel, variables, x))
    got_dev = tpn.phasenet_probas_device(model, x)
    assert got_dev.dtype == torch.float32 and got_dev.shape == (2, 3, 8000)
    np.testing.assert_allclose(got_dev.numpy(), want_dev, rtol=0,
                               atol=ATOL32)
    # windows in chunks of two starts: the fold sums meet at chunk edges
    chunked = tpn.phasenet_probas_device(model, x, batch_windows=4)
    np.testing.assert_allclose(chunked.numpy(), got_dev.numpy(), rtol=0,
                               atol=1e-6)
    want = jpn.sliding_window_probas(jmodel, variables, x)
    got = tpn.sliding_window_probas(model, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL32)
    # the picker protocol keeps (P, S) in the model's class order
    picked = tpn.make_picker(model)(x)
    assert tpn.ps_channels(model) == jpn.ps_channels(jmodel)
    np.testing.assert_array_equal(picked,
                                  got[:, list(tpn.ps_channels(model))])


def test_short_day_is_padded_to_one_window():
    jmodel, variables, model = _pair("phasenet")
    x = np.random.default_rng(8).normal(size=(1, 3, 2000)).astype(np.float32)
    want = np.asarray(jpn.phasenet_probas_device(jmodel, variables, x))
    got = tpn.phasenet_probas_device(model, x).numpy()
    assert got.shape == want.shape == (1, 3, tpn.WINDOW)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL32)


def test_checkpoint_npz_and_pt_round_trip(tmp_path):
    sd = _seisbench_state_dict(9, torch.float32)
    np.savez(tmp_path / "pn.npz", **{k: v.numpy() for k, v in sd.items()})
    torch.save({"state_dict": sd}, tmp_path / "pn.pt")
    x = torch.from_numpy(np.random.default_rng(10).normal(
        size=(1, 3, 3001)).astype(np.float32))
    with torch.no_grad():
        want = _port("seisbench", sd, torch.float32)(x)
        for name in ("pn.npz", "pn.pt"):
            model = tpn.load_seisbench_checkpoint(str(tmp_path / name),
                                                  device="cpu")
            assert not model.training
            assert torch.equal(model(x), want)
    np.testing.assert_allclose(want.sum(dim=1).numpy(), 1.0, atol=1e-5)


def test_init_phasenet_is_seeded():
    a = tpn.init_phasenet(torch.Generator().manual_seed(1), device="cpu")
    b = tpn.init_phasenet(torch.Generator().manual_seed(1), device="cpu")
    c = tpn.init_phasenet(torch.Generator().manual_seed(2), device="cpu")
    assert not a.training
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
        if k.endswith(".conv.weight"):
            assert not torch.equal(va, vc), k
            fan_in = va.shape[1] * va.shape[2]
            assert abs(float(va.std()) * fan_in**0.5 - 1.0) < 0.35
