"""The port's PhaseNet training (`models.phasenet` training pieces,
`models/training.py`, `models/checkpoint.py`) against the JAX package's,
on the CPU, at a small size (depth 3, filters_root 4, windows of 256,
batches of 8).

- `gaussian_pick_labels` bit for bit (torch's layout: the JAX labels
  transposed); `cross_entropy_loss` within 1e-12 in float64.
- One `make_train_step` step of both packages from one set of Flax
  weights carried by `from_flax_variables`, on one batch: in float64 on
  both sides (JAX under x64), the loss within 1e-12, every gradient within
  1e-12 of the largest, Adam's moments within 1e-15 (first) and 1e-18
  (second), the updated weights and the running BatchNorm statistics
  within 1e-10, for both architectures; in float32 (`PhaseNet`), the loss
  within 1e-6, gradients within 1e-4 of the largest, the weights within
  1e-6.  (SeisBench's first conv has a bias ahead of a BatchNorm, whose
  gradient is rounding noise: Adam's first step, ~lr sign(g), turns that
  noise into up to 2 lr in f32, so SeisBench is held in float64 only.)
- `train_phasenet` over 2 epochs: the JAX package's per-epoch losses
  within 1e-10 (float64, the same seed and permutations).
- `train_phasenet(mesh=)`: one `make_sharded_train_step` step on virtual
  meshes of 2 and 3 CPU devices equal to the unsharded step in float64
  (loss within 1e-12, gradients, weights and running statistics within
  1e-10), a batch of 32 on 3 devices trained as 30, and the f32 epoch
  losses on a 4-device mesh within 1e-5 of the JAX `train_phasenet` on a
  4-device mesh of conftest's virtual CPU devices.
- `windows_from_events` equal to the JAX function on a picked event
  resampled from 50 to 100 Hz.
- Checkpoints: variables and train state round trips, and a run resumed
  from a checkpoint equal to an uninterrupted one bit for bit.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from seismic_bpmf_tpu.data.events import Event as JEvent  # noqa: E402
from seismic_bpmf_tpu.data.stream import (  # noqa: E402
    Stream as JStream, Trace as JTrace,
)
from seismic_bpmf_tpu.models import phasenet as jpn  # noqa: E402
from seismic_bpmf_tpu.models import training as jtr  # noqa: E402

import seismic_bpmf_tpu_torch.data as tdata  # noqa: E402
from seismic_bpmf_tpu_torch.models import checkpoint as tck  # noqa: E402
from seismic_bpmf_tpu_torch.models import phasenet as tpn  # noqa: E402
from seismic_bpmf_tpu_torch.models import training as ttr  # noqa: E402
from seismic_bpmf_tpu_torch.ops.picks import PickTable  # noqa: E402

DEPTH, ROOT, W, B, LR = 3, 4, 256, 8, 1e-3
ARCH = {"phasenet": (jpn.PhaseNet, tpn.PhaseNet),
        "seisbench": (jpn.SeisBenchPhaseNet, tpn.SeisBenchPhaseNet)}


def _models(arch, np_dtype, seed=0):
    """(JAX model, Flax variables as numpy `np_dtype`, the port's model
    holding them)."""
    jcls, tcls = ARCH[arch]
    jm = jcls(depth=DEPTH, filters_root=ROOT)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, W, 3)),
                train=False)
    v = jax.tree.map(lambda a: np.asarray(a, np_dtype), v)
    tm = tcls(depth=DEPTH, filters_root=ROOT).to(
        torch.float64 if np_dtype == np.float64 else torch.float32)
    tm.load_state_dict(tpn.from_flax_variables(v, arch=arch))
    return jm, v, tm


def _batch(seed, n=B, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3, W)).astype(dtype)
    picks = np.stack([rng.uniform(20, 100, n), rng.uniform(120, 220, n)],
                     axis=1)
    picks[1, 1] = -1e9  # a window without its S pick
    return x, picks


def test_gaussian_pick_labels_bit_equal():
    _, picks = _batch(1)
    got = tpn.gaussian_pick_labels(picks, W, sigma=7.0)
    want = jpn.gaussian_pick_labels(picks, W, sigma=7.0)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want.transpose(0, 2, 1))


def test_cross_entropy_loss_matches_jax():
    rng = np.random.default_rng(2)
    probas = rng.dirichlet(np.ones(3), size=(B, W))       # (B, W, 3)
    probas[0, :5] = [1.0, 0.0, 0.0]                       # log(0 + eps)
    labels = jpn.gaussian_pick_labels(_batch(3)[1], W).astype(np.float64)
    with jax.enable_x64(True):
        want = float(jpn.cross_entropy_loss(probas, labels))
    got = float(tpn.cross_entropy_loss(
        torch.from_numpy(probas.transpose(0, 2, 1).copy()),
        torch.from_numpy(labels.transpose(0, 2, 1).copy())))
    assert abs(got - want) <= 1e-12


@functools.lru_cache(maxsize=None)
def _one_step(arch, np_dtype):
    """One step of both packages on one batch; returns the JAX step's
    outputs (new variables, gradients, Adam's moments, loss), them in the
    port's state-dict names, the port's model and optimizer after its
    step, and its loss.  Cached: the tests only read it."""
    jm, v, tm = _models(arch, np_dtype)
    x, picks = _batch(4, dtype=np_dtype)
    labels = tpn.gaussian_pick_labels(picks, W).astype(np_dtype)
    xj, yj = x.transpose(0, 2, 1), labels.transpose(0, 2, 1)
    opt = optax.adam(LR)
    params, stats = v["params"], v["batch_stats"]

    def loss_fn(p):
        probas, _ = jm.apply({"params": p, "batch_stats": stats}, xj,
                             train=True, mutable=["batch_stats"])
        return jpn.cross_entropy_loss(probas, yj)

    with jax.enable_x64(np_dtype == np.float64):
        (p2, s2, o2), jloss = jax.jit(jpn.make_train_step(jm, opt))(
            (params, stats, opt.init(params)), (xj, yj))
        grads = jax.jit(jax.grad(loss_fn))(params)
        jax_out = jax.tree.map(np.asarray, dict(
            new={"params": p2, "batch_stats": s2},
            grad={"params": grads, "batch_stats": stats},
            mu={"params": o2[0].mu, "batch_stats": stats},
            nu={"params": o2[0].nu, "batch_stats": stats},
            loss=jloss))
    optimizer = torch.optim.Adam(tm.parameters(), lr=LR)
    tloss = tpn.make_train_step(tm, optimizer)(
        (torch.from_numpy(x), torch.from_numpy(labels)))
    torch_of = {k: tpn.from_flax_variables(jax_out[k], arch=arch)
                for k in ("new", "grad", "mu", "nu")}
    return jax_out, torch_of, tm, optimizer, float(tloss)


def _max_err(tm, optimizer, want):
    """Largest differences: gradients (over the largest gradient), first
    and second moments, parameters, running statistics."""
    g_scale = max(float(want["grad"][n].abs().max())
                  for n, _ in tm.named_parameters())
    err = dict(grad=0.0, mu=0.0, nu=0.0, w=0.0, stats=0.0)
    for name, p in tm.named_parameters():
        st = optimizer.state[p]
        err["grad"] = max(err["grad"], float(
            (p.grad - want["grad"][name]).abs().max()) / g_scale)
        err["mu"] = max(err["mu"], float(
            (st["exp_avg"] - want["mu"][name]).abs().max()))
        err["nu"] = max(err["nu"], float(
            (st["exp_avg_sq"] - want["nu"][name]).abs().max()))
        err["w"] = max(err["w"], float(
            (p.detach() - want["new"][name]).abs().max()))
    for name, t in tm.state_dict().items():
        if "running_" in name:
            err["stats"] = max(err["stats"], float(
                (t - want["new"][name]).abs().max()))
    return err


@pytest.mark.parametrize("arch", ["phasenet", "seisbench"])
def test_train_step_matches_optax_float64(arch):
    jax_out, want, tm, optimizer, tloss = _one_step(arch, np.float64)
    assert abs(tloss - float(jax_out["loss"])) <= 1e-12
    err = _max_err(tm, optimizer, want)
    assert err["grad"] <= 1e-12, err
    assert err["mu"] <= 1e-15 and err["nu"] <= 1e-18, err
    assert err["w"] <= 1e-10, err


@pytest.mark.parametrize("arch", ["phasenet", "seisbench"])
def test_running_statistics_follow_flax(arch):
    """The BatchNorm statistics after a step equal Flax's `batch_stats`
    (the biased batch variance, momentum 0.9), not torch's default
    update, and the step moved them."""
    _, want, tm, optimizer, _ = _one_step(arch, np.float64)
    err = _max_err(tm, optimizer, want)
    assert err["stats"] <= 1e-12, err
    var = [n for n in tm.state_dict() if n.endswith("running_var")]
    assert any(float((tm.state_dict()[n] - 1.0).abs().max()) > 1e-3
               for n in var)


def test_train_step_matches_optax_float32():
    jax_out, want, tm, optimizer, tloss = _one_step("phasenet", np.float32)
    assert abs(tloss - float(jax_out["loss"])) <= 1e-6
    err = _max_err(tm, optimizer, want)
    assert err["grad"] <= 1e-4 and err["w"] <= 1e-6, err
    assert err["stats"] <= 1e-6, err


def _train_set(n=36, seed=6):
    x, picks = _batch(seed, n=n)
    return x, picks.astype(np.float32)


def test_train_phasenet_matches_jax_epoch_losses():
    jm, v, tm = _models("phasenet", np.float64, seed=1)
    x, picks = _train_set()
    with jax.enable_x64(True):
        _, jv, jlosses = jtr.train_phasenet(
            x.transpose(0, 2, 1), picks, n_epochs=2, batch_size=B,
            model=jm, variables=v, seed=3, verbose=False)
    model, sd, losses = ttr.train_phasenet(
        x, picks, n_epochs=2, batch_size=B, model=tm, variables=v,
        seed=3, verbose=False, device="cpu")
    assert len(losses) == 2 and losses[1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-10)
    want = tpn.from_flax_variables(jax.tree.map(np.asarray, jv))
    for name, t in sd.items():
        if t.is_floating_point():
            assert float((t - want[name]).abs().max()) <= 1e-9, name
    assert not model.training


def test_train_phasenet_from_a_seed_and_mesh_raises():
    """Without `variables` the weights come from a generator seeded with
    `seed`: the same seed gives the same run, weights included, and
    another seed another; `mesh=` is not ported."""
    x, picks = _train_set(n=16)

    def run(seed):
        return ttr.train_phasenet(
            x.astype(np.float32), picks, n_epochs=1, batch_size=B,
            model=tpn.PhaseNet(depth=DEPTH, filters_root=ROOT),
            verbose=False, device="cpu", seed=seed)[1:]

    (sd_a, losses_a), (sd_b, losses_b) = run(9), run(9)
    assert losses_a == losses_b and np.isfinite(losses_a).all()
    assert sd_a.keys() == sd_b.keys()
    for name in sd_a:
        assert torch.equal(sd_a[name], sd_b[name]), name
    assert run(10)[1] != losses_a
    # a mesh that is not a `parallel.Mesh` raises through mesh_device
    with pytest.raises(NotImplementedError, match="process-group mesh"):
        ttr.train_phasenet(x, picks, n_epochs=1, mesh=object(),
                           device="cpu")


def _cpu_mesh(n):
    from seismic_bpmf_tpu_torch.parallel import make_mesh

    return make_mesh({"data": n}, devices=["cpu"] * n)


@pytest.mark.parametrize("arch,n_dev", [("phasenet", 2), ("phasenet", 3),
                                        ("seisbench", 3)])
def test_sharded_step_equals_the_unsharded_step_float64(arch, n_dev):
    x, picks = _batch(8, n=12)
    labels = torch.from_numpy(tpn.gaussian_pick_labels(picks, W)).double()
    out = []
    for mesh in (None, _cpu_mesh(n_dev)):
        tm = _models(arch, np.float64)[2]
        opt = torch.optim.Adam(tm.parameters(), lr=LR)
        step = (tpn.make_train_step(tm, opt) if mesh is None
                else ttr.make_sharded_train_step(tm, opt, mesh))
        loss = float(step((torch.from_numpy(x), labels)))
        out.append((loss, {k: p.grad for k, p in tm.named_parameters()},
                    tm.state_dict()))
    (loss, grads, sd), (sloss, sgrads, ssd) = out
    assert abs(sloss - loss) <= 1e-12
    for k in grads:
        assert float((sgrads[k] - grads[k]).abs().max()) <= 1e-10, k
    for k in sd:
        assert sd[k].dtype == ssd[k].dtype, k
        assert float((ssd[k].double() - sd[k].double()).abs().max()) \
            <= 1e-10, k
    assert int(ssd[next(k for k in sd if "num_batches" in k)]) == 1


def test_sharded_steps_equal_the_unsharded_steps_float64():
    """Three steps of `make_sharded_train_step` on a 4-device CPU mesh,
    the body that a card captures in one CUDA graph and replays (its
    eager twin), against three unsharded steps in float64 on changing
    batches: each step's loss within 1e-12 and a tensor of its own (a
    replay rewrites the graph's loss), the gradients, the weights, Adam's
    moments and the running statistics within 1e-10 after every step."""
    models = [_models("phasenet", np.float64)[2] for _ in range(2)]
    opts = [torch.optim.Adam(m.parameters(), lr=LR) for m in models]
    steps = [tpn.make_train_step(models[0], opts[0]),
             ttr.make_sharded_train_step(models[1], opts[1], _cpu_mesh(4))]
    losses = [[], []]
    for seed in (11, 12, 13):
        x, picks = _batch(seed)
        batch = (torch.from_numpy(x), torch.from_numpy(
            tpn.gaussian_pick_labels(picks, W)).double())
        for k in range(2):
            losses[k].append(steps[k](batch))
        assert abs(float(losses[1][-1]) - float(losses[0][-1])) <= 1e-12
        m, sm = models
        for (k, p), sp in zip(m.named_parameters(), sm.parameters()):
            assert float((sp.grad - p.grad).abs().max()) <= 1e-10, k
            for key in ("exp_avg", "exp_avg_sq"):
                assert float((opts[1].state[sp][key]
                              - opts[0].state[p][key]).abs().max()) <= 1e-10
        sd, ssd = m.state_dict(), sm.state_dict()
        for k in sd:
            assert float((ssd[k].double() - sd[k].double()).abs().max()) \
                <= 1e-10, k
    assert len({id(v) for v in losses[1]}) == 3
    assert [float(v) for v in losses[1]] != [float(losses[1][0])] * 3


# aten operations one sharded step dispatches on the CPU (depth 3, filters
# 4, 8 windows of 256 over 4 devices, float64): the shards' forward and
# backward with the BatchNorm exchange, which the card replays as one
# CUDA graph, and Adam's per-parameter ops
SHARDED_STEP_OPS = 1328


def test_sharded_step_dispatches_a_pinned_number_of_ops():
    """A warm `make_sharded_train_step` step on a 4-device CPU mesh
    dispatches at most `SHARDED_STEP_OPS` aten operations (counted by a
    `TorchDispatchMode`), so that no change brings the eager step's
    launches back into the graph unnoticed."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    tm = _models("phasenet", np.float64)[2]
    step = ttr.make_sharded_train_step(
        tm, torch.optim.Adam(tm.parameters(), lr=LR), _cpu_mesh(4))
    x, picks = _batch(8)
    batch = (torch.from_numpy(x),
             torch.from_numpy(tpn.gaussian_pick_labels(picks, W)).double())
    step(batch)
    with Count():
        step(batch)
    assert 0 < Count.n <= SHARDED_STEP_OPS, Count.n


def test_a_cuda_mesh_captures_the_step_whatever_the_batch_device(
        monkeypatch):
    """On a mesh of CUDA devices the sharded step always goes through
    `_CapturedStep` (one graph a batch shape), a batch in host memory
    too: it never runs the eager step on the cards.  The capture is
    replaced by a recorder, so this runs without a card."""
    import types

    made = []

    class Recorder:
        def __init__(self, body, model, devices, x, labels):
            made.append((x.device, labels.device, x.shape))

        def __call__(self, x, labels):
            return torch.zeros((), dtype=x.dtype)

    monkeypatch.setattr(ttr, "_CapturedStep", Recorder)
    tm = _models("phasenet", np.float32)[2]
    mesh = types.SimpleNamespace(devices=np.array(
        [torch.device("cuda", 0)] * 2, dtype=object))
    step = ttr.make_sharded_train_step(
        tm, torch.optim.Adam(tm.parameters(), lr=LR), mesh)
    x, picks = _batch(8, dtype=np.float32)
    batch = (torch.from_numpy(x),
             torch.from_numpy(tpn.gaussian_pick_labels(picks, W)))
    for _ in range(2):
        assert float(step(batch)) == 0.0
    assert made == [(torch.device("cpu"), torch.device("cpu"),
                     batch[0].shape)]


def test_train_phasenet_on_a_mesh_rounds_the_batch_to_the_mesh():
    x, picks = _train_set(n=64)

    def run(batch_size, mesh=None):
        return ttr.train_phasenet(
            x, picks, n_epochs=2, batch_size=batch_size,
            model=tpn.PhaseNet(depth=DEPTH, filters_root=ROOT).double(),
            mesh=mesh, verbose=False, device="cpu", seed=4)

    model, sd, losses = run(32, _cpu_mesh(3))
    _, sd30, losses30 = run(30)
    np.testing.assert_allclose(losses, losses30, rtol=0, atol=1e-10)
    for k in sd30:
        assert float((sd[k].double() - sd30[k].double()).abs().max()) \
            <= 1e-9, k
    assert abs(losses[0] - run(32)[2][0]) > 1e-6
    assert not model.training
    with pytest.raises(ValueError, match="mesh's first device"):
        ttr.train_phasenet(x, picks, mesh=_cpu_mesh(2), device="meta")


def test_train_phasenet_mesh_matches_jax_epoch_losses():
    from seismic_bpmf_tpu.parallel.mesh import make_mesh as jmake_mesh

    jm, v, tm = _models("phasenet", np.float32, seed=2)
    x, picks = _train_set(n=48, seed=7)
    x = x.astype(np.float32)
    _, _, jlosses = jtr.train_phasenet(
        x.transpose(0, 2, 1), picks, n_epochs=2, batch_size=B, model=jm,
        variables=v, seed=5, verbose=False,
        mesh=jmake_mesh({"data": 4}, devices=jax.devices()[:4]))
    _, _, losses = ttr.train_phasenet(
        x, picks, n_epochs=2, batch_size=B, model=tm, variables=v, seed=5,
        verbose=False, device="cpu", mesh=_cpu_mesh(4))
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-5)


def _picked_events(rng, sr=50.0, n=3000):
    """One event at `sr` on three stations (the second unpicked, the third
    with a P pick only) in both packages, the same traces and picks."""
    stations = ["ST1", "ST2", "ST3"]
    mv = np.zeros((3, 2), np.float32)
    jev = JEvent("2012-07-26T01:00:00", mv, stations, ["P", "S"],
                 sampling_rate=sr)
    tev = tdata.Event("2012-07-26T01:00:00", mv, stations, ["P", "S"],
                      sampling_rate=sr)
    jev.traces, tev.traces = JStream(), tdata.Stream()
    for sta in stations:
        for cp in "NEZ":
            x = rng.normal(size=n).astype(np.float32)
            jev.traces += JTrace(x, station=sta, channel=f"HH{cp}",
                                 sampling_rate=sr)
            tev.traces += tdata.Trace(x.copy(), station=sta,
                                      channel=f"HH{cp}", sampling_rate=sr)
    jev.duration = tev.duration = n / sr
    table = PickTable(["ST1", "ST3"], {
        "P_picks": np.array([750.0, 900.0], np.float32),
        "S_picks": np.array([1250.0, np.nan], np.float32)})
    tev.picks_table = table
    jev.picks = table.to_frame()
    return jev, tev


def test_windows_from_events_matches_jax():
    jev, tev = _picked_events(np.random.default_rng(7))
    jx, jp = jtr.windows_from_events([jev], window=3001,
                                     rng=np.random.default_rng(8))
    tx, tp = ttr.windows_from_events([tev, tdata.Event(
        "2012-07-26", np.zeros((1, 2)), ["ST1"], ["P", "S"])],
        window=3001, rng=np.random.default_rng(8))
    assert tx.shape == (2, 3, 3001) and tp.shape == (2, 2)
    assert np.array_equal(tx, jx.transpose(0, 2, 1))
    assert np.array_equal(tp, jp)
    assert tp[1, 1] == np.float32(-1e9)


def test_variables_round_trip(tmp_path):
    model = tpn.init_weights(tpn.PhaseNet(depth=DEPTH, filters_root=ROOT),
                             torch.Generator().manual_seed(3))
    x = torch.from_numpy(_batch(5, dtype=np.float32)[0])
    path = tck.save_variables(str(tmp_path / "ckpt"), model)
    other = tpn.PhaseNet(depth=DEPTH, filters_root=ROOT)
    sd = tck.load_variables(path, target=other)
    assert set(sd) == set(model.state_dict())
    with torch.no_grad():
        assert torch.equal(model.eval()(x), other.eval()(x))


def _steps(model, optimizer, x, labels, idx):
    step = tpn.make_train_step(model, optimizer)
    return [float(step((x[i], labels[i]))) for i in idx]


def test_resumed_run_equals_an_uninterrupted_one(tmp_path):
    x, picks = _train_set(n=32)
    x = torch.from_numpy(x.astype(np.float32))
    labels = torch.from_numpy(tpn.gaussian_pick_labels(picks, W))
    idx = [slice(i * B, (i + 1) * B) for i in range(4)]

    def fresh():
        m = tpn.init_weights(tpn.PhaseNet(depth=DEPTH, filters_root=ROOT),
                             torch.Generator().manual_seed(4))
        return m, torch.optim.Adam(m.parameters(), lr=LR)

    m1, o1 = fresh()
    whole = _steps(m1, o1, x, labels, idx)
    m2, o2 = fresh()
    first = _steps(m2, o2, x, labels, idx[:2])
    path = tck.save_train_state(str(tmp_path / "state"), m2, o2, step=2)
    m3, o3 = fresh()
    _, _, step = tck.load_train_state(path, target=(m3, o3))
    assert step == 2
    rest = _steps(m3, o3, x, labels, idx[2:])
    assert first + rest == whole
    for (n, a), b in zip(m1.state_dict().items(), m3.state_dict().values()):
        assert torch.equal(a, b), n
    assert o3.state_dict()["state"][0]["step"] == 4
