"""PhaseNet training, on the card.

Counterpart of `seismic_bpmf_tpu.models.training`: the picker (re)trained
on the user's own region, with Gaussian-blurred pick labels plus a noise
class (the PhaseNet convention) and a cross-entropy loss:

  windows_from_events     : picked Events -> (windows, pick labels)
  make_sharded_train_step : one step of a batch split over a mesh (on
                            CUDA, one graph replayed across the cards)
  train_phasenet          : the epoch loop over `make_train_step` (Adam),
                            or over `make_sharded_train_step` with `mesh=`

Windows are in torch's layout, (n, 3, window).
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..parallel.mesh import mesh_device
from .phasenet import (
    WINDOW, PhaseNet, SeisBenchPhaseNet, Shards, _ieee_convolutions,
    _to_device, from_flax_variables, gaussian_pick_labels, init_weights,
    make_train_step, on_streams, replicate,
)


def windows_from_events(
    events,
    window: int = WINDOW,
    target_sr: float = 100.0,
    component_order: str = "ZNE",
    jitter_sec: float = 5.0,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(x (n, 3, window), picks (n, 2)) float32 training pairs from picked
    events: one randomly jittered window a picked station, resampled to
    `target_sr` (scipy's `resample_poly`), normalized per channel; picks
    in window samples (-1e9 where a phase has none).

    Events need `picks_table` (P_picks/S_picks in native samples) and
    waveforms read with time_shifted=False; the others are skipped.  The
    jitter is drawn from `rng` (default_rng(0) when None), station by
    station, as the JAX function draws it."""
    from scipy.signal import resample_poly

    rng = rng or np.random.default_rng(0)
    xs, ps = [], []
    for ev in events:
        picks = getattr(ev, "picks_table", None)
        if picks is None or not hasattr(ev, "traces"):
            continue
        arr = ev.waveforms_arr  # (n_sta, n_comp, n)
        comp_idx = {c: i for i, c in enumerate(ev.components)}
        order = [comp_idx[c] for c in component_order if c in comp_idx]
        arr = arr[:, order, :]
        sr = ev.sr
        if sr != target_sr:
            up, down = int(round(target_sr)), int(round(sr))
            arr = resample_poly(arr, up, down, axis=-1)
        scale = target_sr / sr
        row = {s: i for i, s in enumerate(picks.stations)}
        cols = picks.columns
        for s, sta in enumerate(ev.stations):
            if sta not in row:
                continue
            p_pick = cols["P_picks"][row[sta]] if "P_picks" in cols else np.nan
            s_pick = cols["S_picks"][row[sta]] if "S_picks" in cols else np.nan
            if np.isnan(p_pick) and np.isnan(s_pick):
                continue
            anchor = np.nanmin([p_pick, s_pick]) * scale
            jitter = rng.uniform(-jitter_sec, jitter_sec) * target_sr
            start = int(np.clip(anchor - window // 3 + jitter, 0,
                                max(0, arr.shape[-1] - window)))
            win = arr[s, :, start: start + window]
            if win.shape[-1] < window:
                win = np.pad(win, ((0, 0), (0, window - win.shape[-1])))
            std = win.std(axis=-1, keepdims=True)
            std[std == 0] = 1.0
            win = (win - win.mean(axis=-1, keepdims=True)) / std
            xs.append(win)
            ps.append(np.array([
                p_pick * scale - start if not np.isnan(p_pick) else -1e9,
                s_pick * scale - start if not np.isnan(s_pick) else -1e9,
            ]))
    if not xs:
        return (np.zeros((0, 3, window), np.float32),
                np.zeros((0, 2), np.float32))
    return (np.stack(xs).astype(np.float32),
            np.stack(ps).astype(np.float32))


def _state_dict(model: nn.Module,
                variables: Mapping[str, Any]) -> Mapping[str, Any]:
    """A torch state dict as it is; the JAX package's Flax variables
    ({'params', 'batch_stats'}) through `from_flax_variables`."""
    if "params" in variables:
        arch = "seisbench" if isinstance(model, SeisBenchPhaseNet) \
            else "phasenet"
        return from_flax_variables(variables, arch=arch)
    return variables


# the private allocator calls by which `_CapturedStep` routes the other
# cards' allocations during a capture to the graph's pool; a CUDA build
# of torch without them cannot capture a step across cards
_POOL_CALLS = ("_cuda_beginAllocateCurrentStreamToPool",
               "_cuda_endAllocateToPool", "_cuda_releasePool")
if torch.version.cuda is not None and not all(
        hasattr(torch._C, name) for name in _POOL_CALLS):
    raise ImportError(
        f"torch {torch.__version__} lacks "
        f"{[n for n in _POOL_CALLS if not hasattr(torch._C, n)]}, which the "
        f"sharded training step's capture across cards needs")


class _CapturedStep:
    """A sharded step's forward and backward (`body(x, labels) -> loss`,
    the gradients left in the parameters' `.grad`), captured once in one
    CUDA graph across the mesh's cards and replayed each step: the host
    issues one graph launch where the eager step issues every shard's
    kernels, copies and cross-card waits from one thread, the JAX
    package's one compiled program over the mesh.

    The graph reads `x` and `labels`, static copies on the first card
    into which each call copies its batch (from the host too), and
    rewrites the loss and the gradients in place each replay; Adam
    steps outside it, eagerly on the first card.  Each card's work runs on
    a stream of its own, forked from the first card's capture stream and
    joined back into it, so that the cards run their shards together and
    the BatchNorm exchange becomes copy and wait nodes between them; a
    card's allocations during the capture go to the graph's private pool
    on that card.  A warm-up run on those streams before the capture
    (cuDNN's handles and plans, the autograd engine's device threads)
    leaves the BatchNorm buffers as it found them.  A failed capture or
    replay raises."""

    def __init__(self, body, model: nn.Module, devices, x, labels):
        self.devices = list(dict.fromkeys(devices))
        self.params = list(model.parameters())
        self.x = x.to(self.devices[0], copy=True)
        self.labels = labels.to(self.devices[0], copy=True)
        self.streams = [torch.cuda.Stream(d) for d in self.devices]
        buffers = list(model.buffers())
        saved = [b.clone() for b in buffers]
        for s, d in zip(self.streams, self.devices):
            s.wait_stream(torch.cuda.current_stream(d))
        with self._on_streams():
            body(self.x, self.labels)
        for s, d in zip(self.streams, self.devices):
            torch.cuda.current_stream(d).wait_stream(s)
        with torch.no_grad():
            for b, v in zip(buffers, saved):
                b.copy_(v)
        for p in self.params:
            p.grad = None
        for d in self.devices:
            torch.cuda.synchronize(d)
        pool = torch.cuda.graph_pool_handle()
        self.graph = torch.cuda.CUDAGraph()
        first = self.streams[0]
        with torch.cuda.device(first.device), torch.cuda.stream(first):
            self.graph.capture_begin(pool=pool)
            try:
                for s in self.streams[1:]:
                    s.wait_stream(first)
                with self._on_streams(pool):
                    self.loss = body(self.x, self.labels)
                for s in self.streams[1:]:
                    first.wait_stream(s)
            finally:
                self.graph.capture_end()
        self.grads = [p.grad for p in self.params]
        weakref.finalize(self, _release_pools,
                         [d.index for d in self.devices[1:]], pool)

    @contextlib.contextmanager
    def _on_streams(self, pool=None):
        """Each card's stream current on it; with `pool`, each card's
        allocations but the first's (`CUDAGraph` routes those) go to it."""
        with contextlib.ExitStack() as stack:
            stack.enter_context(on_streams(self.streams))
            if pool is not None:
                for s in self.streams[1:]:
                    torch._C._cuda_beginAllocateCurrentStreamToPool(
                        s.device.index, pool)
                    stack.callback(torch._C._cuda_endAllocateToPool,
                                   s.device.index, pool)
            yield

    def __call__(self, x, labels) -> torch.Tensor:
        with torch.cuda.device(self.devices[0]):
            self.x.copy_(x)
            self.labels.copy_(labels)
            self.graph.replay()
        for p, g in zip(self.params, self.grads):
            p.grad = g
        return self.loss.clone()


def _release_pools(devices, pool) -> None:
    for d in devices:
        torch._C._cuda_releasePool(d, pool)


def make_sharded_train_step(model: nn.Module,
                            optimizer: torch.optim.Optimizer, mesh):
    """`step((x, labels)) -> loss`: `make_train_step`'s step with the
    batch split over the devices of `mesh` (a `parallel.Mesh`, every axis;
    its devices in row-major order), the JAX package's `jit` over a batch
    sharded on all the mesh's axes.  `model` and `optimizer` live on the
    mesh's first device, the batch (divisible by the mesh's size) too.

    One autograd graph: the model's forward runs over the shards in
    lockstep (`phasenet.Shards`: each layer once a shard, on the shard's
    device, the weights copied to each device once a step by
    `phasenet.replicate`); each BatchNorm normalizes with the whole
    batch's statistics, gathered to the first device, and the loss is the
    whole batch's mean, so the gradients are the global batch's.  The
    running statistics move once a step; Adam steps on the first
    device.  On a mesh of CUDA devices the forward and backward run as
    one CUDA graph over the cards (`_CapturedStep`), whatever device the
    batch is on, captured at the first step of each batch shape and
    replayed after; each shape's graph and its memory pools on every card
    are held until the step function is dropped (`train_phasenet` keeps
    one shape).  On a CPU mesh they run eagerly."""
    devices = list(mesh.devices.flat)
    n = len(devices)
    graphs = {}

    def forward_backward(x, labels):
        b = x.shape[0] // n
        with replicate(model.parameters(), devices):
            probas = model(Shards(x[k * b: (k + 1) * b].to(devices[k])
                                  for k in range(n)))
            total = None
            for k, p in enumerate(probas.parts):
                part = _to_device(torch.sum(
                    labels[k * b: (k + 1) * b].to(p.device)
                    * torch.log(p + 1e-7)), devices[0])
                total = part if total is None else total + part
            loss = -total / (x.shape[0] * x.shape[2])
            loss.backward()
        return loss.detach()

    def step(batch):
        x, labels = batch
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} does not split over "
                             f"{n} devices")
        model.train()
        with _ieee_convolutions():
            if devices[0].type == "cuda":
                key = (x.shape, x.dtype, labels.shape, labels.dtype)
                if key not in graphs:
                    graphs[key] = _CapturedStep(forward_backward, model,
                                                devices, x, labels)
                loss = graphs[key](x, labels)
            else:
                optimizer.zero_grad(set_to_none=True)
                loss = forward_backward(x, labels)
        optimizer.step()
        return loss

    return step


def train_phasenet(
    x: np.ndarray,
    picks: np.ndarray,
    n_epochs: int = 10,
    batch_size: int = 32,
    learning_rate: float = 1e-3,
    sigma: float = 10.0,
    model: Optional[nn.Module] = None,
    variables: Optional[Mapping[str, Any]] = None,
    mesh=None,
    seed: int = 0,
    verbose: bool = True,
    device=None,
):
    """Supervised PhaseNet training on `device` (CUDA unless 'cpu' is
    asked for): x (n, 3, window) windows, picks (n, 2) P/S samples.

    `model` defaults to `PhaseNet()`, trained in its own dtype.  Its
    starting weights: `variables` (a torch state dict, or the JAX
    package's Flax variables, carried by `from_flax_variables`), else
    `init_weights` drawn from a CPU `torch.Generator` seeded with `seed`.
    The batching is the JAX package's:
    each epoch `np.random.default_rng(seed)` draws a permutation, batches
    of `batch_size` run in its order and the remainder is dropped; Adam
    at `learning_rate`.

    With `mesh` (a `parallel.Mesh`) each batch is split over the mesh's
    devices (`make_sharded_train_step`: the whole batch's BatchNorm
    statistics, loss and gradients) and the model lives on its first
    device; as in the JAX package the batch size is rounded to
    ``max(batch_size // n_dev * n_dev, n_dev)``.

    Returns (model, its state dict, per-epoch mean losses); the model is
    left on `device` (the mesh's first) in eval mode."""
    dev = mesh_device(mesh, device)
    if model is None:
        model = PhaseNet()
    if variables is not None:
        model.load_state_dict(_state_dict(model, variables))
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
    model.to(dev)
    dtype = next(model.parameters()).dtype
    window = x.shape[-1]
    xt = torch.as_tensor(np.asarray(x)).to(device=dev, dtype=dtype)
    yt = torch.from_numpy(gaussian_pick_labels(
        np.asarray(picks), window, sigma=sigma)).to(device=dev, dtype=dtype)
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate)
    if mesh is None:
        step = make_train_step(model, optimizer)
    else:
        n_dev = mesh.devices.size
        batch_size = max(batch_size // n_dev * n_dev, n_dev)
        step = make_sharded_train_step(model, optimizer, mesh)

    rng = np.random.default_rng(seed)
    n = len(x)
    losses = []
    for epoch in range(n_epochs):
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        epoch_loss = [step((xt[idx], yt[idx]))
                      for idx in (order[lo: lo + batch_size]
                                  for lo in range(0, n - batch_size + 1,
                                                  batch_size))]
        losses.append(float(np.mean([float(v) for v in epoch_loss]))
                      if epoch_loss else np.nan)
        if verbose:
            print(f"epoch {epoch}: loss {losses[-1]:.4f}")
    model.eval()
    return model, model.state_dict(), losses
