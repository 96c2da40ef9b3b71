"""PhaseNet (Zhu & Beroza 2019) in PyTorch: the deep-learning phase picker,
for serving and training.

Counterpart of `seismic_bpmf_tpu.models.phasenet` (the picker-callable
protocol of the reference, BPMF/dataset.py:1729-1736:
``probas (n_sta, 2, n_t) = picker(x (n_sta, 3, n_t))``):

  - `PhaseNet`: the package's own 1-D U-Net (depth 5, kernel 7, stride 4,
    filters 8..128, classes "PSN"), the JAX package's training
    architecture;
  - `SeisBenchPhaseNet`: SeisBench's torch PhaseNet in its own layout and
    parameter names, so a published state dict loads as it is (classes
    "NPS");
  - `from_flax_variables`: the JAX package's Flax variables -> either
    model's `state_dict` (for `SeisBenchPhaseNet` the inverse of the JAX
    `convert_seisbench_weights`);
  - `phasenet_probas_device`: a day of probabilities on the card
    (normalization, the windows, the overlap average);
    `sliding_window_probas`: the same with the normalization on the host;
    `make_picker`: the protocol callable;
  - `gaussian_pick_labels`, `cross_entropy_loss`, `make_train_step`:
    supervised training with `torch.optim.Adam` (optax's `adam` update);
    `models.training.train_phasenet` drives it.

Layouts are torch's, (batch, channels, time).  The convolutions are
cuDNN's; on the card they run in float32 with TF32 off and deterministic
algorithms, set around each forward and training step
(`_ieee_convolutions`).  BatchNorm keeps Flax's running statistics in
training (`_BatchNorm`), also over a batch split across the devices of
a mesh (`Shards`, `models.training.make_sharded_train_step`).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..ops.picks import normalize_batch, normalize_batch_np
from ..utils.observe import GLOBAL_TIMER

WINDOW = 3001  # samples @ 100 Hz, SeisBench 'original' convention
# windows a forward takes on the card (~0.6 MB of activations each)
DEVICE_BATCH_WINDOWS = 8192


def _same_pad(n: int, k: int, s: int) -> tuple:
    """Flax/TF 'SAME' padding (lo, hi) of a length-n axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Shards:
    """A batch split over devices, run through a model in lockstep.

    `parts` are the shards, each on its device, equal in shape.  Every
    torch function applied to `Shards` runs once a shard, on the shard's
    device, and returns `Shards`; so a model's own forward runs the whole
    split batch, layer by layer, in one autograd graph.  A tensor
    argument (a weight) is taken from `replicas` where it is there (one
    copy a device for the whole forward, `replicate`), else copied to the
    shard's device by `_to_device`.  `_BatchNorm` normalizes
    with the whole batch's statistics (`_ShardsBatchNorm`).  `shape` is
    the first shard's."""

    replicas: Dict[int, list] = {}

    def __init__(self, parts):
        self.parts = list(parts)

    @property
    def shape(self) -> torch.Size:
        return self.parts[0].shape

    def __getitem__(self, index) -> "Shards":
        return Shards(p[index] for p in self.parts)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = [*args, *kwargs.values()]
        flat += [v for a in flat if isinstance(a, (list, tuple)) for v in a]
        shards = next(a for a in flat if isinstance(a, Shards))

        def pick(a, k, dev):
            if isinstance(a, Shards):
                return a.parts[k]
            if isinstance(a, torch.Tensor):
                rep = cls.replicas.get(id(a))
                return _to_device(a, dev) if rep is None else rep[k]
            if isinstance(a, (list, tuple)):
                return type(a)(pick(v, k, dev) for v in a)
            return a

        out = []
        for k, part in enumerate(shards.parts):
            dev = part.device
            out.append(func(*(pick(a, k, dev) for a in args),
                            **{key: pick(v, k, dev)
                               for key, v in kwargs.items()}))
        return Shards(out)


def current_streams(devices) -> list:
    """The current stream of each CUDA device of `devices`, once each."""
    return [torch.cuda.current_stream(d) for d in dict.fromkeys(devices)
            if d.type == "cuda"]


@contextlib.contextmanager
def on_streams(streams):
    """Each of `streams` current on its device within the block, in this
    thread (its device too; both put back after)."""
    with contextlib.ExitStack() as stack:
        for s in streams:
            stack.enter_context(torch.cuda.stream(s))
        yield


class _ToDevice(torch.autograd.Function):
    """`x.to(device)` whose gradient goes back on the streams that were
    current on the two devices in the forward.  The autograd engine runs
    a backward on a thread of the device it starts on, whose current
    stream on any other device is that device's default stream, on which
    a CUDA graph's capture may not wait."""

    @staticmethod
    def forward(ctx, x, device):
        ctx.device = x.device
        ctx.streams = current_streams([x.device, device])
        return x.to(device)

    @staticmethod
    def backward(ctx, grad):
        with on_streams(ctx.streams):
            return grad.to(ctx.device), None


def _to_device(t: torch.Tensor, device) -> torch.Tensor:
    """`t` on `device`; a copy that `_ToDevice` differentiates."""
    return t if t.device == device else _ToDevice.apply(t, device)


@contextlib.contextmanager
def replicate(params, devices):
    """Within the block, `Shards` takes each of `params` (on
    `devices[0]`, of one dtype) from one copy a device: the parameters
    flattened into one tensor, copied once to each other device and split
    there into views (a differentiable copy: the gradients come back the
    same way, one copy a device); on the first device the parameters
    themselves."""
    params = list(params)
    flat = torch.cat([p.reshape(-1) for p in params])
    sizes = [p.numel() for p in params]
    on = {devices[0]: params}
    for dev in devices:
        if dev not in on:
            on[dev] = [v.view_as(p) for v, p in zip(
                _to_device(flat, dev).split(sizes), params)]
    Shards.replicas = {id(p): [on[dev][i] for dev in devices]
                       for i, p in enumerate(params)}
    try:
        yield
    finally:
        Shards.replicas = {}


def _to_each(t: torch.Tensor, parts) -> list:
    """`t` on each part's device, one copy a device."""
    on = {t.device: t}
    for p in parts:
        if p.device not in on:
            on[p.device] = t.to(p.device)
    return [on[p.device] for p in parts]


class _ShardsBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of a batch split over devices in equal
    shards, with its gradient written out, so that a layer crosses
    devices twice each way.  Forward: each shard's mean and biased
    variance, gathered once to the first shard's device, give the whole
    batch's (the shards' variances and the spread of their means); the
    mean and scale (invstd * weight) and the bias go back once to each
    device, where each shard is normalized as `F.batch_norm` does, (x -
    mean) * scale + bias; the running statistics move once, as
    `_BatchNorm` moves them.  Backward: each shard's sums of dy and of dy
    * (x - mean), gathered once and totalled on the first device, give
    the weight's and the bias's gradients and, sent back once, each
    shard's dx = (dy - sum dy / N - (x - mean) invstd^2 sum dy (x - mean)
    / N) * scale.  The backward runs on the streams that were current
    on the shards' devices in the forward (see `_ToDevice`)."""

    @staticmethod
    def forward(ctx, bn, weight, bias, *parts):
        first = parts[0].device
        ctx.streams = current_streams([p.device for p in parts])
        if len({p.shape for p in parts}) > 1:
            raise ValueError(f"shards of unequal shapes "
                             f"{[tuple(p.shape) for p in parts]}")
        stats = torch.stack([
            torch.stack(torch.var_mean(p, dim=(0, 2), correction=0))
            .to(first) for p in parts])               # (shard, var|mean, C)
        mean = stats[:, 1].mean(dim=0)
        var = (stats[:, 0] + (stats[:, 1] - mean).square()).mean(dim=0)
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean.to(bn.running_mean.device),
                                           alpha=m)
        bn.running_var.mul_(1.0 - m).add_(var.to(bn.running_var.device),
                                          alpha=m)
        bn.num_batches_tracked.add_(1)
        invstd = torch.rsqrt(var + bn.eps)
        scale = invstd * weight
        msb = _to_each(torch.stack([mean, scale, bias])[:, None, :, None],
                       parts)
        xmu = [p - c[0] for p, c in zip(parts, msb)]
        ctx.save_for_backward(invstd, scale, *xmu)
        ctx.n = len(parts) * parts[0].shape[0] * parts[0].shape[2]
        return tuple(torch.addcmul(c[2], d, c[1]) for d, c in zip(xmu, msb))

    @staticmethod
    def backward(ctx, *grads):
        invstd, scale, *xmu = ctx.saved_tensors
        first = invstd.device
        with on_streams(ctx.streams):
            sums = torch.stack([
                torch.stack([g.sum(dim=(0, 2)), (g * d).sum(dim=(0, 2))])
                .to(first) for g, d in zip(grads, xmu)]).sum(dim=0)
            grad_bias, grad_weight = sums[0], sums[1] * invstd
            coef = _to_each(torch.stack([
                sums[0] / ctx.n, sums[1] * invstd.square() / ctx.n,
                scale])[:, None, :, None], grads)
            dx = [torch.addcmul(g - c[0], d, c[1], value=-1.0) * c[2]
                  for g, d, c in zip(grads, xmu, coef)]
        return (None, grad_weight, grad_bias, *dx)


class _BatchNorm(nn.BatchNorm1d):
    """`nn.BatchNorm1d` whose running statistics follow Flax's BatchNorm in
    training: Flax (momentum 0.9, torch's 0.1) folds in the biased batch
    variance, torch the unbiased one.  The batch is normalized as torch
    does it (biased variance); in eval mode this is `nn.BatchNorm1d`.  The
    state-dict keys are unchanged.  On `Shards` in training the
    statistics are the whole split batch's (`_ShardsBatchNorm`)."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if isinstance(x, Shards):
            return Shards(_ShardsBatchNorm.apply(self, self.weight,
                                                 self.bias, *x.parts))
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2), correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class _ConvBN(nn.Module):
    """Conv (no bias, 'SAME') -> BatchNorm -> ReLU, the JAX `ConvBlock`."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv1d(c_in, c_out, kernel, stride, bias=False)
        self.bn = _BatchNorm(c_out, eps=1e-5)

    def forward(self, x):
        x = F.pad(x, _same_pad(x.shape[-1], self.conv.kernel_size[0],
                               self.stride))
        return torch.relu(self.bn(self.conv(x)))


class _Up(nn.Module):
    """The JAX `UpBlock`: Flax `ConvTranspose(SAME)` -> BatchNorm -> ReLU,
    concat [skip, x], `_ConvBN`.

    Flax's transposed conv (`transpose_kernel=False`) is a convolution of
    the zero-stuffed input, padded (5, 4) for kernel 7 and stride 4, with
    the kernel as stored; torch's is the gradient of a convolution, with
    the kernel flipped.  With the flipped kernel (`from_flax_variables`),
    output sample t of both is sum_j x[m] K[j] at t = 4 m + 5 - j, which
    is torch's padding k - 1 - 5 = 1; torch then gives one sample more
    (4 m + 1), the last, which is dropped."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int):
        super().__init__()
        pad_len = kernel + stride - 2
        pad_a = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
        self.stride = stride
        self.tconv = nn.ConvTranspose1d(c_in, c_out, kernel, stride,
                                        padding=kernel - 1 - pad_a,
                                        bias=False)
        self.bn = _BatchNorm(c_out, eps=1e-5)
        self.block = _ConvBN(2 * c_out, c_out, kernel)

    def forward(self, x, skip):
        n_out = x.shape[-1] * self.stride
        x = torch.relu(self.bn(self.tconv(x)[..., :n_out]))
        return self.block(torch.cat([skip, x], dim=1))


class PhaseNet(nn.Module):
    """1-D U-Net phase picker, the JAX package's `PhaseNet`.

    (batch, 3, n) -> (batch, 3, n) softmax probabilities ordered (P, S,
    noise).  The input is zero-padded to a multiple of stride**(depth-1)
    so every stage divides exactly, and the output is cropped back.
    BatchNorm eps is Flax's 1e-5; only the last 1x1 conv has a bias."""

    phases = "PSN"

    def __init__(self, depth: int = 5, filters_root: int = 8,
                 kernel: int = 7, stride: int = 4, n_classes: int = 3,
                 in_channels: int = 3):
        super().__init__()
        self.depth, self.stride = depth, stride
        f = [filters_root * 2**i for i in range(depth)]
        self.inc = _ConvBN(in_channels, f[0], kernel)
        self.down = nn.ModuleList(
            _ConvBN(f[i - 1], f[i], kernel, stride) for i in range(1, depth))
        self.up = nn.ModuleList(
            _Up(f[i + 1], f[i], kernel, stride)
            for i in range(depth - 2, -1, -1))
        self.out = nn.Conv1d(f[0], n_classes, 1)

    def forward(self, x):
        n_in = x.shape[-1]
        n_pad = (-n_in) % self.stride ** (self.depth - 1)
        x = self.inc(F.pad(x, (0, n_pad)))
        skips = []
        for down in self.down:
            skips.append(x)
            x = down(x)
        for up, skip in zip(self.up, skips[::-1]):
            x = up(x, skip)
        return torch.softmax(self.out(x)[..., :n_in], dim=1)


class SeisBenchPhaseNet(nn.Module):
    """SeisBench's PhaseNet ("original" weights layout), module for module:
    ``inc``/``in_bn``, ``down_branch.{i}`` = (conv_same, bn1, conv_down,
    bn2) with the last stage holding only (conv_same, bn1),
    ``up_branch.{j}`` = (conv_up, bn1, conv_same, bn2), ``out``;
    BatchNorm eps 1e-3; down pads (3,3)/(2,3)/(1,3)/(2,3) (the TF 'SAME'
    pyramid 3001-751-188-47-12), VALID transposed convs and centre crops.
    A SeisBench state dict loads with `load_state_dict` as it is.

    (batch, 3, n) -> (batch, 3, n) softmax probabilities ordered (noise,
    P, S)."""

    phases = "NPS"
    DOWN_PADS = ((3, 3), (2, 3), (1, 3), (2, 3))

    def __init__(self, in_channels: int = 3, classes: int = 3,
                 depth: int = 5, kernel_size: int = 7, stride: int = 4,
                 filters_root: int = 8):
        super().__init__()
        k = kernel_size
        self.inc = nn.Conv1d(in_channels, filters_root, k, padding=k // 2)
        self.in_bn = _BatchNorm(filters_root, eps=1e-3)
        self.down_branch = nn.ModuleList()
        self.up_branch = nn.ModuleList()
        last = filters_root
        for i in range(depth):
            f = filters_root * 2**i
            stage = [nn.Conv1d(last, f, k, padding=k // 2, bias=False),
                     _BatchNorm(f, eps=1e-3), None, None]
            if i < depth - 1:
                stage[2:] = [nn.Conv1d(f, f, k, stride, bias=False),
                             _BatchNorm(f, eps=1e-3)]
            self.down_branch.append(nn.ModuleList(stage))
            last = f
        for i in range(depth - 1):
            f = filters_root * 2 ** (depth - 2 - i)
            self.up_branch.append(nn.ModuleList([
                nn.ConvTranspose1d(last, f, k, stride, bias=False),
                _BatchNorm(f, eps=1e-3),
                nn.Conv1d(2 * f, f, k, padding=k // 2, bias=False),
                _BatchNorm(f, eps=1e-3)]))
            last = f
        self.out = nn.Conv1d(last, classes, 1)

    def forward(self, x):
        x = torch.relu(self.in_bn(self.inc(x)))
        skips = []
        for i, (conv_same, bn1, conv_down, bn2) in enumerate(
                self.down_branch):
            x = torch.relu(bn1(conv_same(x)))
            if conv_down is not None:
                skips.append(x)
                x = torch.relu(bn2(conv_down(F.pad(x, self.DOWN_PADS[i]))))
        for (conv_up, bn1, conv_same, bn2), skip in zip(self.up_branch,
                                                         skips[::-1]):
            x = torch.relu(bn1(conv_up(x)))
            off = (x.shape[-1] - skip.shape[-1]) // 2
            x = torch.cat([skip, x[..., off: off + skip.shape[-1]]], dim=1)
            x = torch.relu(bn2(conv_same(x)))
        return torch.softmax(self.out(x), dim=1)


def ps_channels(model) -> tuple:
    """(P, S) class indices for a picker model's output ordering."""
    phases = getattr(model, "phases", "PSN")
    return phases.index("P"), phases.index("S")


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def init_weights(model: nn.Module,
                 generator: torch.Generator = None) -> nn.Module:
    """Seeded random weights for either architecture, in place, at Flax's
    scales: conv kernels normal with LeCun's std 1/sqrt(fan_in) (Flax
    truncates the draw), conv biases 0, BatchNorm scale 1, bias 0, mean 0,
    var 1; drawn from `generator` (a CPU `torch.Generator`; seed 0 when
    None), module by module.  Returns the model."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                w = m.weight
                k = w.shape[-1]
                fan_in = k * (w.shape[0] if isinstance(m, nn.ConvTranspose1d)
                              else w.shape[1])
                w.copy_(torch.randn(w.shape, generator=generator)
                        / np.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()
    return model


def init_phasenet(generator: torch.Generator = None,
                  device=None) -> PhaseNet:
    """A `PhaseNet` with seeded random weights (`init_weights`), in eval
    mode, on `device` (CUDA unless 'cpu' is asked for)."""
    dev = resolve_device(device)
    return init_weights(PhaseNet(), generator).to(dev).eval()


def from_flax_variables(variables: Mapping[str, Any],
                        arch: str = "phasenet") -> Dict[str, torch.Tensor]:
    """The JAX package's Flax `variables` ({'params', 'batch_stats'}, as
    numpy or jax arrays) -> the `state_dict` of `PhaseNet` (arch
    'phasenet') or `SeisBenchPhaseNet` (arch 'seisbench'; the inverse of
    the JAX `convert_seisbench_weights`).  Flax conv kernels are (k, in,
    out) -> torch (out, in, k); Flax transposed-conv kernels (k, in, out)
    -> torch (in, out, k) with the tap axis reversed (see `_Up`).  The
    arrays keep their dtype."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def put(name, a):
        sd[name] = torch.from_numpy(np.array(a, order="C"))

    def conv(name, p):
        put(f"{name}.weight", np.transpose(p["kernel"], (2, 1, 0)))
        if "bias" in p:
            put(f"{name}.bias", p["bias"])

    def tconv(name, p):
        put(f"{name}.weight",
            np.transpose(np.asarray(p["kernel"])[::-1], (1, 2, 0)))

    def bn(name, p, s):
        put(f"{name}.weight", p["scale"])
        put(f"{name}.bias", p["bias"])
        put(f"{name}.running_mean", s["mean"])
        put(f"{name}.running_var", s["var"])
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    if arch == "phasenet":
        def block(name, p, s):
            conv(f"{name}.conv", p["Conv_0"])
            bn(f"{name}.bn", p["BatchNorm_0"], s["BatchNorm_0"])

        block("inc", params["ConvBlock_0"], stats["ConvBlock_0"])
        n_down = sum(1 for k in params if k.startswith("ConvBlock_")) - 1
        for i in range(n_down):
            block(f"down.{i}", params[f"ConvBlock_{i + 1}"],
                  stats[f"ConvBlock_{i + 1}"])
        for j in range(n_down):
            p, s = params[f"UpBlock_{j}"], stats[f"UpBlock_{j}"]
            tconv(f"up.{j}.tconv", p["ConvTranspose_0"])
            bn(f"up.{j}.bn", p["BatchNorm_0"], s["BatchNorm_0"])
            block(f"up.{j}.block", p["ConvBlock_0"], s["ConvBlock_0"])
        conv("out", params["Conv_0"])
    elif arch == "seisbench":
        conv("inc", params["inc"])
        bn("in_bn", params["in_bn"], stats["in_bn"])
        depth = sum(1 for k in params if k.endswith("_same")
                    and k.startswith("down"))
        for i in range(depth):
            conv(f"down_branch.{i}.0", params[f"down{i}_same"])
            bn(f"down_branch.{i}.1", params[f"down{i}_bn1"],
               stats[f"down{i}_bn1"])
            if i < depth - 1:
                conv(f"down_branch.{i}.2", params[f"down{i}_down"])
                bn(f"down_branch.{i}.3", params[f"down{i}_bn2"],
                   stats[f"down{i}_bn2"])
        for j in range(depth - 1):
            tconv(f"up_branch.{j}.0", params[f"up{j}_tconv"])
            bn(f"up_branch.{j}.1", params[f"up{j}_bn1"], stats[f"up{j}_bn1"])
            conv(f"up_branch.{j}.2", params[f"up{j}_same"])
            bn(f"up_branch.{j}.3", params[f"up{j}_bn2"], stats[f"up{j}_bn2"])
        conv("out", params["out"])
    else:
        raise ValueError(f"arch must be 'phasenet' or 'seisbench', got "
                         f"{arch!r}")
    return sd


def load_seisbench_checkpoint(path: str, device=None) -> SeisBenchPhaseNet:
    """A SeisBench PhaseNet checkpoint -> `SeisBenchPhaseNet` in eval mode
    on `device`: a torch ``.pt``/``.pth`` state dict (or a dict holding one
    under 'state_dict'), or an ``.npz`` of its arrays."""
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            sd = {k: torch.from_numpy(z[k]) for k in z.files}
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        sd = obj.get("state_dict", obj)
    model = SeisBenchPhaseNet()
    model.load_state_dict(sd)
    return model.to(resolve_device(device)).eval()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _ieee_convolutions():
    """cuDNN in IEEE float32 (no TF32) with deterministic algorithms, for
    a forward (or a training step) only; the caller's flags come back
    after it."""
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = saved


def _param(model) -> torch.Tensor:
    return next(model.parameters())


def _forward(model, wins: torch.Tensor) -> torch.Tensor:
    model.eval()
    with torch.inference_mode(), _ieee_convolutions():
        return model(wins)


def _starts(n: int, window: int, shift: int) -> list:
    starts = list(range(0, max(1, n - window + 1), shift))
    if starts[-1] + window < n:
        starts.append(n - window)
    return starts


def _counts(n: int, window: int, starts) -> np.ndarray:
    """How many windows cover each sample."""
    d = np.zeros(n + 1, np.int64)
    np.add.at(d, np.minimum(np.asarray(starts), n), 1)
    np.add.at(d, np.minimum(np.asarray(starts) + window, n), -1)
    return np.cumsum(d[:n])


def _sliding(model, x: torch.Tensor, window: int, shift: int,
             batch_windows: int) -> torch.Tensor:
    """Overlap-averaged probabilities (n_tr, n_classes, n) of the windows
    of a normalized (n_tr, n_ch, n >= window) day, on x's device.

    The regular windows (start k * shift) go through the model in chunks
    of about `batch_windows` (every trace of a start in one chunk); each
    chunk's outputs are summed into the day by `F.fold` (its sum per
    sample runs over the windows in order, with no atomics, so a rerun
    gives the same bits), then the last window, when the regular ones do
    not reach the end."""
    n_tr, n_ch, n = x.shape
    starts = _starts(n, window, shift)
    n_reg = (n - window) // shift + 1
    n_cls = model.out.out_channels
    probas = torch.zeros((n_tr, n_cls, n), dtype=x.dtype, device=x.device)
    regular = x.unfold(-1, window, shift)            # (n_tr, n_ch, n_reg, w)
    per = max(1, batch_windows // max(n_tr, 1))
    for k0 in range(0, n_reg, per):
        n_c = min(per, n_reg - k0)
        wins = regular[:, :, k0: k0 + n_c].permute(0, 2, 1, 3)
        out = _forward(model, wins.reshape(n_tr * n_c, n_ch, window))
        cols = out.reshape(n_tr, n_c, n_cls * window).transpose(1, 2)
        span = (n_c - 1) * shift + window
        summed = F.fold(cols, output_size=(1, span), kernel_size=(1, window),
                        stride=(1, shift))
        probas[..., k0 * shift: k0 * shift + span] += summed[:, :, 0]
    if len(starts) > n_reg:
        probas[..., n - window:] += _forward(model, x[..., n - window:])
    counts = torch.from_numpy(_counts(n, window, starts)).to(
        device=x.device, dtype=probas.dtype)
    return probas / counts.clamp(min=1.0)


def _sync(t: torch.Tensor):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)  # the stage's own time


def phasenet_probas_device(model: nn.Module, x, window: int = WINDOW,
                           overlap: float = 0.5, norm_window: int = 3000,
                           batch_windows: int = DEVICE_BATCH_WINDOWS):
    """Day-long class probabilities computed on the model's device.

    The data (n_traces, 3, n_samples), host array or tensor, moves to the
    model's device once; the sliding Z-score, every window's forward and
    the overlap average run there.  Returns (n_traces, n_classes, n) in
    the model's dtype, device-resident (a day shorter than a window is
    zero-padded to one, as the JAX package does).  The stage timers
    `pn_normalize` and `pn_forward` record the two steps."""
    p = _param(model)
    x = torch.as_tensor(x).to(device=p.device, dtype=p.dtype)
    n = x.shape[-1]
    if n < window:
        x = F.pad(x, (0, window - n))
        n = window
    with GLOBAL_TIMER.stage("pn_normalize"):
        x = normalize_batch(x, normalization_window_sample=min(norm_window,
                                                               n))
        _sync(x)
    with GLOBAL_TIMER.stage("pn_forward"):
        probas = _sliding(model, x, window,
                          max(1, int(window * (1.0 - overlap))),
                          batch_windows)
        _sync(probas)
    return probas


def sliding_window_probas(model: nn.Module, x: np.ndarray,
                          window: int = WINDOW, overlap: float = 0.5,
                          norm_window: int = 3000,
                          batch_windows: int = 64) -> np.ndarray:
    """Long-trace inference with the normalization on the host: Z-score
    normalized overlapping windows, forwards on the model's device in
    chunks of `batch_windows` windows, probabilities overlap-averaged on
    the host.

    x : (n_traces, 3, n_samples) -> (n_traces, n_classes, n_samples)
    float32 numpy."""
    n_tr, n_ch, n = x.shape
    x = normalize_batch_np(np.asarray(x, np.float32),
                           normalization_window_sample=min(norm_window, n))
    shift = max(1, int(window * (1.0 - overlap)))
    starts = _starts(n, window, shift)
    p = _param(model)
    probas = np.zeros((n_tr, model.out.out_channels, n), np.float32)
    n_chunk = max(1, batch_windows // max(n_tr, 1))
    for lo in range(0, len(starts), n_chunk):
        chunk = starts[lo: lo + n_chunk]
        wins = np.zeros((len(chunk), n_tr, n_ch, window), np.float32)
        for j, s in enumerate(chunk):
            w = x[:, :, s: s + window]
            wins[j, :, :, : w.shape[-1]] = w
        out = _forward(model, torch.from_numpy(wins.reshape(-1, n_ch, window))
                       .to(device=p.device, dtype=p.dtype))
        out = out.float().cpu().numpy().reshape(len(chunk), n_tr, -1, window)
        for j, s in enumerate(chunk):
            n_eff = min(window, n - s)
            probas[:, :, s: s + n_eff] += out[j, :, :, :n_eff]
    counts = _counts(n, window, starts).astype(np.float32)
    return probas / np.maximum(counts, 1.0)


def make_picker(model: nn.Module, **kwargs):
    """The reference-protocol picker callable: (n_sta, 3, n_t) ->
    (n_sta, 2, n_t) float32 numpy with phases (P, S), selected from the
    model's class order (`phases`: "PSN" for `PhaseNet`, "NPS" for
    `SeisBenchPhaseNet`)."""
    p_idx, s_idx = ps_channels(model)

    def picker(x):
        probas = sliding_window_probas(model, np.asarray(x), **kwargs)
        return probas[:, (p_idx, s_idx), :]  # drop the noise class

    return picker


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def gaussian_pick_labels(pick_samples: np.ndarray, n_samples: int,
                         sigma: float = 10.0) -> np.ndarray:
    """(batch, 2) P/S pick positions -> (batch, 3, n_samples) float32 soft
    labels (P, S, noise) with Gaussian blurs around each pick (a negative
    position: no pick).  The JAX function's values, in torch's layout."""
    t = np.arange(n_samples)[None, :]
    out = np.zeros((len(pick_samples), 3, n_samples), np.float32)
    for c in range(2):
        p = pick_samples[:, c: c + 1]
        valid = p >= 0
        out[:, c, :] = np.exp(-0.5 * ((t - p) / sigma) ** 2) * valid
    out[:, 2, :] = np.clip(1.0 - out[:, 0, :] - out[:, 1, :], 0.0, 1.0)
    return out


def cross_entropy_loss(probas: torch.Tensor, labels: torch.Tensor,
                       eps: float = 1e-7) -> torch.Tensor:
    """Mean over batch and time of -sum_c labels log(probas + eps), on the
    softmax output (batch, classes, time), as the JAX package computes it
    (the eps is part of the loss and of its gradient)."""
    return -torch.mean(torch.sum(labels * torch.log(probas + eps), dim=1))


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer):
    """`step((x, labels)) -> loss`: one supervised step of `model` (train
    mode: batch statistics, Flax's running averages) with `optimizer`
    (`torch.optim.Adam(model.parameters(), lr)` is optax's `adam(lr)`),
    on (batch, 3, n) windows and (batch, 3, n) labels on the model's
    device.  The convolutions and their gradients run in IEEE float32
    with deterministic algorithms (`_ieee_convolutions`).  Returns the
    step's loss as a 0-dim tensor (no host sync); the parameters' `.grad`
    keep the step's gradients."""

    def step(batch):
        x, labels = batch
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with _ieee_convolutions():
            loss = cross_entropy_loss(model(x), labels)
            loss.backward()
        optimizer.step()
        return loss.detach()

    return step
