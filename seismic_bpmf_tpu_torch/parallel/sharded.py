"""Mesh-sharded detection scans, driven by one controller.

Counterpart of `seismic_bpmf_tpu/parallel/sharded.py`, which runs one
`shard_map` program over a `jax.sharding.Mesh`.  Here one Python process
launches every shard's work on that shard's device (`parallel.mesh.Mesh`)
and returns the same global results:

  - the template and source axes shard in contiguous blocks;
  - the time axis shards in contiguous chunks, each with the first samples
    of the next chunk appended (a right halo of max(moveout) (+
    template_len)), copied from the device that holds that chunk; a
    two-sided halo serves negative MF moveouts (`_both_halos`);
  - each shard's kernel masks at absolute samples, so a sharded scan gives
    the unsharded one's values: the MF kernels take the shard's own lag
    bounds `lo_p - base`, `hi_p - base`, the BP kernel the absolute sample
    of the shard's first column (`ops.bp.bp_beam(origin=)`);
  - the max/argmax over a sharded source axis is the first-max rule across
    the shards (`ops.bp.first_max`): the largest value, then the smallest
    global source index that reaches it.

On CPU devices every shard runs the kernels' plain versions, as the
wrappers do for CPU tensors.  A device may repeat in a mesh (a virtual
mesh): its shards then run one after the other there.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import bp as _bp
from ..ops import mf as _mf
from ..ops.beamform import _flatten_moveouts, fold_components
from ..ops.matched_filter import bank_tensors, mf_lags
from ..utils.observe import GLOBAL_TIMER
from .mesh import Mesh


def _to(x: torch.Tensor, dev) -> torch.Tensor:
    """x on `dev`.  Between two CUDA devices PyTorch orders the copy after
    the work queued on the source device's current stream and before what
    is queued next on the destination's (events on both streams); on the
    same device it is x itself."""
    return x.to(dev, non_blocking=True)


def _right_halo(chunks, halo: int):
    """Append to each chunk the first `halo` samples (last axis) of the
    next one, copied from that chunk's device; the last chunk gets zeros
    (the global data end's zero padding)."""
    return _both_halos(chunks, 0, halo)


def _both_halos(chunks, left: int, right: int):
    """Halos in both directions, both cut from the ORIGINAL chunks: chunk i
    is prefixed with the last `left` samples of chunk i-1 (zeros for chunk
    0, the global data start's padding) and suffixed with the first
    `right` samples of chunk i+1 (zeros for the last).  A left halo is
    needed when template moveouts are negative."""
    n = len(chunks)
    out = []
    for i, x in enumerate(chunks):
        parts = [x]
        if left:
            parts.insert(0, _to(chunks[i - 1][..., -left:], x.device)
                         if i > 0 else x.new_zeros(x.shape[:-1] + (left,)))
        if right:
            parts.append(_to(chunks[i + 1][..., :right], x.device)
                         if i + 1 < n
                         else x.new_zeros(x.shape[:-1] + (right,)))
        out.append(torch.cat(parts, dim=-1) if len(parts) > 1 else x)
    return out


@dataclasses.dataclass(frozen=True)
class TimeLayout:
    """A day cut along time: `n_t` chunks of `chunk` columns of the padded
    layout (column j holds sample j - pad_left, zeros outside the day),
    chunk t from column t * chunk, each held with `left` columns before it
    and `right` after it (its halos)."""

    n_samp: int
    pad_left: int
    chunk: int
    left: int
    right: int
    n_t: int

    def check(self) -> None:
        if self.n_t > 1 and self.chunk < max(self.left, self.right):
            raise ValueError(
                f"time chunk ({self.chunk}) smaller than halo "
                f"({max(self.left, self.right)}); use fewer time shards")


class ShardedDay:
    """A day on a mesh: ``exts[(t, device)]`` is time chunk t with its
    halos on `device`, for every device of the grid's column t."""

    def __init__(self, layout: TimeLayout, exts: dict):
        self.layout = layout
        self.exts = exts

    def ext(self, t: int, dev) -> torch.Tensor:
        try:
            return self.exts[(t, dev)]
        except KeyError:
            raise ValueError(f"time chunk {t} is not on {dev}: the day was "
                             f"sharded over another mesh") from None


def _unique(devs) -> list:
    return list(dict.fromkeys(devs))


def _scatter(src: torch.Tensor, grid: np.ndarray, layout: TimeLayout) -> dict:
    """(n_ch, n_samp) data, host or device -> {(t, device): chunk t as
    (n_ch, chunk) f32} for every device of the grid's column t.  The first
    device of a column gets its chunk from `src`, the others copy it from
    that device."""
    n_samp, pl, chunk = layout.n_samp, layout.pad_left, layout.chunk
    chunks = {}
    for t in range(layout.n_t):
        devs = _unique(grid[:, t])
        a = max(0, t * chunk - pl)
        b = min(n_samp, (t + 1) * chunk - pl)
        x = torch.zeros((src.shape[0], chunk), dtype=torch.float32,
                        device=devs[0])
        if b > a:
            x[:, a + pl - t * chunk : b + pl - t * chunk] = _to(
                src[:, a:b], devs[0])
        for dev in devs:
            chunks[(t, dev)] = x if dev == devs[0] else _to(x, dev)
    return chunks


def _exchange(chunks: dict, grid: np.ndarray, layout: TimeLayout) -> dict:
    """The halo exchange along each row of the grid: {(t, device): chunk}
    -> {(t, device): chunk with its halos}.  Rows that hold the same
    devices (a virtual mesh) are exchanged once."""
    exts = {}
    for row in {tuple(r) for r in grid}:
        if all((t, d) in exts for t, d in enumerate(row)):
            continue
        got = _both_halos([chunks[(t, d)] for t, d in enumerate(row)],
                          layout.left, layout.right)
        for t, d in enumerate(row):
            exts.setdefault((t, d), got[t])
    return exts


def shard_day(data, grid: np.ndarray, layout: TimeLayout,
              dtype: str = "float32") -> ShardedDay:
    """Host or device data (n_sta, n_comp, n_samp) or (n_ch, n_samp) ->
    its time chunks with halos on the grid's devices (`_scatter`, then
    `_exchange`).  ``dtype='bfloat16'`` rounds a host day to bf16 before
    it ships (the `screen` upload of `ops.mf.pad_day_data`)."""
    if isinstance(data, torch.Tensor):
        src = data.reshape(-1, layout.n_samp)
    else:
        src = torch.from_numpy(np.ascontiguousarray(
            np.asarray(data, np.float32).reshape(-1, layout.n_samp)))
    if dtype == "bfloat16":
        src = src.to(torch.bfloat16)
    elif dtype != "float32":
        raise ValueError(f"unknown upload dtype {dtype!r}")
    return ShardedDay(layout, _exchange(_scatter(src, grid, layout), grid,
                                        layout))


# ---------------------------------------------------------------------------
# Matched filter: mesh ('tp', 'time')
# ---------------------------------------------------------------------------

def _blocks(n: int, n_dev: int, multiple: int = 1) -> list:
    """[(shard, first, end)] of n items in contiguous blocks of
    ceil(n / n_dev) rounded up to `multiple`; empty shards left out."""
    per = -(-max(n, 1) // n_dev)
    per = -(-per // multiple) * multiple
    return [(a, a * per, min(n, (a + 1) * per)) for a in range(n_dev)
            if a * per < n]


def mf_layout(n_samp: int, L: int, pad_left: int, max_moveout: int,
              n_t: int) -> TimeLayout:
    """The kernels' time layout: each shard scans `chunk` lags, a multiple
    of every MF kernel's lag tile, so every shard's lag tiles are the
    unsharded scan's; together the chunks cover the padded day, so the last
    shard's halo is truly zero.  The halo, max padded moveout + L, holds
    every window of the chunk's lags."""
    tile = math.lcm(_mf.LAG_TILE, _mf.SPLIT_LAG_TILE) * n_t
    total = -(-max(n_samp - L + 1, pad_left + n_samp) // tile) * tile
    layout = TimeLayout(n_samp=int(n_samp), pad_left=int(pad_left),
                        chunk=total // n_t, left=0,
                        right=int(max_moveout) + int(pad_left) + int(L),
                        n_t=int(n_t))
    layout.check()
    return layout


# each rung's kernel wrapper in `ops.mf` and the pre-pass it launches first
_RUNG_KERNELS = {"high": ("mf_cc_split", "split_day"),
                 "highest": ("mf_cc_highest", "tf32_day"),
                 "default": ("mf_cc", "tf32_day")}


class ShardedMatchedFilterPlan:
    """`ops.mf.MatchedFilterPlan` over a mesh: one plan per template shard
    on each of its devices; a day is scanned as time shards
    (`pad_data` -> `ShardedDay`), shard (a, t) launching its rung's
    kernel on device ``grid[a, t]`` for the chunk's lags with the global
    lag bounds moved to the chunk (`shard_cc`).  `pad_left`/`max_moveout`
    fix the padded layout as for `MatchedFilterPlan`.  Results gather on
    the first device of the mesh."""

    def __init__(self, templates, moveouts, weights, n_samp: int,
                 mesh: Mesh, lag_block: int = 4096,
                 precision: str = "highest", pad_left: int = None,
                 max_moveout: int = None, tp_axis: str = "tp",
                 time_axis: str = "time"):
        templates = np.asarray(templates, np.float32)
        moveouts = np.asarray(moveouts, np.int64)
        weights = np.asarray(weights, np.float32)
        n_tp, L = templates.shape[0], templates.shape[-1]
        mv = moveouts.reshape(n_tp, -1)
        if pad_left is None:
            pad_left = -int(min(0, mv.min(initial=0)))
        if max_moveout is None:
            max_moveout = int(mv.max(initial=0))
        self.grid = mesh.grid(tp_axis, time_axis)
        self.device = self.grid.flat[0]
        self.n_samp = int(n_samp)
        self.n_corr_unit = self.n_samp - L + 1
        self.shards = _blocks(n_tp, self.grid.shape[0])
        self.plans = {}
        for a, s0, s1 in self.shards:
            for dev in _unique(self.grid[a]):
                self.plans[(a, dev)] = _mf.MatchedFilterPlan(
                    templates[s0:s1], moveouts[s0:s1], weights[s0:s1],
                    n_samp, lag_block=lag_block, precision=precision,
                    pad_left=pad_left, max_moveout=max_moveout, device=dev)
        self.pad_left = int(pad_left)
        self.layout = mf_layout(self.n_samp, L, self.pad_left, max_moveout,
                                self.grid.shape[1])

    def pad_data(self, data, dtype: str = "float32") -> ShardedDay:
        return shard_day(data, self.grid, self.layout, dtype=dtype)

    def n_lags(self, t: int) -> int:
        """Lags of time shard t inside the scan (0: nothing to launch)."""
        return max(0, min(self.layout.chunk,
                          self.n_corr_unit - t * self.layout.chunk))

    def shard_cc(self, day: ShardedDay, a: int, t: int) -> torch.Tensor:
        """(templates of shard a, n_lags(t)) CC of one shard on its
        device: one launch of the rung's kernel."""
        dev = self.grid[a, t]
        plan = self.plans[(a, dev)]
        base = t * self.layout.chunk
        wrapper = getattr(_mf, _RUNG_KERNELS[plan.precision_name][0])
        return wrapper(day.ext(t, dev), plan.filt_rows, plan.mv_table,
                       plan.tile_lo, n_tp=plan.n_tp, L=plan.L,
                       n_corr=self.n_lags(t), lo_p=plan.lo_p - base,
                       hi_p=plan.hi_p - base, max_delta=plan.max_delta,
                       lag_block=plan.lag_block)

    def __call__(self, day: ShardedDay) -> torch.Tensor:
        """A sharded day -> (n_tp, n_corr) CC on the mesh's first device.
        The host time of queueing the shards' launches and copies is the
        `mf_shard_scan` stage of `utils.observe.GLOBAL_TIMER`; its meters
        are `mf_shard_launches` (the kernel launches queued: the rung's
        pre-pass and main kernel, as `ops.mf`'s launch counters count
        them, so 0 on CPU devices) and `mf_gather_bytes` (the CC bytes
        copied into the first device from another one: 0 where a shard's
        device is the first itself, as on a virtual mesh)."""
        if day.layout != self.layout:
            raise ValueError(f"day layout {day.layout}, plan {self.layout}")
        rung = next(iter(self.plans.values())).precision_name
        counters = [getattr(_mf, name) for name in _RUNG_KERNELS[rung]]
        launched = sum(c.launches for c in counters)
        rows, gathered = [], 0
        with GLOBAL_TIMER.stage("mf_shard_scan"):
            for a, _, _ in self.shards:
                blocks = []
                for t in range(self.layout.n_t):
                    if not self.n_lags(t):
                        continue
                    cc = self.shard_cc(day, a, t)
                    if self.grid[a, t] != self.device:
                        gathered += cc.numel() * cc.element_size()
                    blocks.append(_to(cc, self.device))
                rows.append(torch.cat(blocks, dim=1))
            out = torch.cat(rows, dim=0)
        GLOBAL_TIMER.add("mf_shard_launches",
                         sum(c.launches for c in counters) - launched)
        GLOBAL_TIMER.add("mf_gather_bytes", gathered)
        return out


def matched_filter_sharded_pallas(
    templates,
    moveouts,
    weights,
    data,
    mesh: Mesh,
    step: int = 1,
    lag_block: int = 4096,
    tp_axis: str = "tp",
    time_axis: str = "time",
    precision: str = "highest",
):
    """The production sharded matched filter: the rung's CUDA kernel
    (`ops.mf`) runs per shard with the template bank sharded over
    `tp_axis` and the padded data over `time_axis` (a right halo of
    max padded moveout + template_len).

    Matches `ops.mf.matched_filter` (each shard masks its lags against the
    global data bounds).  `lag_block` is the plain versions' lag chunk.
    Returns (n_tp, (n_samp - L) // step + 1) on the mesh's first device."""
    n_samp, L = np.shape(data)[-1], np.shape(templates)[-1]
    plan = ShardedMatchedFilterPlan(templates, moveouts, weights, n_samp,
                                    mesh, lag_block=lag_block,
                                    precision=precision, tp_axis=tp_axis,
                                    time_axis=time_axis)
    out = plan(plan.pad_data(data))
    if step > 1:
        out = out[:, ::step][:, : (n_samp - L) // step + 1]
    return out


def matched_filter_sharded(
    templates,
    moveouts,
    weights,
    data,
    mesh: Mesh,
    step: int = 1,
    tp_axis: str = "tp",
    time_axis: str = "time",
):
    """Matched filter with the template bank sharded over `tp_axis` and the
    continuous data over `time_axis`, each shard through the plain-torch
    engine (`ops.matched_filter.mf_lags`).  Matches
    `ops.matched_filter.matched_filter(..., network_sum=True)`.  Negative
    moveouts (template windows opening before the reference phase) take a
    left halo of -min(moveout)."""
    templates = np.asarray(templates, np.float32)
    moveouts = np.asarray(moveouts, np.int64)
    weights = np.asarray(weights, np.float32)
    n_tp, L = templates.shape[0], templates.shape[-1]
    n_samp = np.shape(data)[-1]
    n_corr = (n_samp - L) // step + 1
    max_mv = int(moveouts.max(initial=0))
    pad_left = -min(0, int(moveouts.min(initial=0)))
    grid = mesh.grid(tp_axis, time_axis)
    n_t = grid.shape[1]
    chunk = -(-n_samp // n_t)
    chunk = -(-chunk // step) * step
    # a chunk's data: its samples, pad_left before, max_mv + L after
    layout = TimeLayout(n_samp=n_samp, pad_left=0, chunk=chunk,
                        left=pad_left, right=max_mv + L, n_t=n_t)
    layout.check()
    day = shard_day(data, grid, layout)
    lags = chunk // step
    out_dev = grid.flat[0]
    rows = []
    for a, s0, s1 in _blocks(n_tp, grid.shape[0]):
        tensors = {}
        blocks = []
        for t in range(n_t):
            n_lags = min(lags, n_corr - t * lags)
            if n_lags <= 0:
                continue
            dev = grid[a, t]
            if dev not in tensors:
                tensors[dev] = bank_tensors(templates[s0:s1],
                                            moveouts[s0:s1],
                                            weights[s0:s1], pad_left, dev)
            # the chunk's column 0 is padded position t * chunk
            blocks.append(_to(mf_lags(
                *tensors[dev], day.ext(t, dev), t * chunk, n_lags,
                step=step, n_samp=n_samp, pad_left=pad_left, L=L),
                out_dev))
        rows.append(torch.cat(blocks, dim=1))
    return torch.cat(rows, dim=0)


# ---------------------------------------------------------------------------
# Beamforming: mesh ('src', 'time')
# ---------------------------------------------------------------------------

def _tables_to(tab: _bp.BPTables, dev) -> _bp.BPTables:
    """A plan's tables with every tensor on `dev`."""
    return dataclasses.replace(tab, **{
        f.name: getattr(tab, f.name).to(dev)
        for f in dataclasses.fields(tab)
        if isinstance(getattr(tab, f.name), torch.Tensor)})


class ShardedBeamformPlan:
    """`ops.bp.BeamformPlan` over a mesh: the sources in contiguous shards
    of a multiple of the kernel's source tile (`ops.bp.SRC_TILE`), each
    with its own `ops.bp.BPTables` on each of its devices; the folded
    features in time shards of whole time tiles with a right halo of the
    tables' moveout margin.  Shard (a, t) launches the BP kernel on
    ``grid[a, t]`` over its time tiles, its first column at absolute
    sample t * chunk (`shard_beam`).  'max' merges the source shards with
    `ops.bp.first_max` on global source indices; 'none' stitches the
    (source, time) blocks.  `tables`, the per-shard tables of a plan of the
    same moveouts, weights and mesh, are reused for this day length and
    policy.  Results gather on the mesh's first device."""

    def __init__(self, moveouts, weights_phases, weights_sources,
                 n_samp: int, mesh: Mesh, reduce: str = "max",
                 out_of_bounds: str = "strict", precision: str = "highest",
                 src_axis: str = "src", time_axis: str = "time",
                 tables: dict = None):
        if reduce not in ("max", "none"):
            raise ValueError(f"reduce must be 'max' or 'none', got "
                             f"{reduce!r}")
        if out_of_bounds not in ("strict", "flexible"):
            raise ValueError(f"out_of_bounds must be 'strict' or 'flexible', "
                             f"got {out_of_bounds!r}")
        self.mode = _bp._precision_mode(precision)
        self.grid = mesh.grid(src_axis, time_axis)
        self.device = self.grid.flat[0]
        self.n_samp, self.reduce = int(n_samp), reduce
        self.strict = out_of_bounds == "strict"
        mv_flat, w_flat, mv_lo, mv_hi = _flatten_moveouts(
            moveouts, weights_phases, weights_sources)
        self.n_src, self.n_sp = mv_flat.shape
        self.shards = _blocks(self.n_src, self.grid.shape[0], _bp.SRC_TILE)
        if tables is not None:
            self.tables = {k: tab.retimed(n_samp, self.strict)
                           for k, tab in tables.items()}
        else:
            self.tables = {}
            for a, s0, s1 in self.shards:
                devs = _unique(self.grid[a])
                tab = _bp.build_tables(mv_flat[s0:s1], w_flat[s0:s1],
                                       mv_lo[s0:s1], mv_hi[s0:s1], n_samp,
                                       self.strict, devs[0])
                for dev in devs:
                    self.tables[(a, dev)] = (tab if dev == devs[0]
                                             else _tables_to(tab, dev))
        self.weights_phases = torch.from_numpy(
            np.ascontiguousarray(weights_phases, np.float32)).to(self.device)
        self.n_t_blocks = max(1, math.ceil(self.n_samp / _bp.TIME_TILE))
        n_t = self.grid.shape[1]
        self.tiles = -(-self.n_t_blocks // n_t)     # time tiles a shard
        margin = _bp._round_up(int(mv_flat.max(initial=0)) + 1, 128)
        self.layout = TimeLayout(n_samp=self.n_samp, pad_left=0,
                                 chunk=self.tiles * _bp.TIME_TILE, left=0,
                                 right=margin, n_t=n_t)
        self.layout.check()

    def fold_and_pad(self, features) -> ShardedDay:
        """(n_sta, n_comp, n_samp) features, host or device -> the folded
        features in time shards with halos on the mesh."""
        if isinstance(features, torch.Tensor):
            feat = features.to(device=self.device, dtype=torch.float32)
        else:
            feat = torch.from_numpy(
                np.ascontiguousarray(features, np.float32)).to(self.device)
        if feat.shape[-1] != self.n_samp:
            raise ValueError(f"features have {feat.shape[-1]} samples, the "
                             f"plan {self.n_samp}")
        g = fold_components(feat, self.weights_phases)
        return shard_day(g, self.grid, self.layout)

    def tile_range(self, t: int) -> tuple:
        """(first tile, tiles) of time shard t; 0 tiles: nothing to do."""
        tile0 = t * self.tiles
        return tile0, max(0, min(self.tiles, self.n_t_blocks - tile0))

    def shard_beam(self, day: ShardedDay, a: int, t: int):
        """One shard's `ops.bp.bp_beam` on its device: (val, idx) with
        the shard's local source indices, or its (sources, samples) beam."""
        dev = self.grid[a, t]
        tile0, n_tt = self.tile_range(t)
        return _bp.bp_beam(day.ext(t, dev), self.tables[(a, dev)],
                           reduce=self.reduce, tile0=tile0, n_tt=n_tt,
                           origin=t * self.layout.chunk)

    def __call__(self, features):
        return self.call_folded(self.fold_and_pad(features))

    def call_folded(self, day: ShardedDay):
        if day.layout != self.layout:
            raise ValueError(f"day layout {day.layout}, plan {self.layout}")
        out = self.device
        if self.reduce == "none":
            beam = torch.empty((self.n_src, self.n_samp),
                               dtype=torch.float32, device=out)
            for t in range(self.layout.n_t):
                if not self.tile_range(t)[1]:
                    continue
                t0 = t * self.layout.chunk
                for a, s0, s1 in self.shards:
                    b = self.shard_beam(day, a, t)
                    beam[s0:s1, t0 : t0 + b.shape[1]] = _to(b, out)
            return beam
        vals, idxs = [], []
        for t in range(self.layout.n_t):
            if not self.tile_range(t)[1]:
                continue
            got = [self.shard_beam(day, a, t) for a, _, _ in self.shards]
            v, i = _bp.first_max(
                torch.stack([_to(v, out) for v, _ in got]),
                torch.stack([_to(i, out) + s0
                             for (_, i), (_, s0, _) in zip(got,
                                                           self.shards)]))
            vals.append(v)
            idxs.append(i)
        return (torch.cat(vals)[: self.n_samp],
                torch.cat(idxs)[: self.n_samp])


def beamform_sharded_pallas(
    features,
    moveouts,
    weights_phases,
    weights_sources,
    mesh: Mesh,
    reduce: str = "max",
    out_of_bounds: str = "strict",
    src_axis: str = "src",
    time_axis: str = "time",
    precision: str = "highest",
):
    """The production sharded beamformer: the CUDA kernel (`ops.bp`) runs
    per shard with the source grid sharded over `src_axis` and the folded
    features over `time_axis` (a right halo of the moveout margin).  The
    global max/argmax over sources keeps the first-max rule.

    Matches `ops.bp.beamform`: reduce='max' -> (maxbeam (n_samp,), sources
    (n_samp,) int32), 'none' -> (n_src, n_samp), on the mesh's first
    device.  Moveouts must be >= 0."""
    plan = ShardedBeamformPlan(moveouts, weights_phases, weights_sources,
                               np.shape(features)[-1], mesh, reduce=reduce,
                               out_of_bounds=out_of_bounds,
                               precision=precision, src_axis=src_axis,
                               time_axis=time_axis)
    return plan(features)


def beamform_sharded(
    features,
    moveouts,
    weights_phases,
    weights_sources,
    mesh: Mesh,
    reduce: str = "max",
    out_of_bounds: str = "strict",
    engine: str = "onehot",
    src_axis: str = "src",
    time_axis: str = "time",
):
    """`beamform_sharded_pallas`.  The port has one beamforming route (the
    CUDA kernel, its plain version on CPU devices), so the JAX package's
    XLA `engine` choice is accepted and ignored, as `Beamformer` has no
    engine knob."""
    return beamform_sharded_pallas(
        features, moveouts, weights_phases, weights_sources, mesh,
        reduce=reduce, out_of_bounds=out_of_bounds, src_axis=src_axis,
        time_axis=time_axis)
