"""Shift-and-stack beamforming (backprojection) on the card.

Counterpart of `seismic_bpmf_tpu/ops/pallas_bp.py`.  Same semantics as
`ops.reference.beamform`:

    beam[i, t] = sum_sp w[i, sp] * g[sp, t + mv[i, sp]]

on the component-folded features g, with the 'strict' policy zeroing the
beam wherever a used station-phase points outside the day and
``reduce='max'`` keeping, per sample, the largest beam and the smallest
source index that reaches it.

The CUDA kernel (`csrc/bp.cu`, wrapped by `bp_beam`) reads a moveout as an
address offset into a shared-memory time tile, so the plan keeps, per tile
of `SRC_TILE` sources, the station-phases that the tile uses (each with its
lowest used moveout and spread), cut into stages that fit a block's shared
memory, and, per stage and source, the compact list of the source's used
(station-phase, offset, weight) pairs.  `beamform_plain` is the same
function in plain PyTorch, a gather per station-phase; `bp_beam` uses it
only for tensors on the CPU.

Padded feature layout: ``(n_sp, n_t_blocks * TIME_TILE + M)`` f32, the day
at column 0 and zeros after it, M > the largest moveout.  Moveouts must be
>= 0 (BPMF moveouts are relative to the first arrival).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from .beamform import _flatten_moveouts, fold_components

TIME_TILE = 512      # samples per kernel block (BP_T in csrc/bp.cu)
SRC_TILE = 32        # sources per source tile (BP_S)
SMEM_LIMIT = 232448       # dynamic shared memory one block may use on sm_90
PP_WORDS = 34             # stage_pp words of a stage (BP_PP)
PLAIN_POINTS = 2**26      # beam points per source chunk of the plain version
TARGET_BLOCKS = 2048      # the grid is cut along sources to about this many

_BOUND: set = set()


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _precision_mode(precision: str) -> str:
    """The JAX package's rung names are kept as error classes: every rung
    runs the kernel in f32, since a direct gather selects exactly and
    sums in f32, inside each rung's class."""
    if precision not in ("highest", "high", "default"):
        raise ValueError(f"unknown precision {precision!r}")
    return "f32"


def _lib():
    from .. import _build

    lib = _build.load("bp")
    if "bp" not in _BOUND:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bp_launch.argtypes = ([vp, i64] + [vp] * 9
                                  + [i32, i32, i32, i64, i64, i64, i32, i32,
                                     i32, i32] + [vp] * 5)
        lib.bp_launch.restype = i32
        lib.bp_smem_bytes.argtypes = [i32, i32, i32]
        lib.bp_smem_bytes.restype = i64
        lib.bp_error_string.argtypes = [i32]
        lib.bp_error_string.restype = ctypes.c_char_p
        for fn in (lib.bp_tile_samples, lib.bp_tile_sources):
            fn.argtypes, fn.restype = [], i32
        if (lib.bp_tile_samples() != TIME_TILE
                or lib.bp_tile_sources() != SRC_TILE
                or lib.bp_smem_bytes(TIME_TILE, 1, 64)
                != _smem_bytes(TIME_TILE, 1, 64)):
            raise RuntimeError("csrc/bp.cu and ops/bp.py disagree on the "
                               "kernel's tile sizes")
        _BOUND.add("bp")
    return lib


def _smem_bytes(stride: int, max_rows: int, max_pairs: int) -> int:
    """Mirror of `bp_smem_bytes` in csrc/bp.cu: the argmax keys and two
    staging buffers (a stage's pairs, stage_pp words and rows)."""
    buf = 8 * max_pairs + 4 * PP_WORDS + 4 * max_rows * stride
    return 8 * TIME_TILE + 2 * _round_up(buf, 16)


@dataclass
class BPTables:
    """Device tables of one plan, shared by the kernel and its plain
    version.  Dense (plain version): mv, w (n_sp, n_src).  Compact
    (kernel): source tiles of SRC_TILE consecutive sources, each cut into
    one or more stages, the CSR bounds `tile_stage`; per stage the CSR list
    `stage_row` of its staged rows (station-phase `ent_sp`, lowest used
    moveout `ent_lo`, spread `ent_span`, in ascending station-phase order)
    and `stage_pp` (n_stages, PP_WORDS): where each of the tile's sources'
    pairs of the stage start in `pairs` (the last words repeat the end).
    A pair is (row * stride + offset, weight bits) as int32, the row
    counted within its stage.  lo, hi: per-source used-moveout bounds of
    the strict policy."""

    mv: torch.Tensor
    w: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    tile_stage: torch.Tensor
    stage_pp: torch.Tensor
    pairs: torch.Tensor
    stage_row: torch.Tensor
    ent_sp: torch.Tensor
    ent_lo: torch.Tensor
    ent_span: torch.Tensor
    n_samp: int
    n_t_blocks: int
    ext: int
    strict: bool
    stride: int
    max_rows: int
    max_pairs: int

    @property
    def n_src(self) -> int:
        return self.mv.shape[1]

    @property
    def n_sp(self) -> int:
        return self.mv.shape[0]

    @property
    def n_tiles(self) -> int:
        return self.tile_stage.shape[0] - 1

    @property
    def n_stages(self) -> int:
        return self.stage_row.shape[0] - 1

    @property
    def n_pairs(self) -> int:
        return self.pairs.shape[0]


def build_tables(mv_flat, w_flat, mv_lo, mv_hi, n_samp: int, strict: bool,
                 device) -> BPTables:
    """Host build of a plan's tables from `_flatten_moveouts` output.

    A tile's rows are cut, in ascending station-phase order, into as few
    stages of as even a size as fit one of the kernel's two staging
    buffers.  Raises ValueError when a moveout is negative or when a single
    row (the time tile plus the spread of one station-phase's used
    moveouts within a tile) does not fit."""
    n_src, n_sp = mv_flat.shape
    if int(mv_flat.min(initial=0)) < 0:
        raise ValueError("moveouts must be non-negative")
    mv = np.ascontiguousarray(mv_flat, np.int32)
    w = np.ascontiguousarray(w_flat, np.float32)
    used = w != 0.0
    big = np.iinfo(np.int32).max
    starts = np.arange(0, n_src, SRC_TILE)
    n_tiles = len(starts)

    # staged rows: the station-phases each tile uses
    lo_t = np.minimum.reduceat(np.where(used, mv, big), starts, axis=0)
    row_used = lo_t != big                                      # (tiles, sp)
    hi_t = np.maximum.reduceat(np.where(used, mv, -1), starts, axis=0)
    span_t = np.where(row_used, hi_t - lo_t, 0)
    stride = _round_up(int(span_t.max(initial=0)) + TIME_TILE, 32)
    max_tile_pairs = int(np.add.reduceat(used.sum(axis=1), starts).max())
    rows_max = ((SMEM_LIMIT - _smem_bytes(0, 0, max_tile_pairs) - 32)
                // (8 * stride))
    if rows_max < 1:
        raise ValueError(
            f"a station-phase's used moveouts spread over "
            f"{int(span_t.max())} samples within a tile of {SRC_TILE} "
            f"sources: its row of {stride} samples does not fit one kernel "
            f"block's shared memory")
    # stages: each tile's rows in ascending station-phase order, cut into
    # n_st even parts; a tile with no used row still has one stage
    rows = row_used.sum(axis=1)
    n_st = np.maximum(1, -(-rows // rows_max))
    per = np.maximum(1, -(-rows // n_st))[:, None]
    tile_stage = np.concatenate([[0], np.cumsum(n_st)])
    n_stages = int(tile_stage[-1])
    k_of = np.cumsum(row_used, axis=1) - 1        # row of (tile, sp) in tile
    stage_of = tile_stage[:-1, None] + k_of // per
    ent_tile, ent_sp = np.nonzero(row_used)      # by stage, then sp
    ent_lo = lo_t[ent_tile, ent_sp]
    ent_span = hi_t[ent_tile, ent_sp] - ent_lo
    stage_row = np.concatenate([[0], np.cumsum(np.bincount(
        stage_of[ent_tile, ent_sp], minlength=n_stages))])

    # pairs by stage, then source, then station-phase (the sum order)
    src, sp = np.nonzero(used)
    tile = src // SRC_TILE
    order = np.argsort(stage_of[tile, sp], kind="stable")
    src, sp, tile = src[order], sp[order], tile[order]
    stage = stage_of[tile, sp]
    counts = np.bincount(stage * SRC_TILE + src % SRC_TILE,
                         minlength=n_stages * SRC_TILE).reshape(
                             n_stages, SRC_TILE)
    first = np.concatenate([[0], np.cumsum(counts.sum(axis=1))[:-1]])
    stage_pp = np.empty((n_stages, PP_WORDS), np.int64)
    stage_pp[:, 0] = first
    stage_pp[:, 1:SRC_TILE + 1] = first[:, None] + np.cumsum(counts, axis=1)
    stage_pp[:, SRC_TILE + 1:] = stage_pp[:, SRC_TILE:SRC_TILE + 1]

    max_mv = int(mv_flat.max(initial=0))
    n_t_blocks = max(1, math.ceil(n_samp / TIME_TILE))

    def t(a, dtype=np.int32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return BPTables(
        mv=t(mv.T), w=t(w.T, np.float32), lo=t(mv_lo), hi=t(mv_hi),
        tile_stage=t(tile_stage), stage_pp=t(stage_pp), pairs=t(np.stack(
            [(k_of[tile, sp] % per[tile, 0]) * stride + mv[src, sp]
             - lo_t[tile, sp], w[src, sp].view(np.int32)], axis=1)),
        stage_row=t(stage_row), ent_sp=t(ent_sp), ent_lo=t(ent_lo),
        ent_span=t(ent_span), n_samp=int(n_samp), n_t_blocks=n_t_blocks,
        ext=n_t_blocks * TIME_TILE + _round_up(max_mv + 1, 128),
        strict=bool(strict), stride=stride,
        max_rows=int(np.diff(stage_row).max(initial=0)),
        max_pairs=int(counts.sum(axis=1).max(initial=0)),
    )


def _range(tab: BPTables, reduce: str, tile0: int, n_tt):
    n_tt = tab.n_t_blocks - tile0 if n_tt is None else int(n_tt)
    if reduce not in ("max", "none"):
        raise ValueError(f"reduce must be 'max' or 'none', got {reduce!r}")
    if reduce == "none" and (tile0 != 0 or n_tt != tab.n_t_blocks):
        raise ValueError("reduce='none' covers the whole day in one call")
    if tile0 < 0 or n_tt < 1 or tile0 + n_tt > tab.n_t_blocks:
        raise ValueError(f"time tiles [{tile0}, {tile0 + n_tt}) outside "
                         f"[0, {tab.n_t_blocks})")
    return int(tile0), n_tt


def beamform_plain(g_pad, tab: BPTables, *, reduce: str = "max",
                   tile0: int = 0, n_tt=None):
    """Plain PyTorch version of the kernel, on the tensors' device.

    reduce='max': (val, idx) of the n_tt * TIME_TILE samples from tile
    `tile0` on; reduce='none': the (n_src, n_samp) beam.  A gather per
    station-phase, summed in f32 in ascending station-phase order, and a
    running (max, argmax) over chunks of about PLAIN_POINTS beam points in
    which the first maximum wins."""
    beamform_plain.calls += 1
    tile0, n_tt = _range(tab, reduce, tile0, n_tt)
    dev = g_pad.device
    t_a = tile0 * TIME_TILE
    n_t = tab.n_samp if reduce == "none" else n_tt * TIME_TILE
    t_abs = torch.arange(t_a, t_a + n_t, device=dev)
    src_chunk = max(1, PLAIN_POINTS // n_t)
    if reduce == "none":
        out = torch.empty((tab.n_src, n_t), dtype=torch.float32, device=dev)
    else:
        best_v = torch.full((n_t,), float("-inf"), device=dev)
        best_i = torch.zeros((n_t,), dtype=torch.int32, device=dev)
    for s0 in range(0, tab.n_src, src_chunk):
        s1 = min(tab.n_src, s0 + src_chunk)
        beam = torch.zeros((s1 - s0, n_t), dtype=torch.float32, device=dev)
        for sp in range(tab.n_sp):
            # the sources that use this station-phase (a zero weight adds
            # w * x = +-0 to the sum: skipping it changes no value)
            use = torch.nonzero(tab.w[sp, s0:s1]).flatten()
            if use.numel() == 0:
                continue
            windows = g_pad[sp].unfold(0, n_t, 1)     # (n_pos, n_t) view
            rows = windows[t_a + tab.mv[sp, s0 + use].long()]
            beam[use] = beam[use] + tab.w[sp, s0 + use, None] * rows
        if tab.strict:
            ok = ((t_abs[None, :] + tab.lo[s0:s1, None] >= 0)
                  & (t_abs[None, :] + tab.hi[s0:s1, None] < tab.n_samp))
            beam = torch.where(ok, beam, torch.zeros_like(beam))
        if reduce == "none":
            out[s0:s1] = beam
            continue
        v = beam.max(dim=0).values
        ids = torch.arange(s0, s1, dtype=torch.int32, device=dev)[:, None]
        first = torch.where(beam == v, ids, torch.full_like(ids, 2**30))
        i = first.min(dim=0).values
        take = v > best_v
        best_v = torch.where(take, v, best_v)
        best_i = torch.where(take, i, best_i)
    return out if reduce == "none" else (best_v, best_i)


beamform_plain.calls = 0


def bp_beam(g_pad, tab: BPTables, *, reduce: str = "max", tile0: int = 0,
            n_tt=None):
    """The beam of a plan's tables on padded folded features: (val, idx)
    of the time tiles [tile0, tile0 + n_tt) for reduce='max', the
    (n_src, n_samp) beam for 'none'.

    On CPU tensors this is `beamform_plain`; on CUDA tensors it launches
    the kernel of csrc/bp.cu or raises."""
    if g_pad.dtype != torch.float32 or not g_pad.is_contiguous():
        raise ValueError("the padded features must be contiguous float32")
    if tuple(g_pad.shape) != (tab.n_sp, tab.ext):
        raise ValueError(f"padded features have shape {tuple(g_pad.shape)}, "
                         f"the plan's layout is {(tab.n_sp, tab.ext)}")
    if g_pad.device.type == "cpu":
        return beamform_plain(g_pad, tab, reduce=reduce, tile0=tile0,
                              n_tt=n_tt)
    if g_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {g_pad.device}")
    tile0, n_tt = _range(tab, reduce, tile0, n_tt)
    for name in ("tile_stage", "stage_pp", "pairs", "lo", "hi", "stage_row",
                 "ent_sp", "ent_lo", "ent_span"):
        t = getattr(tab, name)
        if t.device != g_pad.device:
            raise ValueError(f"{name} is on {t.device}, features on "
                             f"{g_pad.device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")
    if (tab.n_tiles != -(-tab.n_src // SRC_TILE)
            or tuple(tab.stage_pp.shape) != (tab.n_stages, PP_WORDS)
            or tuple(tab.pairs.shape) != (tab.n_pairs, 2)
            or _smem_bytes(tab.stride, tab.max_rows, tab.max_pairs)
            > SMEM_LIMIT):
        raise ValueError("inconsistent beamforming plan tables")
    dev = g_pad.device
    n_splits = min(tab.n_tiles, max(1, -(-TARGET_BLOCKS // n_tt)))
    if reduce == "none":
        beam = torch.empty((tab.n_src, tab.n_samp), dtype=torch.float32,
                           device=dev)
        keys = val = idx = None
    else:
        beam = None
        keys = torch.zeros(n_tt * TIME_TILE, dtype=torch.int64, device=dev)
        val = torch.empty(n_tt * TIME_TILE, dtype=torch.float32, device=dev)
        idx = torch.empty(n_tt * TIME_TILE, dtype=torch.int32, device=dev)
    lib = _lib()

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bp_launch(
            g_pad.data_ptr(), tab.ext, ptr(tab.tile_stage),
            ptr(tab.stage_pp), ptr(tab.pairs), ptr(tab.lo), ptr(tab.hi),
            ptr(tab.stage_row), ptr(tab.ent_sp), ptr(tab.ent_lo),
            ptr(tab.ent_span), tab.n_src, tab.n_tiles, n_splits, tile0, n_tt,
            tab.n_samp, int(tab.strict), tab.stride, tab.max_rows,
            tab.max_pairs, ptr(keys),
            ptr(val), ptr(idx), ptr(beam), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"bp kernel launch failed: {lib.bp_error_string(rc).decode()}"
        )
    bp_beam.launches += 1
    return beam if reduce == "none" else (val, idx)


bp_beam.launches = 0


class BeamformPlan:
    """Device-resident beamforming plan: moveouts and weights moved to the
    device once, then applied to any number of feature sets (e.g.
    consecutive days).  Counterpart of `PallasBeamformPlan`; the TPU's
    blocking knobs and diagnostics have no counterpart (the kernel's tiles
    are fixed in csrc/bp.cu).  `precision` keeps the rung names as error
    classes (every rung runs the f32 kernel)."""

    # max beam points per kernel call before a 'max' day is cut into
    # calls over consecutive time tiles (`call_folded_chunked`, bit for
    # bit the single call): the JAX package's contract
    CHUNK_POINTS = 2 * 10**10

    def __init__(self, moveouts, weights_phases, weights_sources,
                 n_samp: int, reduce: str = "max",
                 out_of_bounds: str = "strict", precision: str = "highest",
                 device=None):
        if reduce not in ("max", "none"):
            raise ValueError(f"reduce must be 'max' or 'none', got "
                             f"{reduce!r}")
        if out_of_bounds not in ("strict", "flexible"):
            raise ValueError(f"out_of_bounds must be 'strict' or 'flexible', "
                             f"got {out_of_bounds!r}")
        self.mode = _precision_mode(precision)
        self.device = resolve_device(device)
        mv_flat, w_flat, mv_lo, mv_hi = _flatten_moveouts(
            moveouts, weights_phases, weights_sources)
        self.tables = build_tables(mv_flat, w_flat, mv_lo, mv_hi, n_samp,
                                   out_of_bounds == "strict", self.device)
        self.weights_phases = torch.from_numpy(
            np.ascontiguousarray(weights_phases, np.float32)).to(self.device)
        self.n_samp = int(n_samp)
        self.reduce = reduce
        self.strict = out_of_bounds == "strict"
        self.n_src, self.n_sp = mv_flat.shape
        self.n_t_blocks = self.tables.n_t_blocks
        self.ext = self.tables.ext

    def fold_and_pad(self, features) -> torch.Tensor:
        """(n_sta, n_comp, n_samp) features, host or device, -> padded
        folded (n_sp, ext) f32 on the plan's device."""
        if isinstance(features, torch.Tensor):
            feat = features.to(device=self.device, dtype=torch.float32)
        else:
            feat = torch.from_numpy(
                np.ascontiguousarray(features, np.float32)).to(self.device)
        if feat.shape[-1] != self.n_samp:
            raise ValueError(f"features have {feat.shape[-1]} samples, the "
                             f"plan {self.n_samp}")
        n_sta, n_ph = self.weights_phases.shape[0], self.weights_phases.shape[2]
        buf = torch.zeros((n_sta, n_ph, self.ext), dtype=torch.float32,
                          device=self.device)
        return fold_components(feat, self.weights_phases, out=buf)

    def __call__(self, features):
        return self.call_folded(self.fold_and_pad(features))

    def call_folded(self, g_pad):
        """Run on already folded and padded features (`fold_and_pad`).
        A 'max' problem of more than CHUNK_POINTS beam points runs through
        `call_folded_chunked`, which gives the single call's bits."""
        total = self.n_src * self.n_samp
        if self.reduce == "max" and total > self.CHUNK_POINTS:
            n_chunks = min(-(-total // self.CHUNK_POINTS), self.n_t_blocks)
            return self.call_folded_chunked(g_pad, n_chunks)
        out = bp_beam(g_pad, self.tables, reduce=self.reduce)
        if self.reduce == "max":
            return out[0][: self.n_samp], out[1][: self.n_samp]
        return out

    def call_folded_chunked(self, g_pad, n_chunks: int):
        """The 'max' scan in `n_chunks` calls over consecutive time tiles;
        each call masks at absolute samples, so the result is the single
        call's, bit for bit."""
        if self.reduce != "max":
            raise ValueError("the chunked call is for reduce='max'")
        per = -(-self.n_t_blocks // int(n_chunks))
        vals, idxs = [], []
        for c in range(0, self.n_t_blocks, per):
            v, i = bp_beam(g_pad, self.tables, reduce="max", tile0=c,
                           n_tt=min(per, self.n_t_blocks - c))
            vals.append(v)
            idxs.append(i)
        return (torch.cat(vals)[: self.n_samp],
                torch.cat(idxs)[: self.n_samp])


def beamform(features, moveouts, weights_phases, weights_sources,
             reduce: str = "max", out_of_bounds: str = "strict",
             precision: str = "highest", device=None):
    """Beamform features over a source grid through a one-off plan, on
    `device`.  Same semantics as `ops.reference.beamform`; moveouts must
    be >= 0.  reduce='max' -> (maxbeam (n_samp,), sources (n_samp,) int32);
    'none' -> beam (n_src, n_samp)."""
    n_samp = np.shape(features)[-1]
    plan = BeamformPlan(moveouts, weights_phases, weights_sources, n_samp,
                        reduce=reduce, out_of_bounds=out_of_bounds,
                        precision=precision, device=device)
    return plan(features)
