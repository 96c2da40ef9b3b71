"""Shift-and-stack beamforming (backprojection) on the card.

Counterpart of `seismic_bpmf_tpu/ops/pallas_bp.py`.  Same semantics as
`ops.reference.beamform`:

    beam[i, t] = sum_sp w[i, sp] * g[sp, t + mv[i, sp]]

on the component-folded features g, with the 'strict' policy zeroing the
beam wherever a used station-phase points outside the day and
``reduce='max'`` keeping, per sample, the largest beam and the smallest
source index that reaches it.

The CUDA kernel (`csrc/bp.cu`, wrapped by `bp_beam`) reads a moveout as an
address offset into a shared-memory time tile.  A lane owns `LANE_COLS`
neighbouring samples and a warp two neighbouring sources, and a window of
a staged row, once in a lane's registers, serves both sources where their
moveouts on that row lie less than `WIN_D` apart.  So the plan keeps, per
tile of `SRC_TILE` sources, the rows to stage (a station-phase, or a part
of one whose moveouts spread wide, each with its lowest used moveout and
spread), cut into stages that fit one slot of the kernel's staging ring,
and per stage a program: for each warp its items (which row, where the
window starts in it, how far apart the two sources are, their weights).
`beamform_plain` is the same function in plain PyTorch, a gather per
station-phase; `bp_beam` uses it only for tensors on the CPU.

Padded feature layout: ``(n_sp, n_t_blocks * TIME_TILE + M)`` f32, the day
at column 0 and zeros after it, M > the largest moveout.  A call over a
range of time tiles may take only the columns those tiles read, starting
at an absolute sample `origin` (a time shard on a mesh,
`parallel.sharded`); the mask stays absolute.  Moveouts must be >= 0
(BPMF moveouts are relative to the first arrival).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from .beamform import _flatten_moveouts, fold_components

# the kernel's compile-time sizes (csrc/bp.cu), checked at first load
LANE_COLS = 15       # samples per lane (BP_R, odd)
GROUP = 2            # sources per warp: a pair
WARPS = 15           # computing warps of a block (BP_WARPS)
WIN_D = 8            # a pair's moveouts on a row lie less apart (BP_D)
RING = 3             # slots of the staging ring (BP_NSTAGE)
TIME_TILE = 32 * LANE_COLS   # samples per kernel block (BP_T)
SRC_TILE = WARPS * GROUP     # sources per source tile (BP_S)
ROW_CAP = 2048       # a staged row's used moveouts spread over less
SMEM_LIMIT = 232448       # dynamic shared memory one block may use on sm_90
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
                                  + [i32, i32, i32, i64, i64, i64, i64, i64,
                                     i32, i32, i32, i32, i32] + [vp] * 5)
        lib.bp_launch.restype = i32
        lib.bp_smem_bytes.argtypes = [i32, i32, i32]
        lib.bp_smem_bytes.restype = i64
        lib.bp_error_string.argtypes = [i32]
        lib.bp_error_string.restype = ctypes.c_char_p
        sizes = (lib.bp_tile_samples, lib.bp_tile_sources, lib.bp_window,
                 lib.bp_ring)
        for fn in sizes:
            fn.argtypes, fn.restype = [], i32
        if (tuple(fn() for fn in sizes)
                != (TIME_TILE, SRC_TILE, WIN_D, RING)
                or lib.bp_smem_bytes(TIME_TILE, 1, 64)
                != _smem_bytes(TIME_TILE, 1, 64)):
            raise RuntimeError("csrc/bp.cu and ops/bp.py disagree on the "
                               "kernel's tile sizes")
        _BOUND.add("bp")
    return lib


def _head_words() -> int:
    """Words of a stage program's head: where each warp's items start
    (WARPS + 1 words), the stage's flags and its source tile, to a
    multiple of 4 (BP_HW)."""
    return (WARPS + 6) & ~3


def _smem_bytes(stride: int, max_rows: int, prog_bytes: int) -> int:
    """Mirror of `bp_smem_bytes` in csrc/bp.cu: the argmax keys, the ring's
    barriers and its RING slots (a stage's program and its rows)."""
    return (8 * TIME_TILE + 16 * RING
            + RING * (prog_bytes + 4 * max_rows * stride))


@dataclass
class BPTables:
    """Device tables of one plan, shared by the kernel and its plain
    version.  Dense (plain version): mv, w (n_sp, n_src); lo, hi: per-source
    used-moveout bounds of the strict policy, `hi_max` the largest.

    Compact (kernel): source tiles of SRC_TILE consecutive sources, each cut
    into one or more stages, the CSR bounds `tile_stage`.  Per stage the CSR
    list `stage_row` of its staged rows, in ascending station-phase order:
    station-phase `ent_sp` (it repeats where a station-phase's used
    moveouts spread over ROW_CAP samples or more: each part is a row),
    `ent_lo` the row's first staged moveout (a multiple of 4) and `ent_span`
    the largest used moveout less `ent_lo` (< ROW_CAP); a row lies at
    `stride` words times its number within the stage.  `stage_prog` are the
    CSR bounds, in units of 4 words, of each stage's program in `prog`:

        head    WARPS + 1 words: where each warp's part starts, in 4-word
                elements after the head; flags (1: the tile's first stage,
                2: its last); the tile; padding to `_head_words()`
        item    (code, row * stride + base, weight bits of the warp's
                first source, of its second).  code = delta + WIN_D - 1:
                both sources use the row, the second's moveout `delta`
                after the first's, |delta| < WIN_D; a lane loads
                LANE_COLS + |delta| words from `base + lane * LANE_COLS`
                on, base being the smaller of the two offsets.  code =
                2 WIN_D - 1 or 2 WIN_D: the first or the second source
                alone.  code = 2 WIN_D + 1 ends a warp's part.

    Warp g takes the tile's sources 2 g and 2 g + 1.  Each used (source,
    station-phase) pair is in one item; a source's items come in ascending
    station-phase order (the sum order)."""

    mv: torch.Tensor
    w: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    tile_stage: torch.Tensor
    stage_row: torch.Tensor
    stage_prog: torch.Tensor
    prog: torch.Tensor
    ent_sp: torch.Tensor
    ent_lo: torch.Tensor
    ent_span: torch.Tensor
    n_samp: int
    n_t_blocks: int
    ext: int
    strict: bool
    hi_max: int
    stride: int
    max_rows: int
    prog_bytes: int
    n_pairs: int
    n_items: int
    window_words: int

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

    def retimed(self, n_samp: int, strict: bool) -> "BPTables":
        """The same tables for another day length or policy: the device
        tensors are shared, only the time layout (n_samp, n_t_blocks, ext)
        and the policy change."""
        n_t_blocks = max(1, math.ceil(n_samp / TIME_TILE))
        return dataclasses.replace(
            self, n_samp=int(n_samp), n_t_blocks=n_t_blocks,
            ext=self.ext + (n_t_blocks - self.n_t_blocks) * TIME_TILE,
            strict=bool(strict))

    @property
    def fma_per_word(self) -> float:
        """Multiply-adds per word a lane loads from a staged row: the
        design's own ratio (1 when every source loads its own samples, 2
        when the two sources of every warp read the same ones)."""
        return self.n_pairs * LANE_COLS / max(1, self.window_words)


def _starts(key: np.ndarray) -> np.ndarray:
    """Boolean mark of each run's first element in a sorted key."""
    first = np.ones(len(key), bool)
    first[1:] = key[1:] != key[:-1]
    return first


def build_tables(mv_flat, w_flat, mv_lo, mv_hi, n_samp: int, strict: bool,
                 device) -> BPTables:
    """Host build of a plan's tables from `_flatten_moveouts` output, in
    numpy sorts and cumulative sums over the used pairs.

    A tile's rows are cut, in ascending station-phase order, into as few
    stages of as even a size as fit one slot of the kernel's staging ring.
    Raises ValueError when a moveout is negative."""
    n_src, n_sp = mv_flat.shape
    if int(mv_flat.min(initial=0)) < 0:
        raise ValueError("moveouts must be non-negative")
    mv = np.ascontiguousarray(mv_flat, np.int32)
    w = np.ascontiguousarray(w_flat, np.float32)
    used = w != 0.0
    n_tiles = max(1, -(-n_src // SRC_TILE))
    head = _head_words()

    # the used pairs, by source then station-phase
    src, sp = np.nonzero(used)
    m = mv[src, sp].astype(np.int64)
    tile = src // SRC_TILE
    grp = (src % SRC_TILE) // GROUP

    # rows: a (tile, station-phase) in parts whose moveouts spread < ROW_CAP
    ts = tile * n_sp + sp
    lo_ts = np.full(n_tiles * n_sp, np.iinfo(np.int64).max)
    np.minimum.at(lo_ts, ts, m)
    part = (m - lo_ts[ts]) // (ROW_CAP - 3)
    n_part = int(part.max(initial=0)) + 1
    ent_key, ent = np.unique(ts * n_part + part, return_inverse=True)
    ent = ent.reshape(-1)
    n_ent = len(ent_key)
    ent_tile = ent_key // (n_sp * n_part)
    ent_sp = (ent_key // n_part) % n_sp
    ent_lo = np.full(n_ent, np.iinfo(np.int64).max)
    np.minimum.at(ent_lo, ent, m)
    ent_lo &= ~3                     # a row's copy starts at 16 bytes
    off = m - ent_lo[ent]
    ent_span = np.zeros(n_ent, np.int64)
    np.maximum.at(ent_span, ent, off)
    stride = _round_up(int(ent_span.max(initial=0)), 4) + TIME_TILE

    # items: a (row, warp) whose two sources both use the row, less than
    # WIN_D apart, is one item; else each source is an item of its own
    key = ent * WARPS + grp
    order = np.argsort(2 * key + src % 2, kind="stable")
    o_key, o_off, o_b = key[order], off[order], (src % 2)[order]
    o_w = w[src[order], sp[order]].view(np.int32).astype(np.int64)
    first = _starts(o_key)
    both = np.zeros(len(order), bool)            # marks a pair's first
    both[:-1] = (first[:-1] & ~first[1:]
                 & (np.abs(o_off[1:] - o_off[:-1]) < WIN_D))
    second = np.concatenate([[False], both[:-1]])
    at_item = np.flatnonzero(~second)            # an item's first source
    n_items = len(at_item)
    paired = both[at_item]
    nxt = np.minimum(at_item + 1, max(0, len(order) - 1))
    delta = np.where(paired, o_off[nxt] - o_off[at_item], 0)
    it_code = np.where(paired, delta + WIN_D - 1,
                       2 * WIN_D - 1 + o_b[at_item])
    it_base = o_off[at_item] + np.minimum(delta, 0)
    it_wa = np.where(o_b[at_item] == 0, o_w[at_item], 0)
    it_wb = np.where(paired, o_w[nxt], np.where(o_b[at_item] == 1,
                                                o_w[at_item], 0))
    it_ent, it_grp = o_key[at_item] // WARPS, o_key[at_item] % WARPS
    window_words = int((LANE_COLS + np.abs(delta)).sum())

    # stages: each tile's rows in ascending station-phase order, cut into
    # n_st even parts that fit a slot with their program; a tile with no
    # used row still has one stage
    rows = np.bincount(ent_tile, minlength=n_tiles)
    ent_first = np.concatenate([[0], np.cumsum(rows)])[:-1]
    k_of = np.arange(n_ent) - ent_first[ent_tile]     # row within its tile
    ent_items = np.bincount(it_ent, minlength=n_ent)
    slot = (SMEM_LIMIT - _smem_bytes(0, 0, 0)) // RING // 16 * 16
    rows_max = max(1, (slot - 4 * head - 16 * (WARPS + 2)) // (4 * stride))
    while True:
        n_st = np.maximum(1, -(-rows // rows_max))
        per = np.maximum(1, -(-rows // n_st))
        tile_stage = np.concatenate([[0], np.cumsum(n_st)])
        n_stages = int(tile_stage[-1])
        stage_of = tile_stage[ent_tile] + k_of // per[ent_tile]
        # a stage's items, an end mark per warp, two elements of padding
        # (the loop loads two elements ahead)
        elems = WARPS + 2 + np.bincount(stage_of, weights=ent_items,
                                        minlength=n_stages).astype(np.int64)
        prog_words = head + 4 * elems
        prog_bytes = 4 * int(prog_words.max())
        fit = (slot - prog_bytes) // (4 * stride)
        if fit >= int(per.max()) or rows_max == 1:
            break
        rows_max = max(1, min(rows_max - 1, fit))
    stage_row = np.concatenate([[0], np.cumsum(np.bincount(
        stage_of, minlength=n_stages))])
    stage_prog = np.concatenate([[0], np.cumsum(prog_words)])

    # the programs: items by stage, warp, row; each warp's part ends with
    # an end mark
    it_stage = stage_of[it_ent]
    it_order = np.argsort((it_stage * WARPS + it_grp) * n_ent + it_ent,
                          kind="stable")
    part_items = np.bincount(it_stage * WARPS + it_grp,
                             minlength=n_stages * WARPS).reshape(
                                 n_stages, WARPS)
    heads = np.zeros((n_stages, head), np.int64)
    heads[:, 1:WARPS + 1] = np.cumsum(part_items + 1, axis=1)
    stage_tile = np.repeat(np.arange(n_tiles), n_st)
    j = np.arange(n_stages)
    heads[:, WARPS + 1] = ((j == tile_stage[stage_tile])
                           + 2 * (j + 1 == tile_stage[stage_tile + 1]))
    heads[:, WARPS + 2] = stage_tile
    prog = np.zeros(int(stage_prog[-1]), np.int32)
    prog[(stage_prog[:-1, None] + np.arange(head)[None, :]).ravel()] = (
        heads.ravel())
    # an item's place: its part's start, then its rank within the part
    part0 = np.concatenate([[0], np.cumsum(part_items.ravel())])[:-1]
    rank = np.empty(n_items, np.int64)
    rank[it_order] = np.arange(n_items) - part0[
        (it_stage * WARPS + it_grp)[it_order]]
    at = (stage_prog[:-1][it_stage] + head
          + 4 * (heads[it_stage, it_grp] + rank))
    prog[at] = it_code
    prog[at + 1] = ((k_of[it_ent] % per[ent_tile[it_ent]]) * stride
                    + it_base)
    prog[at + 2] = it_wa
    prog[at + 3] = it_wb
    end = (stage_prog[:-1, None] + head
           + 4 * (heads[:, 1:WARPS + 1] - 1)).ravel()
    prog[end] = 2 * WIN_D + 1

    max_mv = int(mv_flat.max(initial=0))
    n_t_blocks = max(1, math.ceil(n_samp / TIME_TILE))

    def t(a, dtype=np.int32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return BPTables(
        # (n_sp, n_src): transposed by torch on the device (a 1M-source
        # table is GBs, which numpy transposes slowly)
        mv=t(mv).t().contiguous(), w=t(w, np.float32).t().contiguous(),
        lo=t(mv_lo), hi=t(mv_hi),
        tile_stage=t(tile_stage), stage_row=t(stage_row),
        stage_prog=t(stage_prog // 4), prog=t(prog), ent_sp=t(ent_sp),
        ent_lo=t(ent_lo), ent_span=t(ent_span), n_samp=int(n_samp),
        n_t_blocks=n_t_blocks,
        ext=n_t_blocks * TIME_TILE + _round_up(max_mv + 1, 128),
        strict=bool(strict), hi_max=int(np.max(mv_hi, initial=0)),
        stride=stride,
        max_rows=int(np.diff(stage_row).max(initial=0)),
        prog_bytes=prog_bytes, n_pairs=len(src), n_items=n_items,
        window_words=window_words,
    )


def _range(tab: BPTables, reduce: str, tile0: int, n_tt):
    n_tt = tab.n_t_blocks - tile0 if n_tt is None else int(n_tt)
    if reduce not in ("max", "none"):
        raise ValueError(f"reduce must be 'max' or 'none', got {reduce!r}")
    if tile0 < 0 or n_tt < 1 or tile0 + n_tt > tab.n_t_blocks:
        raise ValueError(f"time tiles [{tile0}, {tile0 + n_tt}) outside "
                         f"[0, {tab.n_t_blocks})")
    return int(tile0), n_tt


def _beam_cols(tab: BPTables, tile0: int, n_tt: int) -> int:
    """Samples of a 'none' call over tiles [tile0, tile0 + n_tt): those
    before the day's end."""
    return min(n_tt * TIME_TILE, tab.n_samp - tile0 * TIME_TILE)


def _check_window(g_pad, tab: BPTables, tile0: int, n_tt: int,
                  origin: int) -> None:
    """The features must hold, from their column 0 at absolute sample
    `origin`, every column the tiles read: up to the tiles' end plus the
    plan's moveout margin (the whole layout `tab.ext` for a day)."""
    need = (tile0 + n_tt) * TIME_TILE + (tab.ext - tab.n_t_blocks
                                         * TIME_TILE)
    if (g_pad.shape[0] != tab.n_sp or origin < 0 or origin % 4
            or origin > tile0 * TIME_TILE
            or origin + g_pad.shape[1] < need or g_pad.shape[1] % 4):
        raise ValueError(
            f"padded features of shape {tuple(g_pad.shape)} from sample "
            f"{origin} do not hold the plan's layout of time tiles "
            f"[{tile0}, {tile0 + n_tt}): ({tab.n_sp}, samples "
            f"[{tile0 * TIME_TILE}, {need})), origin a multiple of 4")


def first_max(vals: torch.Tensor, idxs: torch.Tensor) -> tuple:
    """The first-max rule, along axis 0: the largest value and, among the
    rows that reach it, the smallest index (2**30 marks none).  The plain
    version's source chunks and the cross-shard merge of
    `parallel.sharded` both reduce with it; the kernel keeps the same rule
    in its packed keys (csrc/bp.cu)."""
    v = vals.max(dim=0).values
    # a Python scalar, not a device tensor made from one: that copy would
    # wait for the device, and so serialize the cards of a sharded day
    return v, torch.where(vals == v, idxs, 2**30).min(dim=0).values


def beamform_plain(g_pad, tab: BPTables, *, reduce: str = "max",
                   tile0: int = 0, n_tt=None, origin: int = 0):
    """Plain PyTorch version of the kernel, on the tensors' device.

    reduce='max': (val, idx) of the n_tt * TIME_TILE samples from tile
    `tile0` on; reduce='none': the beam of those samples before the day's
    end, (n_src, n_samp) for the whole day.  `origin` is the absolute
    sample of g_pad's column 0.  A gather per station-phase, summed in f32
    in ascending station-phase order, and a running (max, argmax) over
    chunks of about PLAIN_POINTS beam points in which the first maximum
    wins (`first_max`)."""
    beamform_plain.calls += 1
    tile0, n_tt = _range(tab, reduce, tile0, n_tt)
    dev = g_pad.device
    t_a = tile0 * TIME_TILE
    n_t = (_beam_cols(tab, tile0, n_tt) if reduce == "none"
           else n_tt * TIME_TILE)
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
            rows = windows[t_a - origin + tab.mv[sp, s0 + use].long()]
            beam[use] = beam[use] + tab.w[sp, s0 + use, None] * rows
        if tab.strict:
            ok = ((t_abs[None, :] + tab.lo[s0:s1, None] >= 0)
                  & (t_abs[None, :] + tab.hi[s0:s1, None] < tab.n_samp))
            beam = torch.where(ok, beam, torch.zeros_like(beam))
        if reduce == "none":
            out[s0:s1] = beam
            continue
        ids = torch.arange(s0, s1, dtype=torch.int32, device=dev)
        v, i = first_max(beam, ids[:, None].expand_as(beam))
        # the earlier chunks hold the smaller indices
        best_v, best_i = first_max(torch.stack([best_v, v]),
                                   torch.stack([best_i, i]))
    return out if reduce == "none" else (best_v, best_i)


beamform_plain.calls = 0


def bp_beam(g_pad, tab: BPTables, *, reduce: str = "max", tile0: int = 0,
            n_tt=None, origin: int = 0):
    """The beam of a plan's tables on padded folded features, over the
    time tiles [tile0, tile0 + n_tt) (the whole day by default): (val,
    idx) for reduce='max', the (n_src, samples) beam for 'none'.
    `origin` is the absolute sample of g_pad's column 0: a time shard
    holds only the columns its tiles read (`_check_window`).

    On CPU tensors this is `beamform_plain`; on CUDA tensors it launches
    the kernel of csrc/bp.cu or raises."""
    if g_pad.dtype != torch.float32 or not g_pad.is_contiguous():
        raise ValueError("the padded features must be contiguous float32")
    tile0, n_tt = _range(tab, reduce, tile0, n_tt)
    _check_window(g_pad, tab, tile0, n_tt, int(origin))
    if g_pad.device.type == "cpu":
        return beamform_plain(g_pad, tab, reduce=reduce, tile0=tile0,
                              n_tt=n_tt, origin=origin)
    if g_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {g_pad.device}")
    for name in ("tile_stage", "stage_row", "stage_prog", "prog", "lo", "hi",
                 "ent_sp", "ent_lo", "ent_span"):
        t = getattr(tab, name)
        if t.device != g_pad.device:
            raise ValueError(f"{name} is on {t.device}, features on "
                             f"{g_pad.device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")
    if (tab.n_tiles != max(1, -(-tab.n_src // SRC_TILE))
            or tab.stage_prog.shape[0] != tab.n_stages + 1
            or tab.ent_sp.shape != tab.ent_lo.shape
            or tab.ent_sp.shape != tab.ent_span.shape
            or tab.stride % 4 or tab.prog_bytes % 16
            or _smem_bytes(tab.stride, tab.max_rows, tab.prog_bytes)
            > SMEM_LIMIT):
        raise ValueError("inconsistent beamforming plan tables")
    if g_pad.data_ptr() % 16 or tab.prog.data_ptr() % 16:
        raise ValueError("the kernel copies rows and programs in units of "
                         "16 bytes: the features and `prog` must start at "
                         "a multiple of 16 bytes")
    dev = g_pad.device
    n_splits = min(tab.n_tiles, max(1, -(-TARGET_BLOCKS // n_tt)))
    n_cols = _beam_cols(tab, tile0, n_tt)
    if reduce == "none":
        beam = torch.empty((tab.n_src, n_cols), dtype=torch.float32,
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
            g_pad.data_ptr(), g_pad.shape[1], ptr(tab.tile_stage),
            ptr(tab.stage_row), ptr(tab.stage_prog), ptr(tab.prog),
            ptr(tab.ent_sp), ptr(tab.ent_lo), ptr(tab.ent_span),
            ptr(tab.lo), ptr(tab.hi), tab.n_src, tab.n_tiles, n_splits,
            tile0, n_tt, tab.n_samp, int(origin), n_cols, int(tab.strict),
            tab.hi_max, tab.stride,
            tab.max_rows, tab.prog_bytes, ptr(keys), ptr(val), ptr(idx),
            ptr(beam), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"bp kernel launch failed: {lib.bp_error_string(rc).decode()}"
        )
    bp_beam.launches += 1
    bp_beam.launches_on[dev.index] += 1
    return beam if reduce == "none" else (val, idx)


bp_beam.launches = 0
bp_beam.launches_on = collections.Counter()   # by card index


class BeamformPlan:
    """Device-resident beamforming plan: moveouts and weights moved to the
    device once, then applied to any number of feature sets (e.g.
    consecutive days).  Counterpart of `PallasBeamformPlan`; the TPU's
    blocking knobs and diagnostics have no counterpart (the kernel's tiles
    are fixed in csrc/bp.cu).  `precision` keeps the rung names as error
    classes (every rung runs the f32 kernel).  `tables`, another plan's
    tables of the same moveouts and weights, are reused for this plan's
    day length and policy (`BPTables.retimed`) instead of built anew."""

    # max beam points per kernel call before a 'max' day is cut into
    # calls over consecutive time tiles (`call_folded_chunked`, bit for
    # bit the single call): the JAX package's contract
    CHUNK_POINTS = 2 * 10**10

    def __init__(self, moveouts, weights_phases, weights_sources,
                 n_samp: int, reduce: str = "max",
                 out_of_bounds: str = "strict", precision: str = "highest",
                 device=None, tables: BPTables = None):
        if reduce not in ("max", "none"):
            raise ValueError(f"reduce must be 'max' or 'none', got "
                             f"{reduce!r}")
        if out_of_bounds not in ("strict", "flexible"):
            raise ValueError(f"out_of_bounds must be 'strict' or 'flexible', "
                             f"got {out_of_bounds!r}")
        self.mode = _precision_mode(precision)
        self.device = resolve_device(device)
        if tables is not None:
            self.tables = tables.retimed(n_samp, out_of_bounds == "strict")
        else:
            self.tables = build_tables(
                *_flatten_moveouts(moveouts, weights_phases,
                                   weights_sources),
                n_samp, out_of_bounds == "strict", self.device)
        self.weights_phases = torch.from_numpy(
            np.ascontiguousarray(weights_phases, np.float32)).to(self.device)
        self.n_samp = int(n_samp)
        self.reduce = reduce
        self.strict = out_of_bounds == "strict"
        self.n_src, self.n_sp = self.tables.n_src, self.tables.n_sp
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
