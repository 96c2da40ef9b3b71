"""Fused normalized matched filter on the card.

Counterpart of `seismic_bpmf_tpu/ops/pallas_mf.py`.  Same semantics as
`ops.reference.matched_filter(network_sum=True)`: per template, the
weight-summed Pearson CC of every channel's demeaned template against the
data window that starts at ``lag + moveout``; zero-variance windows
(variance <= 1e-10) and windows that leave the data give 0.

The CUDA kernels read each template channel at its moveout as a pointer
offset, so the plan keeps the demeaned, weight-over-norm scaled template
rows as they are, plus a per-(channel, template) moveout table.  There are
two kernels, one per arithmetic:

  `mf_cc` (`csrc/mf.cu`): f32 multiply-adds; the rungs 'highest' and
  'default' (and the 'screen' scan, which runs 'default' on a bf16-rounded
  day).  `matched_filter_plain` is the same function in plain PyTorch.

  `mf_cc_split` (`csrc/mf_split.cu`): the rung 'high'.  Every product
  operand is split in two bf16 parts (`split_bf16`) and the three products
  fh*dh + fh*dl + fl*dh run on the tensor cores with f32 accumulation; the
  window normalization comes from the unsplit f32 data.
  `matched_filter_split_plain` is the same function in plain PyTorch.

A wrapper uses its plain version only for tensors on the CPU.

Padded data layout: ``(n_ch, pad_left + n_samp)`` f32, the day at column
``pad_left``, so every moveout (shifted by ``pad_left``) is >= 0.  A
window that would read past the right end is masked, and the kernel reads
zeros there.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._device import resolve_device

LAG_TILE = 512       # lags per kernel block (MF_T in csrc/mf.cu)
TEMPLATE_TILE = 32   # templates per kernel block (MF_TP, MFS_TP)
SPLIT_LAG_TILE = 512  # lags per block of the split kernel (MFS_T)
SPLIT_ROW_FRONT = 8  # zeros in front of a staged split row (MFS_FRONT)
TAP_MULTIPLE = 16    # template rows are zero-padded to a multiple (MF_R)
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on sm_90

_BOUND: set = set()


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _smem_bytes(L_pad: int, max_delta: int) -> int:
    """Mirror of `mf_smem_bytes` in csrc/mf.cu."""
    n_y = LAG_TILE + max_delta
    span = n_y + L_pad
    return 4 * (TEMPLATE_TILE * L_pad + TEMPLATE_TILE + n_y
                + span + (span >> 5) + 1 + 2 * (n_y + L_pad))


def _split_smem_bytes(L: int, L_pad: int, max_delta: int) -> int:
    """Mirror of `mf_split_smem_bytes` in csrc/mf_split.cu."""
    K = _round_up(L + 7, 16)
    KP = K + SPLIT_ROW_FRONT
    n_y = SPLIT_LAG_TILE + max_delta
    span2 = (n_y + K + 3) & ~1
    n_sum = n_y + L_pad
    n_w = span2 // 2
    skw = n_w + 8 * (n_w >> 4) + 8    # words of one skewed bf16 span
    return (2 * (2 * TEMPLATE_TILE * 2 * KP)
            + 4 * (TEMPLATE_TILE + n_y + span2 + 2 * n_sum)
            + 16 * skw)


def _lib_split():
    from .. import _build

    lib = _build.load("mf_split")
    if "mf_split" not in _BOUND:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mf_split_launch.argtypes = [vp, i64, vp, vp, vp, vp, i32, i32,
                                        i32, i32, i32, i64, i64, i64, i32,
                                        vp]
        lib.mf_split_launch.restype = i32
        lib.mf_split_smem_bytes.argtypes = [i32, i32, i32]
        lib.mf_split_smem_bytes.restype = i64
        lib.mf_split_error_string.argtypes = [i32]
        lib.mf_split_error_string.restype = ctypes.c_char_p
        for fn in (lib.mf_split_tile_lags, lib.mf_split_tile_templates):
            fn.argtypes, fn.restype = [], i32
        if (lib.mf_split_tile_lags() != SPLIT_LAG_TILE
                or lib.mf_split_tile_templates() != TEMPLATE_TILE
                or lib.mf_split_smem_bytes(200, 208, 450)
                != _split_smem_bytes(200, 208, 450)):
            raise RuntimeError("csrc/mf_split.cu and ops/mf.py disagree on "
                               "the kernel's tile sizes")
        _BOUND.add("mf_split")
    return lib


def _lib():
    from .. import _build

    lib = _build.load("mf")
    if "mf" not in _BOUND:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mf_launch.argtypes = [vp, i64, vp, vp, vp, vp, i32, i32, i32,
                                  i32, i32, i64, i64, i64, i32, vp]
        lib.mf_launch.restype = i32
        lib.mf_smem_bytes.argtypes = [i32, i32]
        lib.mf_smem_bytes.restype = i64
        lib.mf_error_string.argtypes = [i32]
        lib.mf_error_string.restype = ctypes.c_char_p
        for fn in (lib.mf_tile_lags, lib.mf_tile_templates):
            fn.argtypes, fn.restype = [], i32
        if (lib.mf_tile_lags() != LAG_TILE
                or lib.mf_tile_templates() != TEMPLATE_TILE
                or lib.mf_smem_bytes(TAP_MULTIPLE, 0)
                != _smem_bytes(TAP_MULTIPLE, 0)):
            raise RuntimeError("csrc/mf.cu and ops/mf.py disagree on the "
                               "kernel's tile sizes")
        _BOUND.add("mf")
    return lib


def _window_rsqrt_var(row: torch.Tensor, L: int,
                      lag_block: int) -> torch.Tensor:
    """y[p] = rsqrt of the L-sample window's f32 variance sum at p, 0 where
    it is <= 1e-10, for every window start of one padded channel."""
    windows = row.unfold(0, L, 1)  # (n_pos, L) view
    n_pos = windows.shape[0]
    inv_l = 1.0 / L
    y = torch.empty(n_pos, dtype=torch.float32, device=row.device)
    for s in range(0, n_pos, lag_block):
        w = windows[s : s + lag_block]
        r1 = w.sum(-1)
        r2 = (w * w).sum(-1)
        var = r2 - r1 * r1 * inv_l
        y[s : s + lag_block] = torch.where(
            var > 1e-10, torch.rsqrt(var.abs() + 1e-30),
            torch.zeros_like(var),
        )
    return y


def _check_plan_tensors(data_pad, named) -> None:
    for name, t, dtype in named:
        if t.device != data_pad.device:
            raise ValueError(f"{name} is on {t.device}, data on "
                             f"{data_pad.device}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}")


def _plain_scan(data_pad, mv_table, channel_corr, *, n_tp: int, L: int,
                n_corr: int, lo_p: int, hi_p: int,
                lag_block: int) -> torch.Tensor:
    """The scan both plain versions share.  ``channel_corr(c, act)``
    returns, for channel c and its active templates, a function from
    clamped window positions (n_act, nb) to the raw correlations there;
    this loop normalizes by y, masks and sums over channels.  Chunked over
    `lag_block` lags: one unfolded day would not fit in memory."""
    n_ch, ext = data_pad.shape
    dev = data_pad.device
    out = torch.zeros((n_tp, max(int(n_corr), 0)), dtype=torch.float32,
                      device=dev)
    n_pos = ext - L + 1
    if n_pos <= 0 or n_corr <= 0:
        return out
    for c in range(n_ch):
        mv = mv_table[c, :n_tp].long()
        act = torch.nonzero(mv >= 0).flatten()
        if act.numel() == 0:
            continue
        y = _window_rsqrt_var(data_pad[c], L, lag_block)
        corr_at = channel_corr(c, act)
        mva = mv[act]
        for b0 in range(0, n_corr, lag_block):
            b = torch.arange(b0, min(b0 + lag_block, n_corr), device=dev)
            p = b[None, :] + mva[:, None]       # (n_act, nb) positions
            ok = (p >= lo_p) & (p <= hi_p)
            pc = p.clamp(0, n_pos - 1)
            corr = corr_at(pc)
            val = torch.where(ok, corr * y[pc], torch.zeros_like(corr))
            out[act, b0 : b0 + b.numel()] += val
    return out


def matched_filter_plain(data_pad, filt, mv_table, *, n_tp: int, L: int,
                         n_corr: int, lo_p: int, hi_p: int,
                         lag_block: int = 4096) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the tensors' device.

    data_pad (n_ch, ext) f32; filt (n_ch, n_tp_pad, L_pad) f32 scaled
    template rows; mv_table (n_ch, n_tp_pad) int32 padded moveouts, -1 for
    a channel that adds nothing.  Its matrix products run in f32 (needs
    ``torch.backends.cuda.matmul.allow_tf32`` False, the default)."""
    matched_filter_plain.calls += 1

    def channel_corr(c, act):
        windows = data_pad[c].unfold(0, L, 1)  # (n_pos, L) view
        f = filt[c, act, :L, None]             # (n_act, L, 1)
        return lambda pc: torch.matmul(windows[pc], f)[..., 0]

    return _plain_scan(data_pad, mv_table, channel_corr, n_tp=n_tp, L=L,
                       n_corr=n_corr, lo_p=lo_p, hi_p=hi_p,
                       lag_block=lag_block)


matched_filter_plain.calls = 0


def mf_cc(data_pad, filt, mv_table, tile_lo, *, n_tp: int, L: int,
          n_corr: int, lo_p: int, hi_p: int, max_delta: int,
          lag_block: int = 4096) -> torch.Tensor:
    """(n_tp, n_corr) f32 network CC of a plan's tensors on padded data.

    On CPU tensors this is `matched_filter_plain`; on CUDA tensors it
    launches the kernel of csrc/mf.cu or raises."""
    if data_pad.device.type == "cpu":
        return matched_filter_plain(data_pad, filt, mv_table, n_tp=n_tp,
                                    L=L, n_corr=n_corr, lo_p=lo_p,
                                    hi_p=hi_p, lag_block=lag_block)
    if data_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {data_pad.device}")
    n_ch, ext = data_pad.shape
    n_tp_pad, L_pad = filt.shape[1], filt.shape[2]
    _check_plan_tensors(data_pad, (("data_pad", data_pad, torch.float32),
                                   ("filt", filt, torch.float32),
                                   ("mv_table", mv_table, torch.int32),
                                   ("tile_lo", tile_lo, torch.int32)))
    if (filt.shape[0] != n_ch or tuple(mv_table.shape) != (n_ch, n_tp_pad)
            or n_tp_pad % TEMPLATE_TILE or L_pad % TAP_MULTIPLE
            or L_pad < L or n_tp > n_tp_pad
            or tuple(tile_lo.shape) != (n_ch, n_tp_pad // TEMPLATE_TILE)):
        raise ValueError("inconsistent matched-filter plan shapes")
    if _smem_bytes(L_pad, max_delta) > SMEM_LIMIT:
        raise ValueError("moveout span too wide for one kernel tile")
    out = torch.empty((n_tp, max(int(n_corr), 0)), dtype=torch.float32,
                      device=data_pad.device)
    if n_corr <= 0:
        return out
    lib = _lib()
    with torch.cuda.device(data_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mf_launch(
            data_pad.data_ptr(), ext, filt.data_ptr(), mv_table.data_ptr(),
            tile_lo.data_ptr(), out.data_ptr(), n_ch, n_tp, n_tp_pad, L,
            L_pad, int(n_corr), int(lo_p), int(hi_p), int(max_delta),
            stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"mf kernel launch failed: {lib.mf_error_string(rc).decode()}"
        )
    mf_cc.launches += 1
    return out


mf_cc.launches = 0


def split_bf16(x: torch.Tensor) -> tuple:
    """f32 tensor -> (hi, lo) bf16 pair: hi is the round-to-nearest-even
    bf16 of x, lo the bf16 of the f32 residual x - hi, so
    |x - hi - lo| <= 2^-17 |x|.  Finite inputs only."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def stage_split_rows(filt_hi: torch.Tensor, filt_lo: torch.Tensor,
                     L: int) -> torch.Tensor:
    """The split kernel's template rows as it stages them in shared
    memory: (n_ch, n_tiles, 2, TEMPLATE_TILE, 2, KP) bf16 with KP =
    round_up(L + 7, 16) + 8.  Axis 2 is (hi, lo); axis 4 is the row as it is
    (8 zeros, the taps, zeros) and the same row shifted left by one
    element, so that a pair of taps starting at an odd index is an aligned
    32-bit word of the second copy.  One (channel, tile) block is one
    contiguous copy into the kernel's shared memory."""
    n_ch, n_tp_pad, L_pad = filt_hi.shape
    KP = _round_up(L + 7, 16) + SPLIT_ROW_FRONT
    n_tiles = n_tp_pad // TEMPLATE_TILE
    rows = torch.zeros((n_ch, n_tiles, 2, TEMPLATE_TILE, 2, KP),
                       dtype=torch.bfloat16, device=filt_hi.device)
    for part, f in enumerate((filt_hi, filt_lo)):
        f4 = f.reshape(n_ch, n_tiles, TEMPLATE_TILE, L_pad)
        a = SPLIT_ROW_FRONT
        rows[:, :, part, :, 0, a : a + L_pad] = f4
        rows[:, :, part, :, 1, a - 1 : a - 1 + L_pad] = f4
    return rows


def split_rows_parts(filt_rows: torch.Tensor, L: int) -> tuple:
    """(filt_hi, filt_lo), each (n_ch, n_tp_pad, L) bf16, read back out of
    staged rows (views, nothing is copied)."""
    n_ch, n_tiles = filt_rows.shape[:2]
    a = SPLIT_ROW_FRONT
    return tuple(filt_rows[:, :, part, :, 0, a : a + L].reshape(
        n_ch, n_tiles * TEMPLATE_TILE, L) for part in (0, 1))


def matched_filter_split_plain(data_pad, filt_hi, filt_lo, mv_table, *,
                               n_tp: int, L: int, n_corr: int, lo_p: int,
                               hi_p: int,
                               lag_block: int = 4096) -> torch.Tensor:
    """Plain PyTorch version of the split kernel, on the tensors' device.

    data_pad (n_ch, ext) f32; filt_hi, filt_lo (n_ch, n_tp_pad, >= L)
    bf16, the two parts of the scaled template rows; mv_table as for
    `matched_filter_plain`.  The day is split as the kernel splits it
    (`split_bf16`), the three products fh*dh + (fh*dl + fl*dh) are f32
    matrix products of bf16-valued operands (each product is exact in f32;
    needs ``torch.backends.cuda.matmul.allow_tf32`` False, the default),
    and the normalization y comes from the unsplit f32 day."""
    matched_filter_split_plain.calls += 1

    def channel_corr(c, act):
        d_hi, d_lo = split_bf16(data_pad[c])
        w_hi = d_hi.to(torch.float32).unfold(0, L, 1)
        w_lo = d_lo.to(torch.float32).unfold(0, L, 1)
        f_hi = filt_hi[c, act, :L, None].to(torch.float32)
        f_lo = filt_lo[c, act, :L, None].to(torch.float32)

        def corr_at(pc):
            wh, wl = w_hi[pc], w_lo[pc]
            return (torch.matmul(wh, f_hi)
                    + (torch.matmul(wl, f_hi) + torch.matmul(wh, f_lo))
                    )[..., 0]

        return corr_at

    return _plain_scan(data_pad, mv_table, channel_corr, n_tp=n_tp, L=L,
                       n_corr=n_corr, lo_p=lo_p, hi_p=hi_p,
                       lag_block=lag_block)


matched_filter_split_plain.calls = 0


def mf_cc_split(data_pad, filt_rows, mv_table, tile_lo, *, n_tp: int,
                L: int, n_corr: int, lo_p: int, hi_p: int, max_delta: int,
                lag_block: int = 4096) -> torch.Tensor:
    """(n_tp, n_corr) f32 network CC of a 'high' plan's tensors on padded
    data, every product split in bf16 parts.  `filt_rows` are the rows'
    two bf16 parts as `stage_split_rows` lays them out.

    On CPU tensors this is `matched_filter_split_plain`; on CUDA tensors
    it launches the kernel of csrc/mf_split.cu or raises."""
    if data_pad.device.type == "cpu":
        filt_hi, filt_lo = split_rows_parts(filt_rows, L)
        return matched_filter_split_plain(
            data_pad, filt_hi, filt_lo, mv_table, n_tp=n_tp, L=L,
            n_corr=n_corr, lo_p=lo_p, hi_p=hi_p, lag_block=lag_block)
    if data_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {data_pad.device}")
    n_ch, ext = data_pad.shape
    _check_plan_tensors(
        data_pad, (("data_pad", data_pad, torch.float32),
                   ("filt_rows", filt_rows, torch.bfloat16),
                   ("mv_table", mv_table, torch.int32),
                   ("tile_lo", tile_lo, torch.int32)))
    n_tp_pad = mv_table.shape[1]
    L_pad = _round_up(L, TAP_MULTIPLE)
    if (tuple(filt_rows.shape) != (
            n_ch, n_tp_pad // TEMPLATE_TILE, 2, TEMPLATE_TILE, 2,
            _round_up(L + 7, 16) + SPLIT_ROW_FRONT)
            or mv_table.shape[0] != n_ch or n_tp_pad % TEMPLATE_TILE
            or n_tp > n_tp_pad
            or tuple(tile_lo.shape) != (n_ch, n_tp_pad // TEMPLATE_TILE)):
        raise ValueError("inconsistent matched-filter plan shapes")
    if _split_smem_bytes(L, L_pad, max_delta) > SMEM_LIMIT:
        raise ValueError("moveout span too wide for one kernel tile")
    out = torch.empty((n_tp, max(int(n_corr), 0)), dtype=torch.float32,
                      device=data_pad.device)
    if n_corr <= 0:
        return out
    lib = _lib_split()
    with torch.cuda.device(data_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mf_split_launch(
            data_pad.data_ptr(), ext, filt_rows.data_ptr(),
            mv_table.data_ptr(), tile_lo.data_ptr(),
            out.data_ptr(), n_ch, n_tp, n_tp_pad, L, L_pad, int(n_corr),
            int(lo_p), int(hi_p), int(max_delta), stream,
        )
    if rc != 0:
        raise RuntimeError(
            "mf_split kernel launch failed: "
            f"{lib.mf_split_error_string(rc).decode()}"
        )
    mf_cc_split.launches += 1
    return out


mf_cc_split.launches = 0


def pad_day_data(data, n_ch: int, n_samp: int, pad_left: int, ext: int,
                 dtype: str = "float32", device=None) -> torch.Tensor:
    """Host data (n_sta, n_comp, n_samp) -> padded (n_ch, ext) f32 layout
    on `device`.

    ``dtype='bfloat16'`` rounds the day to bf16 on the host (torch's
    round-to-nearest-even), ships 2-byte samples and casts back to f32 on
    the device: the `screen` upload, whose detection decisions are re-taken
    on exact host CC."""
    dev = resolve_device(device)
    arr = np.ascontiguousarray(
        np.asarray(data, np.float32).reshape(n_ch, n_samp)
    )
    host = torch.from_numpy(arr)
    if dtype == "bfloat16":
        host = host.to(torch.bfloat16)
    elif dtype != "float32":
        raise ValueError(f"unknown upload dtype {dtype!r}")
    src = host.to(dev)
    out = torch.zeros((n_ch, int(ext)), dtype=torch.float32, device=dev)
    hi_clip = min(int(ext), pad_left + n_samp)
    out[:, pad_left:hi_clip] = src[:, : hi_clip - pad_left]
    return out


class MatchedFilterPlan:
    """Device-resident plan: template rows, moveout table and tile bounds
    built and moved to the device once, then applied to any number of
    padded days.

    `precision` keeps the JAX package's rung names.  'highest' and
    'default' run the f32 kernel (`mf_cc`).  'high' runs the split kernel
    (`mf_cc_split`): the plan splits the rows in two bf16 parts once
    (`split_bf16`) and keeps them laid out as the kernel stages them
    (`filt_rows`, `stage_split_rows`; `split_rows_parts` reads the parts
    back), and the kernel splits each day.  `lag_block` is the plain
    versions' lag chunk."""

    def __init__(self, templates, moveouts, weights, n_samp: int,
                 lag_block: int = 4096, precision: str = "highest",
                 pad_left: int = None, max_moveout: int = None,
                 device=None):
        templates = np.asarray(templates, np.float32)
        moveouts = np.asarray(moveouts, np.int64)
        weights = np.asarray(weights, np.float32)
        if precision not in ("highest", "high", "default"):
            raise ValueError(f"unknown precision {precision!r}")
        self.device = resolve_device(device)
        self.precision_name = precision
        n_tp, n_sta, n_comp, L = templates.shape
        n_ch = n_sta * n_comp
        self.n_tp, self.n_ch, self.L = n_tp, n_ch, L
        self.n_samp = int(n_samp)
        self.lag_block = int(lag_block)
        self.n_corr_unit = self.n_samp - L + 1

        mv_flat = moveouts.reshape(n_tp, n_ch)
        # pad_left / max_moveout overrides let several template-chunk plans
        # share ONE padded data layout (pad + upload the day once)
        if pad_left is None:
            pad_left = -int(min(0, mv_flat.min(initial=0)))
        self.pad_left = int(pad_left)
        mv_flat = mv_flat + self.pad_left
        max_mv = (int(max_moveout) + self.pad_left
                  if max_moveout is not None
                  else int(mv_flat.max(initial=0)))
        if int(mv_flat.max(initial=0)) > max_mv:
            raise ValueError(
                f"max_moveout override {max_mv - self.pad_left} is smaller "
                f"than the bank's actual max moveout "
                f"{int(mv_flat.max(initial=0)) - self.pad_left}"
            )
        if int(mv_flat.min(initial=0)) < 0:
            raise ValueError(
                f"pad_left override {self.pad_left} does not cover the "
                f"bank's most-negative moveout "
                f"{int(mv_flat.min(initial=0)) - self.pad_left}"
            )

        tp_flat = templates.reshape(n_tp, n_ch, L)
        tp_dm = tp_flat - tp_flat.mean(axis=-1, keepdims=True)
        x_norm = np.sqrt((tp_dm.astype(np.float64) ** 2).sum(-1)).astype(
            np.float32
        )
        w_flat = weights.reshape(n_tp, n_ch)
        # a zero weight or a zero-norm template channel adds nothing
        scale = np.where(x_norm > 0, w_flat / np.maximum(x_norm, 1e-30), 0.0)
        active = scale > 0

        self.L_pad = L_pad = _round_up(L, TAP_MULTIPLE)
        self.n_tp_pad = n_tp_pad = _round_up(max(n_tp, 1), TEMPLATE_TILE)
        filt = np.zeros((n_ch, n_tp_pad, L_pad), np.float32)
        filt[:, :n_tp, :L] = np.transpose(
            (tp_dm * scale[:, :, None]).astype(np.float32), (1, 0, 2)
        )
        mv_t = np.full((n_ch, n_tp_pad), -1, np.int32)
        mv_t[:, :n_tp] = np.where(active, mv_flat, -1).T
        # per-(channel, template tile) lowest moveout: the tile's data span
        # starts there; -1 marks a tile with no template on the channel
        tiles = mv_t.reshape(n_ch, -1, TEMPLATE_TILE)
        used = tiles >= 0
        big = np.iinfo(np.int32).max
        t_lo = np.where(used, tiles, big).min(-1)
        t_hi = np.where(used, tiles, -1).max(-1)
        any_used = used.any(-1)
        self.max_delta = int((t_hi - t_lo)[any_used].max(initial=0))
        smem = (_split_smem_bytes(L, L_pad, self.max_delta)
                if precision == "high"
                else _smem_bytes(L_pad, self.max_delta))
        if smem > SMEM_LIMIT:
            raise ValueError(
                f"moveout span {self.max_delta} samples within a "
                f"{TEMPLATE_TILE}-template tile does not fit one kernel "
                f"block's shared memory"
            )
        tile_lo = np.where(any_used, t_lo, -1).astype(np.int32)

        self.lo_p = self.pad_left
        self.hi_p = self.pad_left + self.n_samp - L
        if precision == "high":
            self.filt_rows = stage_split_rows(
                *(t.to(self.device)
                  for t in split_bf16(torch.from_numpy(filt))), L)
        else:
            self.filt = torch.from_numpy(filt).to(self.device)
        self.mv_table = torch.from_numpy(mv_t).to(self.device)
        self.tile_lo = torch.from_numpy(
            np.ascontiguousarray(tile_lo)).to(self.device)

    @property
    def ext(self) -> int:
        return self.pad_left + self.n_samp

    @classmethod
    def data_layout(cls, n_samp: int, L: int, pad_left: int,
                    max_moveout: int, lag_block: int = 4096) -> tuple:
        """(pad_left, ext) of the padded layout a plan built with the same
        arguments consumes: lets a prefetch thread pad and upload a day
        before any plan exists."""
        return int(pad_left), int(pad_left) + int(n_samp)

    def pad_data(self, data, dtype: str = "float32") -> torch.Tensor:
        return pad_day_data(data, self.n_ch, self.n_samp, self.pad_left,
                            self.ext, dtype=dtype, device=self.device)

    def __call__(self, data_pad: torch.Tensor) -> torch.Tensor:
        """Padded device data -> (n_tp, n_corr) device CC."""
        if data_pad.device != self.mv_table.device:
            raise ValueError(f"data on {data_pad.device}, plan on "
                             f"{self.mv_table.device}")
        if tuple(data_pad.shape) != (self.n_ch, self.ext):
            raise ValueError(f"padded data has shape "
                             f"{tuple(data_pad.shape)}, the plan's layout "
                             f"is {(self.n_ch, self.ext)}")
        kw = dict(n_tp=self.n_tp, L=self.L, n_corr=self.n_corr_unit,
                  lo_p=self.lo_p, hi_p=self.hi_p, max_delta=self.max_delta,
                  lag_block=self.lag_block)
        if self.precision_name == "high":
            return mf_cc_split(data_pad, self.filt_rows, self.mv_table,
                               self.tile_lo, **kw)
        return mf_cc(data_pad, self.filt, self.mv_table, self.tile_lo, **kw)


def matched_filter(templates, moveouts, weights, data, step: int = 1,
                   lag_block: int = 4096, template_chunk: int = 256,
                   precision: str = "highest", device=None) -> torch.Tensor:
    """Network-summed normalized CC, (n_tp, (n_samp - L) // step + 1), on
    `device`.  Same semantics as
    `ops.reference.matched_filter(network_sum=True)`."""
    dev = resolve_device(device)
    templates = np.asarray(templates, np.float32)
    moveouts = np.asarray(moveouts, np.int64)
    weights = np.asarray(weights, np.float32)
    data = np.asarray(data, np.float32)
    n_tp = templates.shape[0]
    n_samp = data.shape[-1]
    outs = []
    for i in range(0, n_tp, template_chunk):
        plan = MatchedFilterPlan(
            templates[i : i + template_chunk],
            moveouts[i : i + template_chunk],
            weights[i : i + template_chunk],
            n_samp, lag_block=lag_block, precision=precision, device=dev,
        )
        outs.append(plan(plan.pad_data(data)))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
    if step > 1:
        L = templates.shape[-1]
        out = out[:, ::step][:, : (n_samp - L) // step + 1]
    return out
