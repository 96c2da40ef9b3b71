"""Fused normalized matched filter on the card.

Counterpart of `seismic_bpmf_tpu/ops/pallas_mf.py`.  Same semantics as
`ops.reference.matched_filter(network_sum=True)`: per template, the
weight-summed Pearson CC of every channel's demeaned template against the
data window that starts at ``lag + moveout``; zero-variance windows
(variance <= 1e-10) and windows that leave the data give 0.

The CUDA kernels read each template channel at its moveout as a pointer
offset, so the plan keeps the demeaned, weight-over-norm scaled template
rows as they are, plus a per-(channel, template) moveout table.  The
kernels split every product operand in two parts and run the products of
the parts on the tensor cores with f32 accumulation; the window
normalization comes from the unsplit f32 data.  There is one build per
split and accumulation:

  `mf_cc` (`csrc/mf.cu`): TF32 parts (`split_tf32`, 11 significant bits
  each, f32-class accuracy), the four products (fh*dh + fh*dl) + (fl*dh +
  fl*dl); the rung 'default' (and the 'screen' scan, which runs 'default'
  on a bf16-rounded day).  A pre-pass (`tf32_day`) splits the day and
  computes its window normalization once a call; the main kernel reads
  them through a ring of shared-memory stages into `wgmma`.
  `matched_filter_plain` is the same function in plain PyTorch,
  `tf32_day_plain` the pre-pass's.

  `mf_cc_highest` (`csrc/mf.cu` built with MF_ACC_OUT=1, `HIGHEST_BUILD`):
  the rung 'highest', the same pre-pass, plan tensors, ring and four
  products, but each group of HIGHEST_PARTIAL_STEPS k-steps summed from zero
  on the tensor cores and the partials added in round-to-nearest f32
  outside them (their additions truncate; see csrc/mf.cu).  Its plain
  version is `matched_filter_plain` too.

  `mf_cc_split` (`csrc/mf_split.cu`): bf16 parts (`split_bf16`); the rung
  'high'.  A pre-pass (`split_day`) splits the day and computes its window
  normalization once a call; the main kernel reads them through a ring of
  shared-memory stages.  `matched_filter_split_plain` is the same function
  in plain PyTorch, `split_day_plain` the pre-pass's.

The plan splits the template rows once and lays them out as the kernels
read them (`stage_tf32_rows`, `stage_split_rows`).

A wrapper uses its plain version only for tensors on the CPU.

Padded data layout: ``(n_ch, pad_left + n_samp)`` f32, the day at column
``pad_left``, so every moveout (shifted by ``pad_left``) is >= 0.  A
window that would read past the right end is masked, and the kernel reads
zeros there.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from .._device import resolve_device

LAG_TILE = 2048      # lags per block of csrc/mf.cu (MF_T)
TEMPLATE_TILE = 32   # templates per `tile_lo` entry of every kernel (MF_TILE,
                     # MFS_TILE)
BLOCK_TEMPLATES = 4  # templates per block of csrc/mf.cu (MF_TPB)
TF32_K_STEP = 8      # taps per k-step of csrc/mf.cu: K = round_up(L + 34, 8)
SPLIT_ROW_FRONT = 8  # zeros in front of a plan's TF32 row (MF_GFRONT)
ROW_FRONT = 40       # zeros in front of a row staged by csrc/mf.cu (MF_FRONT)
STAGES = 4           # csrc/mf.cu's deepest ring (MF_STAGES)
HIGHEST_BUILD = ("MF_ACC_OUT=1",)   # the defines of the 'highest' build
HIGHEST_PARTIAL_STEPS = 2    # k-steps a partial of that build (MF_ACC_G)
SPLIT_LAG_TILE = 4096   # lags per block of the split kernel (MFS_T)
SPLIT_BLOCK_TEMPLATES = 4  # templates per block of the split kernel (MFS_TPB)
SPLIT_ROW_OFF = 72   # zeros in front of a staged split row (MFS_OFF)
SPLIT_STAGES = 3     # the split kernel's deepest ring (MFS_STAGES)
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on sm_90

_BOUND: set = set()


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _tf32_row_width(L: int) -> int:
    """Elements of a plan's TF32 row (`mf_grow`): round_up(L + 7, 8) taps'
    room and 8 zeros in front."""
    return _round_up(L + 7, TF32_K_STEP) + SPLIT_ROW_FRONT


def _k_taps(L: int) -> int:
    """Taps of csrc/mf.cu's k-loop (`mf_k`): every shift s < 32 and
    16-byte phase delta < 4 of an L-tap row, in steps of 8."""
    return _round_up(L + 34, TF32_K_STEP)


def _row_width(L: int) -> int:
    """Elements of a template row staged by csrc/mf.cu (`mf_row`):
    ROW_FRONT zeros, then room for K taps."""
    return _k_taps(L) + ROW_FRONT


def _stage_bytes(L: int, max_delta: int) -> int:
    """Bytes of one ring stage of csrc/mf.cu (`mf_layout_n`): the data
    span's hi and lo parts (1 KB aligned each), the block's template rows,
    y with 8 pad words after every 64, the moveouts."""
    span = _round_up(max_delta + 4 + 32 * 63 + _k_taps(L), 32)
    pb = _round_up(4 * span, 1024)
    n_y4 = _round_up(max_delta + 4 + LAG_TILE, 4)
    y_words = n_y4 + 8 * (-(-n_y4 // 64))
    f_bytes = BLOCK_TEMPLATES * 2 * 4 * _row_width(L)
    return _round_up(2 * pb + f_bytes + 4 * y_words + 4 * BLOCK_TEMPLATES,
                     1024)


def stages(L: int, max_delta: int) -> int:
    """Stages of csrc/mf.cu's ring at these sizes: the deepest up to STAGES
    that fits shared memory, else 1 (`mf_layout`)."""
    stage = _stage_bytes(L, max_delta)
    for n in range(STAGES, 1, -1):
        if 1024 + n * (stage + 16) <= SMEM_LIMIT:
            return n
    return 1


def _smem_bytes(L: int, max_delta: int) -> int:
    """Mirror of `mf_smem_bytes` in csrc/mf.cu: the ring at `stages`, its
    1 KB alignment and mbarriers."""
    return 1024 + stages(L, max_delta) * (_stage_bytes(L, max_delta) + 16)


def _split_k(L: int) -> int:
    """Taps of the split kernel's k-loop (`mfs_k`): every shift m < 64 and
    delta < 8 of an L-tap row, in steps of 16."""
    return _round_up(L + 70, 16)


def _split_row_width(L: int) -> int:
    """Elements of a staged split row (`mfs_row`): >= K + 72, and half of
    it 16 mod 32, so the two copies of a row lie 16 banks apart."""
    return _round_up(_split_k(L) + 40, 64) + 32


def _split_stage_bytes(L: int, max_delta: int) -> int:
    """Bytes of one ring stage of csrc/mf_split.cu (`mfs_layout_n`): the
    data span's hi and lo parts (1 KB aligned), the block's template rows,
    y with 8 pad words after every 128, the moveouts."""
    span = _round_up(max_delta + 8 + SPLIT_LAG_TILE - 64 + _split_k(L), 64)
    hb = _round_up(2 * span, 1024)
    n_y4 = _round_up(max_delta + 8 + SPLIT_LAG_TILE, 4)
    y_words = n_y4 + 8 * (-(-n_y4 // 128))
    f_bytes = SPLIT_BLOCK_TEMPLATES * 8 * _split_row_width(L)
    return _round_up(2 * hb + f_bytes + 4 * y_words
                     + 4 * SPLIT_BLOCK_TEMPLATES, 1024)


def split_stages(L: int, max_delta: int) -> int:
    """Stages of the split kernel's ring at these sizes: the deepest up to
    SPLIT_STAGES that fits shared memory, else 1 (`mfs_layout`)."""
    stage = _split_stage_bytes(L, max_delta)
    for n in range(SPLIT_STAGES, 1, -1):
        if 1024 + n * (stage + 16) <= SMEM_LIMIT:
            return n
    return 1


def _split_smem_bytes(L: int, max_delta: int) -> int:
    """Mirror of `mf_split_smem_bytes` in csrc/mf_split.cu: the ring at
    `split_stages`, its 1 KB alignment and mbarriers."""
    n = split_stages(L, max_delta)
    return 1024 + n * (_split_stage_bytes(L, max_delta) + 16)


def _lib_split():
    from .. import _build

    lib = _build.load("mf_split")
    if "mf_split" not in _BOUND:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mf_split_prepass_launch.argtypes = [vp, i64, i64, i32, i32, vp,
                                                vp, vp, vp]
        lib.mf_split_prepass_launch.restype = i32
        lib.mf_split_launch.argtypes = [vp, vp, vp, i64, vp, vp, vp, vp, i32,
                                        i32, i32, i32, i64, i64, i64, i32,
                                        vp]
        lib.mf_split_launch.restype = i32
        lib.mf_split_smem_bytes.argtypes = [i32, i32]
        lib.mf_split_smem_bytes.restype = i64
        lib.mf_split_error_string.argtypes = [i32]
        lib.mf_split_error_string.restype = ctypes.c_char_p
        lib.mf_split_stages.argtypes = [i32, i32]
        lib.mf_split_row_width.argtypes = [i32]
        lib.mf_split_stages.restype = lib.mf_split_row_width.restype = i32
        for fn in (lib.mf_split_tile_lags, lib.mf_split_block_templates):
            fn.argtypes, fn.restype = [], i32
        if (lib.mf_split_tile_lags() != SPLIT_LAG_TILE
                or lib.mf_split_block_templates() != SPLIT_BLOCK_TEMPLATES
                or any(lib.mf_split_row_width(L) != _split_row_width(L)
                       for L in (37, 200))
                or any(lib.mf_split_smem_bytes(L, d) != _split_smem_bytes(L, d)
                       or lib.mf_split_stages(L, d) != split_stages(L, d)
                       for L, d in ((200, 450), (37, 3), (200, 9000)))):
            raise RuntimeError("csrc/mf_split.cu and ops/mf.py disagree on "
                               "the kernel's tile sizes")
        _BOUND.add("mf_split")
    return lib


def _lib(defines=()):
    """The loaded library of csrc/mf.cu's build with -D `defines`: () the
    'default' build, HIGHEST_BUILD the 'highest' one."""
    from .. import _build

    lib = _build.load("mf", defines)
    key = _build.key("mf", defines)
    if key not in _BOUND:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mf_prepass_launch.argtypes = [vp, i64, i64, i32, i32, vp, vp,
                                          vp, vp]
        lib.mf_prepass_launch.restype = i32
        lib.mf_launch.argtypes = [vp, vp, vp, i64, vp, vp, vp, vp, i32, i32,
                                  i32, i32, i64, i64, i64, i32, vp]
        lib.mf_launch.restype = i32
        lib.mf_smem_bytes.argtypes = [i32, i32]
        lib.mf_smem_bytes.restype = i64
        lib.mf_error_string.argtypes = [i32]
        lib.mf_error_string.restype = ctypes.c_char_p
        lib.mf_stages.argtypes = [i32, i32]
        lib.mf_row_width.argtypes = lib.mf_plan_row_width.argtypes = [i32]
        lib.mf_stages.restype = lib.mf_row_width.restype = i32
        lib.mf_plan_row_width.restype = i32
        for fn in (lib.mf_tile_lags, lib.mf_tile_templates,
                   lib.mf_block_templates, lib.mf_partial_steps):
            fn.argtypes, fn.restype = [], i32
        steps = HIGHEST_PARTIAL_STEPS if defines else 0
        if (lib.mf_tile_lags() != LAG_TILE
                or lib.mf_tile_templates() != TEMPLATE_TILE
                or lib.mf_block_templates() != BLOCK_TEMPLATES
                or lib.mf_partial_steps() != steps
                or any(lib.mf_row_width(L) != _row_width(L)
                       or lib.mf_plan_row_width(L) != _tf32_row_width(L)
                       for L in (37, 200))
                or any(lib.mf_smem_bytes(L, d) != _smem_bytes(L, d)
                       or lib.mf_stages(L, d) != stages(L, d)
                       for L, d in ((200, 450), (37, 3), (200, 9000)))):
            raise RuntimeError(f"csrc/mf.cu ({key}) and ops/mf.py disagree "
                               f"on the kernel's tile sizes")
        _BOUND.add(key)
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


def split_tf32(x: torch.Tensor) -> tuple:
    """f32 tensor -> (hi, lo) f32 tensors of TF32 values: hi is x rounded to
    TF32 as ``cvt.rna.tf32.f32`` rounds (to nearest, ties away from zero:
    add 0x1000 to the bits, clear the low 13), lo the same rounding of the
    f32 residual x - hi (exact), so |x - hi - lo| <= 2^-22 |x|.  Bit for
    bit the kernel's split, on finite inputs."""

    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def split_bf16(x: torch.Tensor) -> tuple:
    """f32 tensor -> (hi, lo) bf16 pair: hi is the round-to-nearest-even
    bf16 of x, lo the bf16 of the f32 residual x - hi, so
    |x - hi - lo| <= 2^-17 |x|.  Finite inputs only."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def stage_tf32_rows(filt_hi: torch.Tensor, filt_lo: torch.Tensor,
                    L: int) -> torch.Tensor:
    """The f32-class kernels' template rows: (n_ch, n_tiles, 2,
    TEMPLATE_TILE, KP) f32 with KP = round_up(L + 7, 8) + 8.  Axis 2 is
    (hi, lo), the TF32 parts; each row is 8 zeros, the L taps, zeros.
    csrc/mf.cu copies a block's 4 templates' rows into its stage, each
    ROW_FRONT - 8 elements into a zeroed row of `_row_width(L)`."""
    n_ch, n_tp_pad = filt_hi.shape[:2]
    n_tiles = n_tp_pad // TEMPLATE_TILE
    rows = torch.zeros((n_ch, n_tiles, 2, TEMPLATE_TILE, _tf32_row_width(L)),
                       dtype=torch.float32, device=filt_hi.device)
    a = SPLIT_ROW_FRONT
    for part, f in enumerate((filt_hi, filt_lo)):
        rows[:, :, part, :, a : a + L] = f[..., :L].reshape(
            n_ch, n_tiles, TEMPLATE_TILE, L)
    return rows


def tf32_rows_parts(filt_rows: torch.Tensor, L: int) -> tuple:
    """(filt_hi, filt_lo), each (n_ch, n_tp_pad, L) f32, read back out of
    staged TF32 rows."""
    n_ch, n_tiles = filt_rows.shape[:2]
    a = SPLIT_ROW_FRONT
    return tuple(filt_rows[:, :, part, :, a : a + L].reshape(
        n_ch, n_tiles * TEMPLATE_TILE, L) for part in (0, 1))


def stage_split_rows(filt_hi: torch.Tensor, filt_lo: torch.Tensor,
                     L: int) -> torch.Tensor:
    """The split kernel's template rows as it stages them in shared
    memory: (n_ch, n_tp_pad, 2, 2, ROW) bf16, ROW = `_split_row_width(L)`.
    Axis 2 is (hi, lo); axis 3 is the row as it is (SPLIT_ROW_OFF zeros,
    the taps, zeros) and the same row one element on (element x holds tap
    x + 1 - SPLIT_ROW_OFF), so that a pair of taps starting at an odd index
    is an aligned 32-bit word of the second copy.  A block's
    SPLIT_BLOCK_TEMPLATES templates of one channel are one contiguous copy
    into a stage of the kernel's ring."""
    n_ch, n_tp_pad = filt_hi.shape[:2]
    rows = torch.zeros((n_ch, n_tp_pad, 2, 2, _split_row_width(L)),
                       dtype=torch.bfloat16, device=filt_hi.device)
    a = SPLIT_ROW_OFF
    for part, f in enumerate((filt_hi, filt_lo)):
        rows[:, :, part, 0, a : a + L] = f[..., :L]
        rows[:, :, part, 1, a - 1 : a - 1 + L] = f[..., :L]
    return rows


def split_rows_parts(filt_rows: torch.Tensor, L: int) -> tuple:
    """(filt_hi, filt_lo), each (n_ch, n_tp_pad, L) bf16, read back out of
    staged rows."""
    a = SPLIT_ROW_OFF
    return tuple(filt_rows[:, :, part, 0, a : a + L] for part in (0, 1))


def _parts_plain(split, data_pad, filt_hi, filt_lo, mv_table, *, n_tp: int,
                 L: int, n_corr: int, lo_p: int, hi_p: int, lag_block: int,
                 lolo: bool) -> torch.Tensor:
    """The scan of both plain versions: the day split as the kernel splits
    it (`split`), the products of the parts as f32 matrix products (each
    product exact in f32; needs ``torch.backends.cuda.matmul.allow_tf32``
    False, the default), (fh*dh + fh*dl) + (fl*dh + fl*dl) with `lolo`,
    else fh*dh + (fh*dl + fl*dh), the normalization y from the unsplit f32
    day, the mask, and the sum over channels.  Chunked over `lag_block`
    lags: one unfolded day would not fit in memory."""
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
        d_hi, d_lo = split(data_pad[c])
        w_hi = d_hi.to(torch.float32).unfold(0, L, 1)
        w_lo = d_lo.to(torch.float32).unfold(0, L, 1)
        f_hi = filt_hi[c, act, :L, None].to(torch.float32)
        f_lo = filt_lo[c, act, :L, None].to(torch.float32)
        mva = mv[act]
        for b0 in range(0, n_corr, lag_block):
            b = torch.arange(b0, min(b0 + lag_block, n_corr), device=dev)
            p = b[None, :] + mva[:, None]       # (n_act, nb) positions
            ok = (p >= lo_p) & (p <= hi_p)
            pc = p.clamp(0, n_pos - 1)
            wh, wl = w_hi[pc], w_lo[pc]
            if lolo:
                corr = ((torch.matmul(wh, f_hi) + torch.matmul(wl, f_hi))
                        + (torch.matmul(wh, f_lo) + torch.matmul(wl, f_lo))
                        )[..., 0]
            else:
                corr = (torch.matmul(wh, f_hi)
                        + (torch.matmul(wl, f_hi) + torch.matmul(wh, f_lo))
                        )[..., 0]
            val = torch.where(ok, corr * y[pc], torch.zeros_like(corr))
            out[act, b0 : b0 + b.numel()] += val
    return out


def matched_filter_plain(data_pad, filt_hi, filt_lo, mv_table, *, n_tp: int,
                         L: int, n_corr: int, lo_p: int, hi_p: int,
                         lag_block: int = 4096) -> torch.Tensor:
    """Plain PyTorch version of the f32-class kernels, on the tensors'
    device.

    data_pad (n_ch, ext) f32; filt_hi, filt_lo (n_ch, n_tp_pad, >= L) f32,
    the two TF32 parts of the scaled template rows (`split_tf32`); mv_table
    (n_ch, n_tp_pad) int32 padded moveouts, -1 for a channel that adds
    nothing.  The day is split with `split_tf32`; the four products (fh*dh
    + fh*dl) + (fl*dh + fl*dl) are csrc/mf.cu's, in both its builds."""
    matched_filter_plain.calls += 1
    return _parts_plain(split_tf32, data_pad, filt_hi, filt_lo, mv_table,
                        n_tp=n_tp, L=L, n_corr=n_corr, lo_p=lo_p, hi_p=hi_p,
                        lag_block=lag_block, lolo=True)


matched_filter_plain.calls = 0


def _check_launch(lib, prefix: str, rc: int) -> None:
    if rc != 0:
        err = getattr(lib, f"{prefix}_error_string")(rc).decode()
        raise RuntimeError(f"{prefix} kernel launch failed: {err}")


def _check_tf32_plan(data_pad, filt_rows, mv_table, tile_lo, *, n_tp, L,
                     max_delta) -> None:
    """Raises ValueError on a 'highest'/'default' plan's tensors that the
    TF32 kernels do not take."""
    n_ch = data_pad.shape[0]
    _check_plan_tensors(data_pad, (("data_pad", data_pad, torch.float32),
                                   ("filt_rows", filt_rows, torch.float32),
                                   ("mv_table", mv_table, torch.int32),
                                   ("tile_lo", tile_lo, torch.int32)))
    n_tp_pad = mv_table.shape[1]
    if (tuple(filt_rows.shape) != (
            n_ch, n_tp_pad // TEMPLATE_TILE, 2, TEMPLATE_TILE,
            _tf32_row_width(L))
            or mv_table.shape[0] != n_ch or n_tp_pad % TEMPLATE_TILE
            or n_tp > n_tp_pad
            or tuple(tile_lo.shape) != (n_ch, n_tp_pad // TEMPLATE_TILE)):
        raise ValueError("inconsistent matched-filter plan shapes")
    if _smem_bytes(L, max_delta) > SMEM_LIMIT:
        raise ValueError("moveout span too wide for one kernel tile")


def _tf32_plain(data_pad, filt_rows, mv_table, *, n_tp, L, n_corr, lo_p,
                hi_p, lag_block):
    filt_hi, filt_lo = tf32_rows_parts(filt_rows, L)
    return matched_filter_plain(data_pad, filt_hi, filt_lo, mv_table,
                                n_tp=n_tp, L=L, n_corr=n_corr, lo_p=lo_p,
                                hi_p=hi_p, lag_block=lag_block)


def _tf32_cc(wrapper, defines, data_pad, filt_rows, mv_table, tile_lo, *,
             n_tp, L, n_corr, lo_p, hi_p, max_delta,
             lag_block) -> torch.Tensor:
    """The f32 rungs' route: `matched_filter_plain` on CPU tensors; on CUDA
    tensors the pre-pass (`tf32_day`) and then the main kernel of csrc/mf.cu's
    build with -D `defines` on its arrays, counted on `wrapper`, or
    raises."""
    if data_pad.device.type == "cpu":
        return _tf32_plain(data_pad, filt_rows, mv_table, n_tp=n_tp, L=L,
                           n_corr=n_corr, lo_p=lo_p, hi_p=hi_p,
                           lag_block=lag_block)
    if data_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {data_pad.device}")
    _check_tf32_plan(data_pad, filt_rows, mv_table, tile_lo, n_tp=n_tp, L=L,
                     max_delta=max_delta)
    n_ch = data_pad.shape[0]
    out = torch.empty((n_tp, max(int(n_corr), 0)), dtype=torch.float32,
                      device=data_pad.device)
    if n_corr <= 0:
        return out
    hi, lo, y = tf32_day(data_pad, L)
    lib = _lib(defines)
    with torch.cuda.device(data_pad.device):
        rc = lib.mf_launch(
            hi.data_ptr(), lo.data_ptr(), y.data_ptr(), hi.shape[1],
            filt_rows.data_ptr(), mv_table.data_ptr(), tile_lo.data_ptr(),
            out.data_ptr(), n_ch, n_tp, mv_table.shape[1], L, int(n_corr),
            int(lo_p), int(hi_p), int(max_delta),
            torch.cuda.current_stream().cuda_stream,
        )
    _check_launch(lib, "mf", rc)
    wrapper.launches += 1
    wrapper.launches_on[data_pad.device.index] += 1
    return out


def mf_cc(data_pad, filt_rows, mv_table, tile_lo, *, n_tp: int, L: int,
          n_corr: int, lo_p: int, hi_p: int, max_delta: int,
          lag_block: int = 4096) -> torch.Tensor:
    """(n_tp, n_corr) f32 network CC of a 'default' plan's tensors on
    padded data, every product split in TF32 parts.  `filt_rows` are the
    rows' two TF32 parts as `stage_tf32_rows` lays them out.

    On CPU tensors this is `matched_filter_plain`; on CUDA tensors it
    launches csrc/mf.cu's pre-pass (`tf32_day`) and then its main kernel
    on the pre-pass's arrays, or raises."""
    return _tf32_cc(mf_cc, (), data_pad, filt_rows, mv_table, tile_lo,
                    n_tp=n_tp, L=L, n_corr=n_corr, lo_p=lo_p, hi_p=hi_p,
                    max_delta=max_delta, lag_block=lag_block)


mf_cc.launches = 0
mf_cc.launches_on = collections.Counter()   # by card index


def mf_cc_highest(data_pad, filt_rows, mv_table, tile_lo, *, n_tp: int,
                  L: int, n_corr: int, lo_p: int, hi_p: int, max_delta: int,
                  lag_block: int = 4096) -> torch.Tensor:
    """`mf_cc` for a 'highest' plan: on CUDA tensors it launches the
    pre-pass and then csrc/mf.cu's 'highest' build (`HIGHEST_BUILD`: each
    group of HIGHEST_PARTIAL_STEPS k-steps summed from zero on the tensor
    cores, the partials added in round-to-nearest f32) or raises; on CPU
    tensors it is `matched_filter_plain`."""
    return _tf32_cc(mf_cc_highest, HIGHEST_BUILD, data_pad, filt_rows,
                    mv_table, tile_lo, n_tp=n_tp, L=L, n_corr=n_corr,
                    lo_p=lo_p, hi_p=hi_p, max_delta=max_delta,
                    lag_block=lag_block)


mf_cc_highest.launches = 0
mf_cc_highest.launches_on = collections.Counter()   # by card index


def matched_filter_split_plain(data_pad, filt_hi, filt_lo, mv_table, *,
                               n_tp: int, L: int, n_corr: int, lo_p: int,
                               hi_p: int,
                               lag_block: int = 4096) -> torch.Tensor:
    """Plain PyTorch version of the split kernel, on the tensors' device.

    data_pad (n_ch, ext) f32; filt_hi, filt_lo (n_ch, n_tp_pad, >= L)
    bf16, the two parts of the scaled template rows; mv_table as for
    `matched_filter_plain`.  The day is split with `split_bf16`."""
    matched_filter_split_plain.calls += 1
    return _parts_plain(split_bf16, data_pad, filt_hi, filt_lo, mv_table,
                        n_tp=n_tp, L=L, n_corr=n_corr, lo_p=lo_p, hi_p=hi_p,
                        lag_block=lag_block, lolo=False)


matched_filter_split_plain.calls = 0


SPLIT_YG = 16   # samples per partial of the window sums (MFS_YG)
SPLIT_ALIGN = 64  # the pre-pass's rows are the day rounded up to this


def _fma32(a, b, c):
    """f32 a * b + c rounded once (the product is exact in float64), as
    ``fmaf`` rounds it up to a rare double rounding."""
    return (a.double() * b.double() + c.double()).float()


def _day_plain(split, data_pad: torch.Tensor, L: int) -> tuple:
    """The pre-passes' plain version: (hi, lo, y), each (n_ch, ext_al)
    with ext_al = ext rounded up to SPLIT_ALIGN; hi, lo = `split` of the
    day (zeros past ext); y[c, p] = rsqrt of the L-sample window's f32
    variance sum at p (0 where it is <= 1e-10), the data read as zeros past
    ext, summed in csrc/mf_window.cuh's order: SPLIT_YG-sample partials of
    sums and fused squares, the partials in turn, the last L mod SPLIT_YG
    samples one by one, var = fma(-r1 * r1, 1 / L, r2), and the reciprocal
    square root rounded once (the card's ``rsqrtf`` lies within 2 ulp of
    it)."""
    n_ch, ext = data_pad.shape
    n = _round_up(ext, SPLIT_ALIGN)
    d = torch.zeros((n_ch, n + L + SPLIT_YG), dtype=torch.float32,
                    device=data_pad.device)
    d[:, :ext] = data_pad
    hi, lo = split(d[:, :n])
    n_grp = L // SPLIT_YG
    n_s = n + max(n_grp - 1, 0) * SPLIT_YG
    s1 = torch.zeros((n_ch, n_s), dtype=torch.float32, device=d.device)
    s2 = torch.zeros_like(s1)
    if n_grp:
        for k in range(SPLIT_YG):
            v = d[:, k : k + n_s]
            s1, s2 = s1 + v, _fma32(v, v, s2)
    r1 = torch.zeros((n_ch, n), dtype=torch.float32, device=d.device)
    r2 = torch.zeros_like(r1)
    for m in range(n_grp):
        r1 = r1 + s1[:, m * SPLIT_YG : m * SPLIT_YG + n]
        r2 = r2 + s2[:, m * SPLIT_YG : m * SPLIT_YG + n]
    for j in range(n_grp * SPLIT_YG, L):
        v = d[:, j : j + n]
        r1, r2 = r1 + v, _fma32(v, v, r2)
    inv_l = torch.tensor(1.0, dtype=torch.float32) / L
    var = _fma32(-(r1 * r1), inv_l.to(d.device).expand_as(r1), r2)
    v = var.abs() + torch.tensor(1e-30, dtype=torch.float32)
    y = torch.where(var > 1e-10, torch.rsqrt(v.double()).float(),
                    torch.zeros_like(var))
    return hi, lo, y


def split_day_plain(data_pad: torch.Tensor, L: int) -> tuple:
    """Plain PyTorch version of the split kernel's pre-pass, on the
    tensor's device: (hi, lo, y) as `_day_plain` describes them, hi and lo
    the `split_bf16` of the day."""
    return _day_plain(split_bf16, data_pad, L)


def tf32_day_plain(data_pad: torch.Tensor, L: int) -> tuple:
    """Plain PyTorch version of csrc/mf.cu's pre-pass, on the tensor's
    device: (hi, lo, y) as `_day_plain` describes them, hi and lo the
    `split_tf32` of the day (f32)."""
    return _day_plain(split_tf32, data_pad, L)


def _day_arrays(data_pad: torch.Tensor, dtype) -> tuple:
    _check_plan_tensors(data_pad, (("data_pad", data_pad, torch.float32),))
    n_ch, ext = data_pad.shape
    n = _round_up(ext, SPLIT_ALIGN)
    dev = data_pad.device
    hi = torch.empty((n_ch, n), dtype=dtype, device=dev)
    return hi, torch.empty_like(hi), torch.empty((n_ch, n),
                                                 dtype=torch.float32,
                                                 device=dev)


def split_day(data_pad: torch.Tensor, L: int) -> tuple:
    """The split kernel's pre-pass: (hi, lo, y) of the padded day as
    `split_day_plain` describes them.  On a CPU tensor this is
    `split_day_plain`; on a CUDA tensor it launches `mf_split_prepass` of
    csrc/mf_split.cu (counted on `split_day.launches`) or raises."""
    if data_pad.device.type == "cpu":
        return split_day_plain(data_pad, L)
    if data_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {data_pad.device}")
    hi, lo, y = _day_arrays(data_pad, torch.bfloat16)
    n_ch, ext = data_pad.shape
    lib = _lib_split()
    with torch.cuda.device(data_pad.device):
        rc = lib.mf_split_prepass_launch(
            data_pad.data_ptr(), ext, hi.shape[1], n_ch, L, hi.data_ptr(),
            lo.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _check_launch(lib, "mf_split", rc)
    split_day.launches += 1
    return hi, lo, y


split_day.launches = 0


def tf32_day(data_pad: torch.Tensor, L: int) -> tuple:
    """csrc/mf.cu's pre-pass: (hi, lo, y) of the padded day as
    `tf32_day_plain` describes them, (n_ch, ext_al) f32 each.  On a CPU
    tensor this is `tf32_day_plain`; on a CUDA tensor it launches
    `mf_prepass` of csrc/mf.cu (counted on `tf32_day.launches`) or
    raises."""
    if data_pad.device.type == "cpu":
        return tf32_day_plain(data_pad, L)
    if data_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {data_pad.device}")
    hi, lo, y = _day_arrays(data_pad, torch.float32)
    n_ch, ext = data_pad.shape
    lib = _lib()
    with torch.cuda.device(data_pad.device):
        rc = lib.mf_prepass_launch(
            data_pad.data_ptr(), ext, hi.shape[1], n_ch, L, hi.data_ptr(),
            lo.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _check_launch(lib, "mf", rc)
    tf32_day.launches += 1
    return hi, lo, y


tf32_day.launches = 0


def mf_cc_split(data_pad, filt_rows, mv_table, tile_lo, *, n_tp: int,
                L: int, n_corr: int, lo_p: int, hi_p: int, max_delta: int,
                lag_block: int = 4096) -> torch.Tensor:
    """(n_tp, n_corr) f32 network CC of a 'high' plan's tensors on padded
    data, every product split in bf16 parts.  `filt_rows` are the rows'
    two bf16 parts as `stage_split_rows` lays them out.

    On CPU tensors this is `matched_filter_split_plain`; on CUDA tensors
    it launches csrc/mf_split.cu's pre-pass (`split_day`) and then its
    main kernel on the pre-pass's arrays, or raises."""
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
    if (tuple(filt_rows.shape) != (n_ch, n_tp_pad, 2, 2,
                                   _split_row_width(L))
            or mv_table.shape[0] != n_ch or n_tp_pad % TEMPLATE_TILE
            or n_tp > n_tp_pad
            or tuple(tile_lo.shape) != (n_ch, n_tp_pad // TEMPLATE_TILE)):
        raise ValueError("inconsistent matched-filter plan shapes")
    if _split_smem_bytes(L, max_delta) > SMEM_LIMIT:
        raise ValueError("moveout span too wide for one kernel tile")
    out = torch.empty((n_tp, max(int(n_corr), 0)), dtype=torch.float32,
                      device=data_pad.device)
    if n_corr <= 0:
        return out
    hi, lo, y = split_day(data_pad, L)
    lib = _lib_split()
    with torch.cuda.device(data_pad.device):
        rc = lib.mf_split_launch(
            hi.data_ptr(), lo.data_ptr(), y.data_ptr(), hi.shape[1],
            filt_rows.data_ptr(), mv_table.data_ptr(), tile_lo.data_ptr(),
            out.data_ptr(), n_ch, n_tp, n_tp_pad, L, int(n_corr), int(lo_p),
            int(hi_p), int(max_delta),
            torch.cuda.current_stream().cuda_stream,
        )
    _check_launch(lib, "mf_split", rc)
    mf_cc_split.launches += 1
    mf_cc_split.launches_on[data_pad.device.index] += 1
    return out


mf_cc_split.launches = 0
mf_cc_split.launches_on = collections.Counter()   # by card index


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
    'default' run the two builds of csrc/mf.cu (`mf_cc_highest` and
    `mf_cc`, which differ in how they accumulate): the plan splits the rows
    in two TF32 parts once (`split_tf32`) and keeps them laid out as both
    read them (`filt_rows`, `stage_tf32_rows`; `tf32_rows_parts` reads the
    parts back).  'high' runs the split kernel (`mf_cc_split`) on bf16 parts
    (`split_bf16`, `stage_split_rows`, `split_rows_parts`).  Each kernel's
    pre-pass splits the day.  `lag_block` is the plain versions' lag
    chunk."""

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

        self.n_tp_pad = n_tp_pad = _round_up(max(n_tp, 1), TEMPLATE_TILE)
        filt = np.zeros((n_ch, n_tp_pad, L), np.float32)
        filt[:, :n_tp] = np.transpose(
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
        smem = (_split_smem_bytes if precision == "high"
                else _smem_bytes)(L, self.max_delta)
        if smem > SMEM_LIMIT:
            raise ValueError(
                f"moveout span {self.max_delta} samples within a "
                f"{TEMPLATE_TILE}-template tile does not fit one kernel "
                f"block's shared memory"
            )
        tile_lo = np.where(any_used, t_lo, -1).astype(np.int32)

        self.lo_p = self.pad_left
        self.hi_p = self.pad_left + self.n_samp - L
        split, stage = ((split_bf16, stage_split_rows)
                        if precision == "high"
                        else (split_tf32, stage_tf32_rows))
        self.filt_rows = stage(*(t.to(self.device)
                                 for t in split(torch.from_numpy(filt))), L)
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
        wrapper = {"high": mf_cc_split, "highest": mf_cc_highest,
                   "default": mf_cc}[self.precision_name]
        return wrapper(data_pad, self.filt_rows, self.mv_table, self.tile_lo,
                       **kw)


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
