"""Normalized cross-correlation (matched filter) in plain PyTorch ops.

Counterpart of `seismic_bpmf_tpu/ops/matched_filter.py`, the engine the
JAX package runs outside any hand-written kernel; it is what
`TemplateGroup.compute_intertemplate_cc` calls and the only engine with
``network_sum=False`` (per-channel CC series).  Semantics match
`ops.reference.matched_filter`: Pearson CC per channel, zero-variance or
out-of-bounds windows give CC = 0.

The sliding correlation is a matrix product of the unfolded data windows
with the demeaned template rows (f32: ``torch.backends.cuda.matmul.
allow_tf32`` must be False, the default; no convolution is used, so cuDNN's
TF32 default does not matter).  The window sums of the normalization are
summed directly over each window, not from a running prefix sum, which
would cancel over a long scan.  The lag axis runs in blocks of
`n_corr_block` lags so a day's per-channel series never exist at full
length; the result does not depend on the block size.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device

# window positions unfolded at once inside a block (bounds the (positions,
# L) temporaries, not the result)
_POS_CHUNK = 65536


def _channel_ccn(row, tp_dm, x_norm, start: int, pad_left: int,
                 n_samp: int, L: int):
    """Normalized CC of every template against every window of one padded
    channel slice: row (ext,), tp_dm (n_tp, L), x_norm (n_tp,) ->
    (n_tp, ext - L + 1).  Local position u is absolute sample
    ``start + u - pad_left``; windows leaving [0, n_samp) give 0."""
    windows = row.unfold(0, L, 1)                     # (n_valid, L) view
    n_valid = windows.shape[0]
    out = torch.empty((tp_dm.shape[0], n_valid), dtype=torch.float32,
                      device=row.device)
    for s in range(0, n_valid, _POS_CHUNK):
        w = windows[s : s + _POS_CHUNK]
        corr = torch.matmul(tp_dm, w.T)               # (n_tp, n)
        s1 = w.sum(-1)
        s2 = (w * w).sum(-1)
        y_norm = torch.sqrt(torch.clamp(s2 - s1 * s1 / L, min=0.0))
        a = (start + s - pad_left
             + torch.arange(w.shape[0], device=row.device))
        u_ok = (a >= 0) & (a + L <= n_samp)
        denom = x_norm[:, None] * y_norm[None, :]
        valid = u_ok[None, :] & (denom > 0.0)
        out[:, s : s + w.shape[0]] = torch.where(
            valid, corr / torch.where(valid, denom, torch.ones_like(denom)),
            torch.zeros_like(corr))
    return out


def matched_filter(templates, moveouts, weights, data, step: int = 1,
                   network_sum: bool = True, n_corr_block: int = 262144,
                   device=None) -> torch.Tensor:
    """Normalized CC of a template bank against continuous data, on
    `device` (CUDA unless 'cpu' is asked for).

    Parameters mirror `ops.reference.matched_filter`:
      templates : (n_tp, n_sta, n_comp, L) float32
      moveouts : (n_tp, n_sta, n_comp) int, samples
      weights : (n_tp, n_sta, n_comp) float32
      data : (n_sta, n_comp, n_samp) float32
      step : lag decimation in samples
      network_sum : sum channels with `weights` if True
      n_corr_block : lags per block (memory knob; result-invariant)

    Returns (n_tp, n_corr) float32 if network_sum, else
    (n_tp, n_corr, n_sta, n_comp); n_corr = (n_samp - L) // step + 1.
    """
    dev = resolve_device(device)
    templates = np.asarray(templates, np.float32)
    moveouts_np = np.asarray(moveouts, np.int64)
    n_tp, n_sta, n_comp, L = templates.shape
    data = np.asarray(data, np.float32)
    n_samp = data.shape[-1]
    n_ch = n_sta * n_comp
    n_corr = (n_samp - L) // step + 1

    pad_left = -min(0, int(moveouts_np.min()) if moveouts_np.size else 0)
    max_mv = int(moveouts_np.max()) if moveouts_np.size else 0
    tp_dm, x_norm, w_flat, mv_shift = bank_tensors(
        templates, moveouts_np, weights, pad_left, dev)

    if n_corr <= 0 or n_tp == 0:
        shape = ((n_tp, max(n_corr, 0)) if network_sum
                 else (n_tp, max(n_corr, 0), n_sta, n_comp))
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    K = min(int(n_corr_block), n_corr)
    n_blocks = -(-n_corr // K)
    # a block's slice covers local positions
    # [0, (K-1)*step + max_mv + pad_left + L)
    block_ext = (K - 1) * step + max_mv + pad_left + L
    total = (n_blocks - 1) * K * step + block_ext
    data_pad = torch.zeros((n_ch, max(total, n_samp + pad_left)),
                           dtype=torch.float32, device=dev)
    data_pad[:, pad_left : pad_left + n_samp] = torch.from_numpy(
        np.ascontiguousarray(data.reshape(n_ch, n_samp))).to(dev)
    out = mf_lags(tp_dm, x_norm, w_flat, mv_shift, data_pad, 0, n_corr,
                  step=step, n_samp=n_samp, pad_left=pad_left, L=L,
                  network_sum=network_sum, n_corr_block=K)
    if not network_sum:
        return out.reshape(n_tp, n_corr, n_sta, n_comp)
    return out


def bank_tensors(templates, moveouts, weights, pad_left: int, device):
    """A bank's tensors for `mf_lags` on `device`: the demeaned rows
    (n_ch, n_tp, L), their norms (n_tp, n_ch), the weights (n_tp, n_ch) and
    the moveouts shifted by `pad_left` (n_tp, n_ch)."""
    templates = np.asarray(templates, np.float32)
    n_tp, L = templates.shape[0], templates.shape[-1]
    n_ch = int(np.prod(templates.shape[1:-1]))
    tp_flat = templates.reshape(n_tp, n_ch, L)
    tp_dm = tp_flat - tp_flat.mean(axis=-1, keepdims=True)
    x_norm = np.sqrt((tp_dm.astype(np.float64) ** 2).sum(-1)).astype(
        np.float32)
    mv = np.asarray(moveouts, np.int64).reshape(n_tp, n_ch) + pad_left
    w = np.asarray(weights, np.float32).reshape(n_tp, n_ch)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (np.transpose(tp_dm, (1, 0, 2)), x_norm, w, mv))


def mf_lags(tp_dm, x_norm, w_flat, mv_shift, data, start: int, n_lags: int,
            *, step: int, n_samp: int, pad_left: int, L: int,
            network_sum: bool = True, n_corr_block: int = 262144):
    """`n_lags` lags of the scan on a slice of padded data: data (n_ch,
    width) on the device, column 0 at padded position `start` (absolute
    sample ``start - pad_left``), lag j reading padded columns ``j * step
    + mv_shift`` on.  tp_dm (n_ch, n_tp, L) demeaned rows, x_norm (n_tp,
    n_ch), w_flat (n_tp, n_ch), mv_shift (n_tp, n_ch) moveouts + pad_left.
    Windows leaving [0, n_samp) give 0, so a time shard with its halos
    (`parallel.sharded.matched_filter_sharded`) computes its lags as the
    whole scan does.  Returns (n_tp, n_lags), or (n_tp, n_lags, n_ch)
    without the network sum."""
    n_ch, n_tp = tp_dm.shape[0], tp_dm.shape[1]
    dev = data.device
    shape = (n_tp, n_lags) if network_sum else (n_tp, n_lags, n_ch)
    out = torch.zeros(shape, dtype=torch.float32, device=dev)
    K = max(1, min(int(n_corr_block), n_lags))
    block_ext = (K - 1) * step + int(mv_shift.max()) + L
    k_idx = torch.arange(K, device=dev) * step
    for b0 in range(0, n_lags, K):
        s0 = b0 * step
        nb = min(K, n_lags - b0)
        for c in range(n_ch):
            ccn = _channel_ccn(data[c, s0 : s0 + block_ext], tp_dm[c],
                               x_norm[:, c], start + s0, pad_left, n_samp, L)
            # out[t, k] = ccn[t, k * step + mv[t, c]]
            idx = k_idx[None, :nb] + mv_shift[:, c, None]
            sel = torch.gather(ccn, 1, idx)
            if network_sum:
                out[:, b0 : b0 + nb] += w_flat[:, c, None] * sel
            else:
                out[:, b0 : b0 + nb, c] = sel
    return out
