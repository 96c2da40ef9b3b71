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

    tp_flat = templates.reshape(n_tp, n_ch, L)
    tp_dm_np = tp_flat - tp_flat.mean(axis=-1, keepdims=True)
    x_norm = torch.from_numpy(
        np.sqrt((tp_dm_np.astype(np.float64) ** 2).sum(-1)).astype(
            np.float32)).to(dev)                      # (n_tp, n_ch)
    tp_dm = torch.from_numpy(np.ascontiguousarray(
        np.transpose(tp_dm_np, (1, 0, 2)))).to(dev)   # (n_ch, n_tp, L)
    w_flat = torch.from_numpy(np.ascontiguousarray(
        np.asarray(weights, np.float32).reshape(n_tp, n_ch))).to(dev)

    max_mv = int(moveouts_np.max()) if moveouts_np.size else 0
    min_mv = min(0, int(moveouts_np.min()) if moveouts_np.size else 0)
    pad_left = -min_mv
    mv_shift = torch.from_numpy(
        moveouts_np.reshape(n_tp, n_ch) + pad_left).to(dev)   # >= 0

    if network_sum:
        out = torch.zeros((n_tp, max(n_corr, 0)), dtype=torch.float32,
                          device=dev)
    else:
        out = torch.zeros((n_tp, max(n_corr, 0), n_ch), dtype=torch.float32,
                          device=dev)
    if n_corr <= 0 or n_tp == 0:
        return (out if network_sum
                else out.reshape(n_tp, max(n_corr, 0), n_sta, n_comp))

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

    k_idx = torch.arange(K, device=dev) * step
    for b in range(n_blocks):
        start = b * K * step
        nb = min(K, n_corr - b * K)
        for c in range(n_ch):
            ccn = _channel_ccn(data_pad[c, start : start + block_ext],
                               tp_dm[c], x_norm[:, c], start, pad_left,
                               n_samp, L)
            # out[t, k] = ccn[t, k * step + mv[t, c]]
            idx = k_idx[None, :nb] + mv_shift[:, c, None]
            sel = torch.gather(ccn, 1, idx)
            if network_sum:
                out[:, b * K : b * K + nb] += w_flat[:, c, None] * sel
            else:
                out[:, b * K : b * K + nb, c] = sel
    if not network_sum:
        return out.reshape(n_tp, n_corr, n_sta, n_comp)
    return out
