"""The parts of `seismic_bpmf_tpu.ops.beamform` that the backprojection
plan uses: the component fold and the flattened moveout tables.

    beam[i, t] = sum_{s,c,p} w_src[i, s] * w_ph[s, c, p] * feat[s, c, t + mv[i, s, p]]

The component axis is folded first, g[s, p, t] = sum_c w_ph[s, c, p] *
feat[s, c, t], as an f32 weighted sum on the features' device; the shifts
and the source sum are the kernel's (`ops.bp`).
"""

from __future__ import annotations

import numpy as np
import torch


def fold_components(features: torch.Tensor, weights_phases: torch.Tensor,
                    out: torch.Tensor = None) -> torch.Tensor:
    """g[s, p, t] = sum_c w_ph[s, c, p] * feat[s, c, t], flattened to
    (s * p, t), summed in f32 in ascending component order.

    `out`, when given, is an (n_sta, n_ph, >= n_samp) f32 buffer whose
    first n_samp columns receive the sum (the rest is left as it is)."""
    n_sta, n_comp, n_samp = features.shape
    n_ph = weights_phases.shape[-1]
    if out is None:
        out = torch.zeros((n_sta, n_ph, n_samp), dtype=torch.float32,
                          device=features.device)
    g = out[..., :n_samp]
    for c in range(n_comp):
        g += weights_phases[:, c, :, None] * features[:, c, None, :]
    return out.reshape(n_sta * n_ph, out.shape[-1])


def _flatten_moveouts(moveouts, weights_phases, weights_sources):
    """Flatten (sta, phase) axes; returns mv (n_src, n_sp), w (n_src, n_sp),
    and per-source used-channel moveout bounds for the 'strict' policy."""
    mv = np.asarray(moveouts)
    n_src, n_sta, n_ph = mv.shape
    mv_flat = mv.reshape(n_src, n_sta * n_ph).astype(np.int32)
    phase_used = np.any(np.asarray(weights_phases) != 0.0, axis=1)  # (sta, ph)
    w_src = np.asarray(weights_sources, dtype=np.float32)
    w_flat = np.repeat(w_src, n_ph, axis=1) * phase_used.reshape(-1)[None, :]
    used = w_flat != 0.0
    big = np.int32(2**30)
    mv_used_max = np.where(used, mv_flat, -big).max(axis=1)
    mv_used_min = np.where(used, mv_flat, big).min(axis=1)
    no_used = ~used.any(axis=1)
    mv_used_max[no_used] = 0
    mv_used_min[no_used] = 0
    return mv_flat, w_flat, mv_used_min, mv_used_max
