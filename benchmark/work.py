"""The problem's work: the operations and bytes of one day of each kernel
layer, counted from the problem's shapes (what any implementation has to
do, not what this one does), and the card's published peaks."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAKS = {
    "bf16_flops": 989e12,     # tensor cores, bf16 and fp16
    "tf32_flops": 495e12,     # tensor cores, TF32
    "f32_flops": 67e12,       # outside the tensor cores
    "hbm_bytes_per_s": 3.35e12,
}


def mf_cc_day(p: dict) -> tuple:
    """(flops, bytes) of one day's network-summed CC: 2 x the (template,
    channel) pairs of nonzero weight x L x lags; the day's samples as the
    float32 handed in, the templates (float32) and moveouts (int32) each
    read once, and the (templates, lags) float32 CC written once."""
    flops = 2.0 * p["n_pairs"] * p["L"] * p["n_lags"]
    nbytes = 4.0 * (p["n_channels"] * p["n_samples"]
                    + p["n_templates"] * p["n_channels"] * p["L"]
                    + p["n_templates"] * p["n_channels"]
                    + p["n_templates"] * p["n_lags"])
    return flops, nbytes


def bp_beam_day(p: dict) -> tuple:
    """(flops, bytes) of one day's max beam: 2 x the used (source,
    station-phase) pairs x samples; the features (float32), the moveouts
    (int32), the source and phase weights (float32) each read once, and
    the max (float32) and argmax (int32) written once."""
    flops = 2.0 * p["n_pairs"] * p["n_samples"]
    n_sta, n_c, n_ph = p["n_stations"], p["n_components"], p["n_phases"]
    nbytes = 4.0 * (n_sta * n_c * p["n_samples"]
                    + p["n_sources"] * n_sta * n_ph
                    + p["n_sources"] * n_sta
                    + n_sta * n_c * n_ph
                    + 2 * p["n_samples"])
    return flops, nbytes


def least_seconds(flops: float, nbytes: float, peak_flops: float) -> float:
    """The larger of the operations at `peak_flops` and the bytes at the
    card's memory bandwidth."""
    return max(flops / peak_flops, nbytes / PEAKS["hbm_bytes_per_s"])


def roofline_share(run, kernels: dict, work, peak: str):
    """100 x the least time of the window's days of `work` over the
    device time of the trace's rows that `kernels` names; None without a
    trace or rows."""
    if run.trace is None or not run.n_days:
        return None
    t = sum(run.trace.rows(pat)[1] for pat in kernels)
    if t <= 0.0:
        return None
    flops, nbytes = work(run.problem)
    return 100.0 * run.n_days * least_seconds(flops, nbytes,
                                              PEAKS[peak]) / t
