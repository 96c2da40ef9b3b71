"""roofline.mf_screen_cc: the least time of the window's days of CC work
(`work.mf_cc_day`, at the dense bf16 tensor peak, against the bytes at the
memory bandwidth) over the device time of the kernels that compute it:
csrc/mf.cu's pre-pass and main kernel."""

from benchmark.work import mf_cc_day, roofline_share

UNIT = "%"
# trace row pattern -> the launch counter its rows must match
KERNELS = {
    r"^mf_prepass\b": "seismic_bpmf_tpu_torch.ops.mf:tf32_day.launches",
    r"^mf_kernel\b": "seismic_bpmf_tpu_torch.ops.mf:mf_cc.launches",
}


def read(run):
    return roofline_share(run, KERNELS, mf_cc_day, "bf16_flops")
