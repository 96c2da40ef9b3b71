"""roofline.bp_beam: the least time of the window's days of beam work
(`work.bp_beam_day`, at the float32 peak, against the bytes at the memory
bandwidth) over the device time of the kernels that compute it:
csrc/bp.cu's beam and its (max, argmax) unpack."""

from benchmark.work import bp_beam_day, roofline_share

UNIT = "%"
KERNELS = {
    r"^bp_kernel\b": "seismic_bpmf_tpu_torch.ops.bp:bp_beam.launches",
    r"^bp_unpack\b": "seismic_bpmf_tpu_torch.ops.bp:bp_beam.launches",
}


def read(run):
    return roofline_share(run, KERNELS, bp_beam_day, "f32_flops")
