"""PyTorch and CUDA port of seismic_bpmf_tpu."""

__version__ = "0.1.0"
