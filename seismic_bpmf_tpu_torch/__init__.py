"""PyTorch and CUDA port of seismic_bpmf_tpu."""

__version__ = "0.1.0"

from .config import Config, DEFAULT_CONFIG

__all__ = ["Config", "DEFAULT_CONFIG", "__version__"]
