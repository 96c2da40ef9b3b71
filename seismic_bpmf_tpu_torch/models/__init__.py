"""Neural models (PyTorch): the PhaseNet phase picker, for serving."""

from .phasenet import (
    PhaseNet,
    SeisBenchPhaseNet,
    from_flax_variables,
    init_phasenet,
    load_seisbench_checkpoint,
    make_picker,
    phasenet_probas_device,
    ps_channels,
    sliding_window_probas,
)

__all__ = [
    "PhaseNet",
    "SeisBenchPhaseNet",
    "from_flax_variables",
    "init_phasenet",
    "load_seisbench_checkpoint",
    "make_picker",
    "phasenet_probas_device",
    "ps_channels",
    "sliding_window_probas",
]
