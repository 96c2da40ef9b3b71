"""Neural models (PyTorch): the PhaseNet phase picker, its serving and its
training."""

from .checkpoint import (
    load_train_state,
    load_variables,
    save_train_state,
    save_variables,
)
from .phasenet import (
    PhaseNet,
    SeisBenchPhaseNet,
    from_flax_variables,
    init_phasenet,
    load_seisbench_checkpoint,
    make_picker,
    make_train_step,
    phasenet_probas_device,
    ps_channels,
    sliding_window_probas,
)
from .training import (
    make_sharded_train_step,
    train_phasenet,
    windows_from_events,
)

__all__ = [
    "PhaseNet",
    "SeisBenchPhaseNet",
    "from_flax_variables",
    "init_phasenet",
    "load_seisbench_checkpoint",
    "load_train_state",
    "load_variables",
    "make_picker",
    "make_sharded_train_step",
    "make_train_step",
    "phasenet_probas_device",
    "ps_channels",
    "save_train_state",
    "save_variables",
    "sliding_window_probas",
    "train_phasenet",
    "windows_from_events",
]
