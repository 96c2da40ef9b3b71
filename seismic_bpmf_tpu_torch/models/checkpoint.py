"""PhaseNet checkpoints as `torch.save` state dicts.

Counterpart of `seismic_bpmf_tpu.models.checkpoint` (orbax or msgpack
there): a checkpoint is a directory holding one file.

  save_variables / load_variables     : the picker's weights (the model's
                                        state dict: parameters and
                                        BatchNorm statistics)
  save_train_state / load_train_state : a resumable training state (the
                                        model's and the optimizer's state
                                        dicts and the step)

Files are read back onto the CPU with `weights_only=True`.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import torch

VARIABLES_FILE = "variables.pt"
TRAIN_STATE_FILE = "train_state.pt"


def _state(obj) -> Any:
    """A module's or an optimizer's state dict; a state dict as it is."""
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def _save(path: str, name: str, obj) -> str:
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    torch.save(obj, os.path.join(path, name))
    return path


def _load(path: str, name: str):
    return torch.load(os.path.join(os.path.abspath(path), name),
                      map_location="cpu", weights_only=True)


def save_variables(path: str, variables) -> str:
    """Persist a picker's weights (a module, or its state dict) in the
    directory `path`.  Returns the absolute path."""
    return _save(path, VARIABLES_FILE, _state(variables))


def load_variables(path: str, target: Optional[torch.nn.Module] = None):
    """The state dict saved by `save_variables` (CPU tensors); with
    `target` (a module) it is also loaded into it, onto the module's
    device."""
    sd = _load(path, VARIABLES_FILE)
    if target is not None:
        target.load_state_dict(sd)
    return sd


def save_train_state(path: str, model, optimizer, step: int = 0) -> str:
    """Persist a training state: the model's and the optimizer's state
    dicts (or the objects themselves) and the step."""
    return _save(path, TRAIN_STATE_FILE, {
        "model": _state(model), "optimizer": _state(optimizer),
        "step": int(step)})


def load_train_state(path: str, target: Optional[Tuple] = None):
    """(model state dict, optimizer state dict, step) saved by
    `save_train_state`; with `target` = (module, optimizer), either may be
    None, each state is also loaded into its object (the optimizer's
    moments move to its parameters' device)."""
    state = _load(path, TRAIN_STATE_FILE)
    if target is not None:
        model, optimizer = target
        if model is not None:
            model.load_state_dict(state["model"])
        if optimizer is not None:
            optimizer.load_state_dict(state["optimizer"])
    return state["model"], state["optimizer"], int(state["step"])
