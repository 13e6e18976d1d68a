"""Saved-model artifacts: the port of the part of
``pigan_thz_tpu/train/checkpoint.py`` that forward pretraining needs.

The artifact names are the reference's contract (unified_trainer.py:643-651,
train_pigan.py:299-309, read at unified_evaluator.py:89-99).  A model is
saved as its torch ``state_dict`` in ``<name>.pth``, which is the
reference's own layout (the port's modules carry it; ``interop.py``).
``model_config.json`` holds the architecture sections and the data bounds
as the JAX package writes them.

Orbax is not used here.  ``CheckpointManager``, the full-state checkpoints
and resume come later (ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

import json
import os

import torch
from torch import nn

from ..config import _to_dict

# Fixed artifact names (parity with the reference's *.pth contract).
GENERATOR_FINAL = "generator_final"
DISCRIMINATOR_FINAL = "discriminator_final"
FORWARD_MODEL_FINAL = "forward_model_final"
FORWARD_MODEL_PRETRAINED = "forward_model_pretrained"
GENERATOR_EMA = "generator_ema"
TRAIN_STATE = "train_state"
MODEL_CONFIG = "model_config.json"


def _path(directory: str, name: str) -> str:
    return os.path.join(os.path.abspath(directory), name)


def save_model_config(directory: str, config) -> None:
    """Write the generator / discriminator / forward_model sections and the
    data bounds and grid (the fields that bake into artifacts) as JSON."""
    d = _to_dict(config)
    sections = {k: d[k] for k in ("generator", "discriminator", "forward_model")}
    sections["data"] = {
        k: d["data"][k]
        for k in ("param_min", "param_max", "spectrum_dim", "freq_min", "freq_max")
    }
    os.makedirs(os.path.abspath(directory), exist_ok=True)
    with open(_path(directory, MODEL_CONFIG), "w") as fh:
        json.dump(sections, fh, indent=2)


def load_model_config(directory: str):
    """The saved sections as a dict, or None if absent."""
    p = _path(directory, MODEL_CONFIG)
    if not os.path.isfile(p):
        return None
    with open(p) as fh:
        return json.load(fh)


def save_model(directory: str, name: str, module: nn.Module) -> str:
    """Write ``module``'s state_dict (on the CPU) to ``<directory>/<name>.pth``."""
    os.makedirs(os.path.abspath(directory), exist_ok=True)
    path = _path(directory, f"{name}.pth")
    state = {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}
    torch.save(state, path)
    return path


def load_model(directory: str, name: str, module: nn.Module) -> nn.Module:
    """Load ``<directory>/<name>.pth`` into ``module`` (strict) and return it."""
    path = _path(directory, f"{name}.pth")
    state = torch.load(path, map_location="cpu", weights_only=True)
    module.load_state_dict(state)
    return module
