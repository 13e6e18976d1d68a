"""Saved-model artifacts: the port of the named-artifact half of
``pigan_thz_tpu/train/checkpoint.py``.

The artifact names are the reference's contract (unified_trainer.py:643-651,
train_pigan.py:299-309, read at unified_evaluator.py:89-99).  A model is
saved as its torch ``state_dict`` in ``<name>.pth``, which is the
reference's own layout (the port's modules carry it; ``interop.py``).
``model_config.json`` holds the architecture sections and the data bounds
as the JAX package writes them.  ``save_final_trio`` / ``load_final_trio``
write and read the three final models of a PI-GAN run (and the EMA
generator when the state carries one), ``save_train_history`` /
``load_train_history`` the Trainer's per-epoch metric history.

Orbax is not used here.  ``CheckpointManager``, the full-state checkpoints
and resume come later (ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

import copy
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
TRAIN_HISTORY = "training_history.json"


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


def exists(directory: str, name: str) -> bool:
    return os.path.isfile(_path(directory, f"{name}.pth"))


def ema_generator(state) -> nn.Module:
    """A copy of ``state.g`` carrying the EMA parameters (and the live
    BatchNorm stats): loadable wherever a generator is."""
    g = copy.deepcopy(state.g)
    with torch.no_grad():
        pos = 0
        for p in g.parameters():
            p.data = state.g_ema[pos: pos + p.numel()].view(p.shape).clone()
            pos += p.numel()
    return g


def save_final_trio(directory: str, state, backup_tag: str | None = None) -> None:
    """Write the three final models of ``state`` (a ``PiGanState``) under
    their contract names (train_pigan.py:299-304), plus ``generator_ema``
    when the state carries an EMA track.  ``backup_tag`` also writes
    ``generator_<tag>`` etc. beside them, the reference's versioned
    ``*_unified.pth`` artifacts (unified_trainer.py:653-662)."""
    if backup_tag in ("final", "ema", "pretrained"):
        raise ValueError(
            f"backup_tag {backup_tag!r} collides with a canonical artifact name "
            "(generator_final/generator_ema/forward_model_pretrained); pick another tag")
    save_model(directory, GENERATOR_FINAL, state.g)
    save_model(directory, DISCRIMINATOR_FINAL, state.d)
    save_model(directory, FORWARD_MODEL_FINAL, state.f)
    if getattr(state, "g_ema", None) is not None:
        save_model(directory, GENERATOR_EMA, ema_generator(state))
    if backup_tag:
        save_model(directory, f"generator_{backup_tag}", state.g)
        save_model(directory, f"discriminator_{backup_tag}", state.d)
        save_model(directory, f"forward_model_{backup_tag}", state.f)


def load_final_trio(directory: str, generator: nn.Module, discriminator: nn.Module,
                    forward_model: nn.Module):
    """Read the trio back into the three modules (unified_evaluator.py:55-111)
    and return them."""
    return (load_model(directory, GENERATOR_FINAL, generator),
            load_model(directory, DISCRIMINATOR_FINAL, discriminator),
            load_model(directory, FORWARD_MODEL_FINAL, forward_model))


def save_train_history(directory: str, history) -> None:
    """Write the Trainer's flat {metric: [per-epoch floats]} history as JSON
    next to the finals (skipped when empty)."""
    if not history:
        return
    os.makedirs(os.path.abspath(directory), exist_ok=True)
    with open(_path(directory, TRAIN_HISTORY), "w") as fh:
        json.dump(history, fh)


def load_train_history(directory: str):
    """The saved history dict, or None if absent."""
    p = _path(directory, TRAIN_HISTORY)
    if not os.path.isfile(p):
        return None
    with open(p) as fh:
        return json.load(fh)
