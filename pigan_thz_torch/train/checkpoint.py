"""Saved-model artifacts and full-state checkpoints: the port of
``pigan_thz_tpu/train/checkpoint.py``.

The artifact names are the reference's contract (unified_trainer.py:643-651,
train_pigan.py:299-309, read at unified_evaluator.py:89-99).  A model is
saved as its torch ``state_dict`` in ``<name>.pth``, which is the
reference's own layout (the port's modules carry it; ``interop.py``).
``load_model`` also takes the reference's wrapped training checkpoints
(``{'generator_state_dict': ...}``, train_pigan.py:283-295) and, for the
final forward model, falls back to ``forward_model_pretrained.pth``
(unified_evaluator.py:100-106), the loader's rules of the JAX package's
``interop.load_reference_models``.
``model_config.json`` holds the architecture sections and the data bounds
as the JAX package writes them.  ``save_final_trio`` / ``load_final_trio``
write and read the three final models of a PI-GAN run (and the EMA
generator when the state carries one), ``save_train_history`` /
``load_train_history`` the Trainer's per-epoch metric history.

``CheckpointManager`` keeps periodic full-state checkpoints with retention
on ``torch.save`` where the JAX package uses Orbax: the training state
(``ForwardState`` or ``PiGanState``, through their ``state_dict``) and a
JSON meta item with the epoch, the history, the config snapshot and a free
``extra`` dict, so that ``Trainer.resume_from`` continues the run exactly.
"""

from __future__ import annotations

import copy
import json
import os
import shutil

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


_WRAPPER_KEYS = {
    "generator": ("generator_state_dict",),
    "discriminator": ("discriminator_state_dict",),
    "forward_model": ("forward_model_state_dict",),
}


def load_torch_file(path: str):
    """``torch.load`` a ``.pth`` on the CPU: tensors only first, then the
    legacy pickle for the reference's wrapped training checkpoints, which
    carry Python objects beside the state_dicts."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        return torch.load(path, map_location="cpu", weights_only=False)


def extract_state_dict(obj, which: str | None = None) -> dict:
    """The bare state_dict for ``which`` (generator | discriminator |
    forward_model) out of a ``.pth`` payload: a bare state_dict (the
    ``*_final.pth`` contract, train_pigan.py:301-303) is returned as it is,
    a wrapped training checkpoint gives ``<which>_state_dict``, else
    ``model_state_dict`` or ``state_dict``."""
    if not isinstance(obj, dict):
        raise TypeError(f"unsupported .pth payload: {type(obj)}")
    # a bare state_dict is non-empty and all-tensor-valued; metadata-only
    # wrappers ({'epoch': 5, ...}) and {} fall through to the key search and
    # the readable error below
    if obj and all(hasattr(v, "shape") for v in obj.values()):
        return obj
    for key in _WRAPPER_KEYS.get(which or "", ()) + ("model_state_dict", "state_dict"):
        if key in obj:
            return obj[key]
    raise KeyError(f"no state_dict for {which!r} in checkpoint with keys {sorted(obj)[:8]}")


def _which(name: str) -> str | None:
    """The model an artifact name belongs to (``generator_final`` ->
    ``generator``), or None."""
    return next((w for w in _WRAPPER_KEYS if name.startswith(w)), None)


def load_model(directory: str, name: str, module: nn.Module) -> nn.Module:
    """Load ``<directory>/<name>.pth`` into ``module`` (strict) and return
    it.  The file holds a bare state_dict or a wrapped checkpoint
    (``extract_state_dict``); ``forward_model_final`` falls back to
    ``forward_model_pretrained`` when it is absent.  A missing file raises
    ``FileNotFoundError`` with the paths tried, a state_dict of another
    architecture ``ValueError`` with both sets of shapes."""
    tried = [_path(directory, f"{name}.pth")]
    if name == FORWARD_MODEL_FINAL:
        tried.append(_path(directory, f"{FORWARD_MODEL_PRETRAINED}.pth"))
    path = next((p for p in tried if os.path.isfile(p)), None)
    if path is None:
        raise FileNotFoundError(f"no saved model {name!r}: tried {', '.join(tried)}")
    state = extract_state_dict(load_torch_file(path), _which(name))
    got = {k: tuple(v.shape) for k, v in state.items()}
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    if got != want:
        raise ValueError(
            f"{path}: the checkpoint does not match the {type(module).__name__} it is "
            f"loaded into.\n  loaded:   {got}\n  expected: {want}")
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


# ---------------------------------------------------------------------------
# Full-state checkpoints
# ---------------------------------------------------------------------------

_PARTIAL, _REPLACED = ".partial", ".replaced"


def _config_meta(config):
    """JSON-able view of a config (dicts and None pass through)."""
    if config is None or isinstance(config, dict):
        return config
    return _to_dict(config)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    """Periodic full-state checkpoints with retention: the JAX package's
    manager (``pigan_thz_tpu/train/checkpoint.py``) on ``torch.save``.

    ``<directory>/train_state/<epoch>/`` holds ``state.pt`` (the state's
    ``state_dict`` on the CPU: tensors, ints and floats only, so it loads
    with ``weights_only=True``) and ``meta.json`` (``{epoch, history,
    config, extra}``, ``extra`` a JSON-able dict such as the plateau
    controller's state).  A save is written into
    ``train_state/<epoch>.partial`` and renamed into place, so a kill
    mid-save leaves no epoch directory: ``latest_epoch`` ignores the
    partial one and the next save removes it.  Retention keeps the
    ``max_to_keep`` latest saves (None keeps all), deleting the oldest only
    after a save has completed.  As with Orbax, "latest" is the last epoch
    saved through this manager, or the highest on disk when it opened.
    Unlike Orbax, saving an epoch that is already there replaces it (a run
    resumed from an earlier epoch saves its later ones again).

    Saves are synchronous; ``close`` has nothing left to wait for.  The JAX
    package's legacy Orbax layout (a bare state item) is not read: no
    checkpoint of this package predates this manager."""

    def __init__(self, directory: str, max_to_keep: int | None = 3, save_interval: int = 50):
        self.directory = os.path.abspath(directory)
        self.save_interval = max(1, save_interval)
        self.max_to_keep = max_to_keep
        self._root = os.path.join(self.directory, TRAIN_STATE)
        os.makedirs(self._root, exist_ok=True)
        # completed epochs, oldest save first (at open: by epoch)
        self._epochs = sorted(int(n) for n in os.listdir(self._root) if n.isdigit())
        self._last_saved: int | None = None

    def _epoch_dir(self, epoch: int) -> str:
        return os.path.join(self._root, str(int(epoch)))

    def _write(self, epoch: int, state, history, config, extra) -> None:
        for name in os.listdir(self._root):       # what a killed save left
            if name.endswith((_PARTIAL, _REPLACED)):
                shutil.rmtree(os.path.join(self._root, name), ignore_errors=True)
        final = self._epoch_dir(epoch)
        tmp = final + _PARTIAL
        os.makedirs(tmp)
        payload = {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
                   for k, v in state.state_dict().items()}
        meta = {"epoch": int(epoch), "history": history if history is not None else {},
                "config": _config_meta(config), "extra": extra if extra is not None else {}}
        with open(os.path.join(tmp, "state.pt"), "wb") as fh:
            torch.save(payload, fh)
            fh.flush()
            os.fsync(fh.fileno())
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump(meta, fh)
            fh.flush()
            os.fsync(fh.fileno())
        if os.path.isdir(final):
            os.replace(final, final + _REPLACED)
        os.replace(tmp, final)
        _fsync_dir(self._root)
        shutil.rmtree(final + _REPLACED, ignore_errors=True)
        if epoch in self._epochs:
            self._epochs.remove(epoch)
        self._epochs.append(int(epoch))
        while self.max_to_keep and len(self._epochs) > self.max_to_keep:
            shutil.rmtree(self._epoch_dir(self._epochs.pop(0)), ignore_errors=True)

    def maybe_save(self, epoch: int, state, history=None, config=None, extra=None) -> bool:
        """Save when an interval boundary was crossed since the last save
        through this method, and never below ``save_interval``: callers
        that see only chunked epoch counts (25-epoch chunks at interval 30
        save at 50 and 75) still save."""
        prev = self._last_saved if self._last_saved is not None else 0
        if epoch // self.save_interval <= prev // self.save_interval and prev != 0:
            return False
        if epoch < self.save_interval:
            return False
        self._write(epoch, state, history, config, extra)
        self._last_saved = epoch
        return True

    def save(self, epoch: int, state, history=None, config=None, extra=None) -> None:
        """Save ``state`` at ``epoch`` now, whatever the interval."""
        self._write(epoch, state, history, config, extra)

    def latest_epoch(self) -> int | None:
        return self._epochs[-1] if self._epochs else None

    def all_epochs(self) -> list[int]:
        """The epochs kept, in increasing order."""
        return sorted(self._epochs)

    def restore(self, state, epoch: int | None = None):
        """(epoch, state): see ``restore_with_meta``."""
        epoch, state, _ = self.restore_with_meta(state, epoch)
        return epoch, state

    def restore_with_meta(self, state, epoch: int | None = None):
        """(epoch, state, meta) of ``epoch`` (default: the latest), or
        (None, None, None) when there is none.  The checkpoint is loaded
        into ``state`` in place (``load_state_dict_``, onto its device);
        with ``state=None`` only the meta is read."""
        epoch = self.latest_epoch() if epoch is None else int(epoch)
        if epoch is None:
            return None, None, None
        path = self._epoch_dir(epoch)
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no checkpoint for epoch {epoch} under {self._root}")
        with open(os.path.join(path, "meta.json")) as fh:
            meta = json.load(fh)
        if state is not None:
            payload = torch.load(os.path.join(path, "state.pt"), map_location=state.device,
                                 weights_only=True)
            state.load_state_dict_(payload)
        return epoch, state, meta

    def close(self) -> None:
        """Nothing to wait for: every save completed before it returned."""
