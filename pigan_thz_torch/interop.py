"""Weight carry-over between the JAX package and the port.

``from_flax`` turns the JAX package's flax variables, given as nested numpy
dicts ({"params": ..., ["batch_stats": ...]}), into a state_dict for the
port's modules; ``to_flax`` does the inverse.  The port's modules carry the
reference's torch layout, so the mapping is the table of
``pigan_thz_tpu/interop.py`` (copied here: importing the JAX package would
import JAX).

Mapping rules:
- torch ``nn.Linear.weight`` is (out, in); flax ``nn.Dense.kernel`` is
  (in, out) -> transpose.
- torch BatchNorm1d ``weight/bias/running_mean/running_var`` map to flax
  ``scale/bias`` (params) + ``mean/var`` (batch_stats).
- torch LayerNorm ``weight/bias`` -> flax ``scale/bias``.

``load_forward_state_`` and ``forward_state_to_flax`` carry the
forward-pretraining state (F's parameters, Adam's moments, the count) the
same way, so that both packages can train on from one state.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

# (torch prefix, flax path prefix, layer kind).  flax paths are
# '/'-separated; the leading collection ("params"/"batch_stats") is implied
# by the kind.
LayerMap = List[Tuple[str, str, str]]

GENERATOR_MAP: LayerMap = [
    ("main.0", "MLPBlock_0/Dense_0", "linear"),
    ("main.1", "MLPBlock_0/NormAct_0/BatchNorm_0", "batchnorm"),
    ("main.3", "MLPBlock_1/Dense_0", "linear"),
    ("main.4", "MLPBlock_1/NormAct_0/BatchNorm_0", "batchnorm"),
    ("main.6", "Dense_0", "linear"),
]

FORWARD_MODEL_MAP: LayerMap = [
    *(
        entry
        for i in range(5)
        for entry in (
            (f"model.{4 * i}", f"MLPBlock_{i}/Dense_0", "linear"),
            (f"model.{4 * i + 1}", f"MLPBlock_{i}/NormAct_0/LayerNorm_0", "layernorm"),
        )
    ),
    ("model.20", "Dense_0", "linear"),
]

MAPS: Dict[str, LayerMap] = {
    "generator": GENERATOR_MAP,
    "forward_model": FORWARD_MODEL_MAP,
}


def _layer_map(kind: str) -> LayerMap:
    if kind not in MAPS:
        raise ValueError(f"unknown model kind {kind!r}; expected one of {sorted(MAPS)}")
    return MAPS[kind]


def _get(tree: Mapping, path: str):
    node = tree
    for p in path.split("/"):
        node = node[p]
    return node


def _set(tree: dict, path: str, leaf) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = leaf


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def from_flax(variables_np: Mapping, kind: str) -> Dict[str, torch.Tensor]:
    """flax variables (nested numpy dicts) -> CPU state_dict of the port's
    ``kind`` module ("generator" or "forward_model")."""
    params = variables_np["params"]
    stats = variables_np.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for tkey, fpath, layer in _layer_map(kind):
        if layer == "linear":
            sd[f"{tkey}.weight"] = _t(np.asarray(_get(params, f"{fpath}/kernel")).T)
            sd[f"{tkey}.bias"] = _t(_get(params, f"{fpath}/bias"))
        else:
            sd[f"{tkey}.weight"] = _t(_get(params, f"{fpath}/scale"))
            sd[f"{tkey}.bias"] = _t(_get(params, f"{fpath}/bias"))
            if layer == "batchnorm":
                sd[f"{tkey}.running_mean"] = _t(_get(stats, f"{fpath}/mean"))
                sd[f"{tkey}.running_var"] = _t(_get(stats, f"{fpath}/var"))
                sd[f"{tkey}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd


def to_flax(state_dict: Mapping[str, torch.Tensor], kind: str) -> dict:
    """The port's ``kind`` state_dict -> flax variables as nested numpy
    dicts ({"params": ..., ["batch_stats": ...]})."""
    params: dict = {}
    stats: dict = {}
    for tkey, fpath, layer in _layer_map(kind):
        if layer == "linear":
            _set(params, f"{fpath}/kernel", _np(state_dict[f"{tkey}.weight"]).T.copy())
            _set(params, f"{fpath}/bias", _np(state_dict[f"{tkey}.bias"]))
        else:
            _set(params, f"{fpath}/scale", _np(state_dict[f"{tkey}.weight"]))
            _set(params, f"{fpath}/bias", _np(state_dict[f"{tkey}.bias"]))
            if layer == "batchnorm":
                _set(stats, f"{fpath}/mean", _np(state_dict[f"{tkey}.running_mean"]))
                _set(stats, f"{fpath}/var", _np(state_dict[f"{tkey}.running_var"]))
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return variables


# ---------------------------------------------------------------------------
# Forward-pretraining state: F's parameters, Adam's moments and count
# ---------------------------------------------------------------------------


def _flat(state_dict: Mapping[str, torch.Tensor], module: torch.nn.Module) -> torch.Tensor:
    """A state_dict's parameters as one vector in ``module``'s flat order."""
    return torch.cat([state_dict[name].reshape(-1) for name, _ in module.named_parameters()])


def _unflat(flat: torch.Tensor, module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    out, pos = {}, 0
    for name, p in module.named_parameters():
        out[name] = flat[pos: pos + p.numel()].view(p.shape)
        pos += p.numel()
    return out


@torch.no_grad()
def load_forward_state_(state, params: Mapping, mu: Mapping, nu: Mapping, count: int,
                        step: int | None = None):
    """Overwrite the port's ``ForwardState`` (``train/state.py``) in place
    with a JAX ``ForwardState`` carried across as numpy: F's flax params
    tree, Adam's ``mu`` and ``nu`` trees (the same structure) and its
    count; ``step`` defaults to ``count``.  Returns ``state``."""
    f = state.f
    for dst, tree in ((state.params, params), (state.opt.m, mu), (state.opt.v, nu)):
        sd = from_flax({"params": tree}, "forward_model")
        dst.copy_(_flat(sd, f).to(dst.device))
    state.opt.count = int(count)
    state.step = int(count if step is None else step)
    return state


def forward_state_to_flax(state) -> dict:
    """The port's ``ForwardState`` as the JAX package's pieces, in numpy:
    {"params", "mu", "nu"} flax trees, "count" and "step"."""
    out = {}
    for key, flat in (("params", state.params), ("mu", state.opt.m), ("nu", state.opt.v)):
        out[key] = to_flax(_unflat(flat.detach(), state.f), "forward_model")["params"]
    out["count"] = int(state.opt.count)
    out["step"] = int(state.step)
    return out
