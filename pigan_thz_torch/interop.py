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
same way, ``load_pigan_state_`` and ``pigan_state_to_flax`` the PI-GAN
state (G with its BatchNorm stats, D, the frozen F, both Adams, the EMA and
the step), so that both packages can train on from one state.
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

DISCRIMINATOR_MAP: LayerMap = [
    ("main.0", "Dense_0", "linear"),
    ("main.2", "Dense_1", "linear"),
    ("main.4", "Dense_2", "linear"),
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
    "discriminator": DISCRIMINATOR_MAP,
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


def _params_from_flax(params: Mapping, kind: str) -> Dict[str, torch.Tensor]:
    """A flax params tree -> the weights and biases of a ``kind`` state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for tkey, fpath, layer in _layer_map(kind):
        if layer == "linear":
            sd[f"{tkey}.weight"] = _t(np.asarray(_get(params, f"{fpath}/kernel")).T)
        else:
            sd[f"{tkey}.weight"] = _t(_get(params, f"{fpath}/scale"))
        sd[f"{tkey}.bias"] = _t(_get(params, f"{fpath}/bias"))
    return sd


def _params_to_flax(state_dict: Mapping[str, torch.Tensor], kind: str) -> dict:
    """The weights and biases of a ``kind`` state_dict -> a flax params tree."""
    params: dict = {}
    for tkey, fpath, layer in _layer_map(kind):
        if layer == "linear":
            _set(params, f"{fpath}/kernel", _np(state_dict[f"{tkey}.weight"]).T.copy())
        else:
            _set(params, f"{fpath}/scale", _np(state_dict[f"{tkey}.weight"]))
        _set(params, f"{fpath}/bias", _np(state_dict[f"{tkey}.bias"]))
    return params


def from_flax(variables_np: Mapping, kind: str) -> Dict[str, torch.Tensor]:
    """flax variables (nested numpy dicts) -> CPU state_dict of the port's
    ``kind`` module ("generator", "discriminator" or "forward_model")."""
    stats = variables_np.get("batch_stats", {})
    sd = _params_from_flax(variables_np["params"], kind)
    for tkey, fpath, layer in _layer_map(kind):
        if layer == "batchnorm":
            sd[f"{tkey}.running_mean"] = _t(_get(stats, f"{fpath}/mean"))
            sd[f"{tkey}.running_var"] = _t(_get(stats, f"{fpath}/var"))
            sd[f"{tkey}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd


def to_flax(state_dict: Mapping[str, torch.Tensor], kind: str) -> dict:
    """The port's ``kind`` state_dict -> flax variables as nested numpy
    dicts ({"params": ..., ["batch_stats": ...]})."""
    stats: dict = {}
    for tkey, fpath, layer in _layer_map(kind):
        if layer == "batchnorm":
            _set(stats, f"{fpath}/mean", _np(state_dict[f"{tkey}.running_mean"]))
            _set(stats, f"{fpath}/var", _np(state_dict[f"{tkey}.running_var"]))
    variables = {"params": _params_to_flax(state_dict, kind)}
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
        dst.copy_(_flat(_params_from_flax(tree, "forward_model"), f).to(dst.device))
    state.opt.count = int(count)
    state.step = int(count if step is None else step)
    return state


def forward_state_to_flax(state) -> dict:
    """The port's ``ForwardState`` as the JAX package's pieces, in numpy:
    {"params", "mu", "nu"} flax trees, "count" and "step"."""
    out = {}
    for key, flat in (("params", state.params), ("mu", state.opt.m), ("nu", state.opt.v)):
        out[key] = _params_to_flax(_unflat(flat.detach(), state.f), "forward_model")
    out["count"] = int(state.opt.count)
    out["step"] = int(state.step)
    return out


# ---------------------------------------------------------------------------
# PI-GAN state: G, D, the frozen F, both Adams, BatchNorm stats, EMA, step
# ---------------------------------------------------------------------------

_GD = (("generator", "g"), ("discriminator", "d"))


@torch.no_grad()
def load_pigan_state_(state, trees: Mapping):
    """Overwrite the port's ``PiGanState`` (``train/state.py``) in place with
    a JAX ``PiGanState`` carried across as numpy.  ``trees`` holds the flax
    variables ``"g"`` (params and batch_stats), ``"d"`` and ``"f"``; the
    params-shaped Adam trees ``"g_mu"``, ``"g_nu"``, ``"d_mu"``, ``"d_nu"``
    with ``"g_count"`` and ``"d_count"``; optionally ``"g_ema"`` (a params
    tree; the state must carry the buffer) and ``"step"`` (default: G's
    count).  An entry that is missing leaves its part as it is.  Returns
    ``state``."""
    for kind, key in (*_GD, ("forward_model", "f")):
        if key in trees:
            sd = from_flax(trees[key], kind)
            sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
            # in place: the parameters stay views into the flat buffers
            getattr(state, key).load_state_dict(sd, strict=False)
    for kind, pre in _GD:
        module, opt = getattr(state, pre), getattr(state, f"{pre}_opt")
        for dst, key in ((opt.m, f"{pre}_mu"), (opt.v, f"{pre}_nu")):
            if key in trees:
                dst.copy_(_flat(_params_from_flax(trees[key], kind), module).to(dst.device))
        if f"{pre}_count" in trees:
            opt.count = int(trees[f"{pre}_count"])
    if trees.get("g_ema") is not None:
        if state.g_ema is None:
            raise ValueError("the state carries no g_ema buffer (init_pigan_state(ema=True))")
        sd = _params_from_flax(trees["g_ema"], "generator")
        state.g_ema.copy_(_flat(sd, state.g).to(state.g_ema.device))
    state.step = int(trees.get("step", state.g_opt.count))
    return state


def pigan_state_to_flax(state) -> dict:
    """The port's ``PiGanState`` as the pieces ``load_pigan_state_`` takes,
    in numpy."""
    out = {
        "g": to_flax(state.g.state_dict(), "generator"),
        "d": to_flax(state.d.state_dict(), "discriminator"),
        "f": to_flax(state.f.state_dict(), "forward_model"),
    }
    for kind, pre in _GD:
        module, opt = getattr(state, pre), getattr(state, f"{pre}_opt")
        for flat, key in ((opt.m, f"{pre}_mu"), (opt.v, f"{pre}_nu")):
            out[key] = _params_to_flax(_unflat(flat.detach(), module), kind)
        out[f"{pre}_count"] = int(opt.count)
    if state.g_ema is not None:
        out["g_ema"] = _params_to_flax(_unflat(state.g_ema.detach(), state.g), "generator")
    out["step"] = int(state.step)
    return out
