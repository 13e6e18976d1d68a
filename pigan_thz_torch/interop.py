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
  ``scale/bias`` (params) + ``mean/var`` (batch_stats), the conv stack's
  too (e.g. ``ConvStack1D_0/NormAct_0/BatchNorm_0``).
- torch LayerNorm ``weight/bias`` -> flax ``scale/bias``.
- torch ``Conv1d.weight`` is (out, in, width); flax ``Conv.kernel`` is
  (width, in, out).
- attention: flax's q / k / v kernels are (in, heads, head_dim) with
  (heads, head_dim) biases, the out kernel (heads, head_dim, out); the
  port's projections are (heads·head_dim, in) and (out, heads·head_dim)
  ``Dense`` weights.
- spectral norm: flax's ``SpectralDense_i/Dense_0`` params, and in
  batch_stats ``SpectralDense_i/SpectralNorm_0`` the variables named
  ``Dense_0/kernel/u`` and ``Dense_0/kernel/sigma`` (one key each) -> the
  port's ``SpectralDense`` weight, bias, ``u`` (1, out) and ``sigma``.

A layer map is the baseline's table for the baseline models (by the kind
"generator", "discriminator", "forward_model" or by the module) and the one
each enhanced model records as it builds (``flax_layer_map``), so every
function here takes the module where a map is needed.

``load_forward_state_`` and ``forward_state_to_flax`` carry the
forward-pretraining state (F's parameters, Adam's moments, the count) the
same way, ``load_pigan_state_`` and ``pigan_state_to_flax`` the PI-GAN
state (G with its BatchNorm stats, D, the frozen F, both Adams, the EMA and
the step), so that both packages can train on from one state;
``load_ensemble_states_`` and ``ensemble_states_to_flax`` carry a
member-stacked state (every leaf with a leading member axis, the JAX
package's ``tree_stack`` of ``PiGanState``s) member by member.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple, Union

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


_BASELINE_KIND = {"MLPGenerator": "generator", "MLPDiscriminator": "discriminator",
                  "ForwardMLP": "forward_model"}

Kind = Union[str, torch.nn.Module]


def _layer_map(kind: Kind) -> LayerMap:
    """The layer map of a kind ("generator", "discriminator",
    "forward_model": the baseline's) or of a module."""
    if isinstance(kind, torch.nn.Module):
        if hasattr(kind, "flax_layer_map"):
            return kind.flax_layer_map()
        kind = _BASELINE_KIND.get(type(kind).__name__, type(kind).__name__)
    if kind not in MAPS:
        raise ValueError(f"unknown model kind {kind!r}; expected one of {sorted(MAPS)} "
                         "or a module of the port")
    return MAPS[kind]


def _get(tree: Mapping, path: str):
    node = tree
    for p in path.split("/"):
        node = node[p]
    return node


# flax names spectral norm's stats "Dense_0/kernel/u" and ".../sigma": one
# key each, slashes included, under the SpectralNorm module
_SN_VAR = "Dense_0/kernel"


def _set(tree: dict, path: str, leaf) -> None:
    if f"/SpectralNorm_0/{_SN_VAR}/" in path:
        head, var = path.split(f"/SpectralNorm_0/")
        tree = _get_or_make(tree, f"{head}/SpectralNorm_0")
        tree[var] = leaf
        return
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = leaf


def _get_or_make(tree: dict, path: str) -> dict:
    for p in path.split("/"):
        tree = tree.setdefault(p, {})
    return tree


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _weight_from_flax(kernel: np.ndarray, layer: str) -> np.ndarray:
    if layer == "conv":
        return kernel.transpose(2, 1, 0)
    if layer == "attn_in":
        return kernel.reshape(kernel.shape[0], -1).T
    if layer == "attn_out":
        return kernel.reshape(-1, kernel.shape[-1]).T
    return kernel.T                                     # linear, spectral


def _weight_to_flax(weight: np.ndarray, layer: str, split=None) -> np.ndarray:
    """The inverse of ``_weight_from_flax``; ``split`` is attention's
    (heads, head_dim)."""
    if layer == "conv":
        return weight.transpose(2, 1, 0).copy()
    if layer == "attn_in":
        return weight.T.reshape(weight.shape[1], *split).copy()
    if layer == "attn_out":
        return weight.T.reshape(*split, weight.shape[0]).copy()
    return weight.T.copy()


def _dense_path(fpath: str, layer: str) -> str:
    return f"{fpath}/Dense_0" if layer == "spectral" else fpath


def _params_from_flax(params: Mapping, kind: Kind) -> Dict[str, torch.Tensor]:
    """A flax params tree -> the weights and biases of a ``kind`` state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for tkey, fpath, layer in _layer_map(kind):
        fp = _dense_path(fpath, layer)
        if layer in ("batchnorm", "layernorm"):
            sd[f"{tkey}.weight"] = _t(_get(params, f"{fp}/scale"))
        else:
            sd[f"{tkey}.weight"] = _t(_weight_from_flax(np.asarray(_get(params, f"{fp}/kernel")),
                                                        layer))
        sd[f"{tkey}.bias"] = _t(np.asarray(_get(params, f"{fp}/bias")).reshape(-1))
    return sd


def _params_to_flax(state_dict: Mapping[str, torch.Tensor], kind: Kind) -> dict:
    """The weights and biases of a ``kind`` state_dict -> a flax params
    tree; attention's bias shapes come from the module's map."""
    params: dict = {}
    for tkey, fpath, layer in _layer_map(kind):
        fp = _dense_path(fpath, layer)
        w, b = _np(state_dict[f"{tkey}.weight"]), _np(state_dict[f"{tkey}.bias"])
        if layer in ("batchnorm", "layernorm"):
            _set(params, f"{fp}/scale", w)
        else:
            split = _attn_split(kind, tkey) if layer.startswith("attn") else None
            if layer == "attn_in":
                b = b.reshape(split)
            _set(params, f"{fp}/kernel", _weight_to_flax(w, layer, split))
        _set(params, f"{fp}/bias", b)
    return params


def _attn_split(module: Kind, tkey: str) -> tuple:
    """(heads, head_dim) of the attention that owns the projection ``tkey``."""
    owner = module.get_submodule(tkey.rsplit(".", 1)[0]) if "." in tkey else module
    return owner.num_heads, owner.head_dim


def from_flax(variables_np: Mapping, kind: Kind) -> Dict[str, torch.Tensor]:
    """flax variables (nested numpy dicts) -> CPU state_dict of the port's
    module ``kind`` (a module, or "generator", "discriminator" or
    "forward_model" for the baseline's)."""
    stats = variables_np.get("batch_stats", {})
    sd = _params_from_flax(variables_np["params"], kind)
    for tkey, fpath, layer in _layer_map(kind):
        if layer == "batchnorm":
            sd[f"{tkey}.running_mean"] = _t(_get(stats, f"{fpath}/mean"))
            sd[f"{tkey}.running_var"] = _t(_get(stats, f"{fpath}/var"))
            sd[f"{tkey}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
        elif layer == "spectral":
            sn = _get(stats, f"{fpath}/SpectralNorm_0")
            sd[f"{tkey}.u"] = _t(sn[f"{_SN_VAR}/u"])
            sd[f"{tkey}.sigma"] = _t(sn[f"{_SN_VAR}/sigma"])
    return sd


def to_flax(state_dict: Mapping[str, torch.Tensor], kind: Kind) -> dict:
    """The port's state_dict of ``kind`` -> flax variables as nested numpy
    dicts ({"params": ..., ["batch_stats": ...]})."""
    stats: dict = {}
    for tkey, fpath, layer in _layer_map(kind):
        if layer == "batchnorm":
            _set(stats, f"{fpath}/mean", _np(state_dict[f"{tkey}.running_mean"]))
            _set(stats, f"{fpath}/var", _np(state_dict[f"{tkey}.running_var"]))
        elif layer == "spectral":
            _set(stats, f"{fpath}/SpectralNorm_0/{_SN_VAR}/u", _np(state_dict[f"{tkey}.u"]))
            _set(stats, f"{fpath}/SpectralNorm_0/{_SN_VAR}/sigma",
                 _np(state_dict[f"{tkey}.sigma"]))
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
        dst.copy_(_flat(_params_from_flax(tree, f), f).to(dst.device))
    state.opt.count = int(count)
    state.step = int(count if step is None else step)
    return state


def forward_state_to_flax(state) -> dict:
    """The port's ``ForwardState`` as the JAX package's pieces, in numpy:
    {"params", "mu", "nu"} flax trees, "count" and "step"."""
    out = {}
    for key, flat in (("params", state.params), ("mu", state.opt.m), ("nu", state.opt.v)):
        out[key] = _params_to_flax(_unflat(flat.detach(), state.f), state.f)
    out["count"] = int(state.opt.count)
    out["step"] = int(state.step)
    return out


# ---------------------------------------------------------------------------
# PI-GAN state: G, D, the frozen F, both Adams, BatchNorm stats, EMA, step
# ---------------------------------------------------------------------------


@torch.no_grad()
def load_pigan_state_(state, trees: Mapping):
    """Overwrite the port's ``PiGanState`` (``train/state.py``) in place with
    a JAX ``PiGanState`` carried across as numpy.  ``trees`` holds the flax
    variables ``"g"``, ``"d"`` and ``"f"`` (params, and batch_stats where
    the model has them: G's BatchNorm stats, D's spectral-norm ``u`` and
    ``sigma``); the
    params-shaped Adam trees ``"g_mu"``, ``"g_nu"``, ``"d_mu"``, ``"d_nu"``
    with ``"g_count"`` and ``"d_count"``; optionally ``"g_ema"`` (a params
    tree; the state must carry the buffer) and ``"step"`` (default: G's
    count).  An entry that is missing leaves its part as it is.  Returns
    ``state``."""
    for key in ("g", "d", "f"):
        if key in trees:
            sd = from_flax(trees[key], getattr(state, key))
            sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
            # in place: the parameters stay views into the flat buffers
            getattr(state, key).load_state_dict(sd, strict=False)
    for pre in ("g", "d"):
        module, opt = getattr(state, pre), getattr(state, f"{pre}_opt")
        for dst, key in ((opt.m, f"{pre}_mu"), (opt.v, f"{pre}_nu")):
            if key in trees:
                dst.copy_(_flat(_params_from_flax(trees[key], module), module).to(dst.device))
        if f"{pre}_count" in trees:
            opt.count = int(trees[f"{pre}_count"])
    if trees.get("g_ema") is not None:
        if state.g_ema is None:
            raise ValueError("the state carries no g_ema buffer (init_pigan_state(ema=True))")
        sd = _params_from_flax(trees["g_ema"], state.g)
        state.g_ema.copy_(_flat(sd, state.g).to(state.g_ema.device))
    state.step = int(trees.get("step", state.g_opt.count))
    return state


def pigan_state_to_flax(state) -> dict:
    """The port's ``PiGanState`` as the pieces ``load_pigan_state_`` takes,
    in numpy."""
    out = {
        "g": to_flax(state.g.state_dict(), state.g),
        "d": to_flax(state.d.state_dict(), state.d),
        "f": to_flax(state.f.state_dict(), state.f),
    }
    for pre in ("g", "d"):
        module, opt = getattr(state, pre), getattr(state, f"{pre}_opt")
        for flat, key in ((opt.m, f"{pre}_mu"), (opt.v, f"{pre}_nu")):
            out[key] = _params_to_flax(_unflat(flat.detach(), module), module)
        out[f"{pre}_count"] = int(opt.count)
    if state.g_ema is not None:
        out["g_ema"] = _params_to_flax(_unflat(state.g_ema.detach(), state.g), state.g)
    out["step"] = int(state.step)
    return out


# ---------------------------------------------------------------------------
# Member-stacked PI-GAN state (seed ensembles)
# ---------------------------------------------------------------------------


def _member_tree(tree, m: int):
    """Member m of a stacked tree: every array leaf's row m; counts and the
    step may be stacked (one per member) or one scalar for all."""
    if isinstance(tree, Mapping):
        return {k: _member_tree(v, m) for k, v in tree.items()}
    a = np.asarray(tree)
    return a[m] if a.ndim else a


def load_ensemble_states_(states, trees: Mapping):
    """Overwrite the port's member-stacked state (``parallel/state_utils.py:
    EnsembleState``, or a sequence of ``PiGanState``s) in place with the JAX
    package's member-stacked ``PiGanState`` carried across as numpy:
    ``trees`` as ``load_pigan_state_`` takes them, every leaf with a leading
    member axis (``tree_stack`` of ``init_pigan_state``).  Member m's views
    into the stacked buffers stay bound.  Returns ``states``."""
    for m, st in enumerate(states):
        load_pigan_state_(st, _member_tree(trees, m))
    return states


def ensemble_states_to_flax(states) -> dict:
    """The port's member-stacked state as the pieces
    ``load_ensemble_states_`` takes, in numpy: every leaf, the counts and
    the step stacked on a leading member axis."""
    per = [pigan_state_to_flax(st) for st in states]

    def stack(nodes):
        if isinstance(nodes[0], Mapping):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack([np.asarray(n) for n in nodes])

    return stack(per)
