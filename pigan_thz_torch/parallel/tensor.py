"""Tensor parallelism over the model axis: the port of the model-axis half
of ``pigan_thz_tpu/parallel/sharding.py`` (:33-66) and of what XLA's
partitioner makes of it.

**Placement.**  ``param_partition_spec`` is the JAX package's rule word for
word: a leaf's largest dimension that is at least ``min_shard_dim`` and
divisible by the model axis's size M is split over the axis, else the leaf
is replicated.  It is applied to each leaf's flax-layout shape (torch's
``Linear.weight`` is (out, in), flax's kernel (in, out); a conv's, an
attention projection's shapes as ``interop.py`` maps them), so that a tie,
a square kernel, picks the logical axis JAX picks.  ``state_shardings``
gives every leaf of a state its spec in the torch layout.  A sharded leaf is
split into M contiguous blocks; model rank r keeps block r, of the
parameters, Adam's two moments, the EMA and the BatchNorm running stats
alike.  The states keep one flat buffer a model whose parameters are views
(``train/state.py``); under a model axis each rank's flat buffer holds its
local blocks, in the same order.

**Compute.**  The split is of the work too, as XLA splits the matmuls of
sharded kernels.  An activation is either *replicated* (the same on every
model rank) or *sharded* on its features (rank r holds block r).  The
collectives are autograd functions, each the adjoint of another, so the
gradients are exact to every order (WGAN-GP's penalty differentiates twice):
a replicated tensor's gradient on each rank is its whole gradient.
- A Dense whose kernel is split on its output dimension computes its own
  columns with its bias block, from a replicated input (whose gradient then
  sums over the model group: ``_CopyIn``).
- A Dense split on its input dimension multiplies its input block by its
  kernel block and sums the partial products over the model group
  (``_ReduceSum``); a replicated bias is added once after the sum, a split
  bias to this rank's block of it.
- A sharded activation that feeds a layer needing whole features is
  all-gathered (``_ToFull``; its gradient is this rank's block); a
  replicated one that feeds a split layer is sliced (``_ToShard``).
- LayerNorm over sharded features sums its rows' float64 sums over the
  model group (``mesh.py:_SumOverRanks``), as ``models/blocks.py:
  batch_stats_over`` does over the data group.  BatchNorm is per feature:
  over its features it needs no model collective; its batch sums still go
  over the data group.  Dropout draws its masks at full width and keeps
  this rank's block.
- A model whose computation is not one ``nn.Sequential`` of such layers
  (the enhanced variants: convs, attention, residual blocks) computes
  whole: each sharded leaf is all-gathered before use (``_GatherLeaf``),
  its gradient the mean over the model group of the ranks' gradients, this
  rank's block kept (a reduce-scatter); its sharded buffers are gathered
  for the call and this rank's block of their update kept.  The math is
  the same and the leaf stays stored split.

**Optimiser.**  The global gradient norm of the clip sums the squares of
each sharded leaf over the model group and counts each replicated leaf once
(``ShardPlan.sq_norm``, read by ``train/steps.py``); Adam runs on each
rank's blocks.  Gradients are averaged over the data group only.

``gather_state`` gives every rank the world-1 state (each sharded leaf
gathered over the model group), which checkpoints and ``save_final`` write
from rank 0, so a world-1 run loads them.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from .mesh import MODEL_AXIS, Mesh, _SumOverRanks


# ---------------------------------------------------------------------------
# The placement rule (pigan_thz_tpu/parallel/sharding.py:33-44)
# ---------------------------------------------------------------------------


def param_partition_spec(path_unused, x, model_size: int, min_shard_dim: int) -> tuple:
    """Partitioning rule for one leaf (its largest eligible dimension on the
    model axis; replicated otherwise), as a tuple of ``None`` and
    ``MODEL_AXIS`` per dimension, ``()`` for replicated: ``P(...)``'s
    entries.  ``x`` is a tensor or a shape."""
    shape = tuple(x.shape) if hasattr(x, "shape") else tuple(x)
    if model_size <= 1 or len(shape) == 0:
        return ()
    candidates = sorted(range(len(shape)), key=lambda d: -shape[d])
    for d in candidates:
        if shape[d] >= min_shard_dim and shape[d] % model_size == 0:
            spec = [None] * len(shape)
            spec[d] = MODEL_AXIS
            return tuple(spec)
    return ()


# torch leaf -> (view of the torch tensor, perm, vdims): flax's shape of the
# leaf is tuple(view[p] for p in perm), a split flax dimension k is the
# view's dimension perm[k], and view dimension j lies in torch dimension
# vdims[j] (an attention projection's heads and head_dim share one).
def _flax_view(kind: str, name: str, shape: tuple, heads: tuple | None):
    ident = tuple(range(len(shape)))
    if kind in ("linear", "spectral") and name == "weight":
        return shape, (1, 0), ident
    if kind == "conv" and name == "weight":
        return shape, (2, 1, 0), ident
    if kind in ("attn_in", "attn_out"):       # ``heads``: (heads, head_dim)
        h, d = heads
        if kind == "attn_in" and name == "weight":      # (h·d, in) ~ (in, h, d)
            return (h, d, shape[1]), (2, 0, 1), (0, 0, 1)
        if kind == "attn_in" and name == "bias":        # (h·d,) ~ (h, d)
            return (h, d), (0, 1), (0, 0)
        if kind == "attn_out" and name == "weight":     # (out, h·d) ~ (h, d, out)
            return (shape[0], h, d), (1, 2, 0), (0, 1, 1)
    return shape, ident, ident


@dataclass(frozen=True)
class LeafSpec:
    """One leaf: its torch shape, the view its split is taken in, the split
    dimension of that view (None: replicated) and the torch dimension that
    holds it."""

    name: str
    shape: tuple
    view: tuple
    dim: Optional[int]
    torch_dim: Optional[int]

    @property
    def torch_spec(self) -> tuple:
        """The spec in the torch layout."""
        if self.dim is None:
            return ()
        spec = [None] * len(self.shape)
        spec[self.torch_dim] = MODEL_AXIS
        return tuple(spec)

    def local_numel(self, size: int) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n if self.dim is None else n // size

    def local_shape(self, size: int) -> tuple:
        """The block's shape in the view."""
        if self.dim is None:
            return self.shape
        view = list(self.view)
        view[self.dim] //= size
        return tuple(view)

    def param_shape(self, size: int) -> tuple:
        """The block's shape as a module's parameter or buffer: the torch
        shape with the split torch dimension divided."""
        if self.dim is None:
            return self.shape
        shape = list(self.shape)
        shape[self.torch_dim] //= size
        return tuple(shape)

    def take(self, full: torch.Tensor, size: int, rank: int) -> torch.Tensor:
        """Model rank ``rank``'s block of the full leaf, in the parameter's
        shape (a copy when split)."""
        if self.dim is None:
            return full.reshape(self.shape)
        v = full.reshape(self.view)
        n = self.view[self.dim] // size
        return v.narrow(self.dim, rank * n, n).contiguous().reshape(self.param_shape(size))

    def join(self, blocks: list[torch.Tensor]) -> torch.Tensor:
        """The full leaf from every model rank's block, in rank order."""
        if self.dim is None:
            return blocks[0].reshape(self.shape)
        return torch.cat([b.reshape(self.local_shape(len(blocks))) for b in blocks],
                         dim=self.dim).reshape(self.shape)


def _layer_kinds(module: nn.Module) -> tuple[dict, dict]:
    """({torch prefix: flax kind} of ``module``'s layers (``interop.py``'s
    layer map: the baseline tables or the map an enhanced model records),
    {an attention projection's prefix: (heads, head_dim)})."""
    from ..interop import _layer_map
    from ..models.blocks import SelfAttention

    heads = {f"{name}.{proj}": (m.num_heads, m.head_dim)
             for name, m in module.named_modules() if isinstance(m, SelfAttention)
             for proj in ("query", "key", "value", "out")}
    try:
        return {prefix: kind for prefix, _, kind in _layer_map(module)}, heads
    except ValueError:
        return {}, heads


def module_leaves(module: nn.Module, model_size: int, min_shard_dim: int):
    """(params, buffers): ``LeafSpec``s of ``module``'s parameters in
    ``named_parameters`` order and of its floating buffers, the rule applied
    to each leaf's flax-layout shape."""
    kinds, heads = _layer_kinds(module)

    def spec(full_name: str, t: torch.Tensor) -> LeafSpec:
        prefix, _, name = full_name.rpartition(".")
        kind = kinds.get(prefix, "linear" if t.dim() == 2 else "other")
        shape = tuple(t.shape)
        view, perm, vdims = _flax_view(kind, name, shape, heads.get(prefix))
        flax_shape = tuple(view[p] for p in perm)
        fspec = param_partition_spec(None, flax_shape, model_size, min_shard_dim)
        if not fspec:
            return LeafSpec(full_name, shape, view, None, None)
        dim = perm[fspec.index(MODEL_AXIS)]
        return LeafSpec(full_name, shape, view, dim, vdims[dim])

    params = [spec(n, p) for n, p in module.named_parameters()]
    buffers = [spec(n, b) for n, b in module.named_buffers() if b.is_floating_point()]
    return params, buffers


def state_shardings(state, mesh: Mesh, min_shard_dim: int = 512) -> dict:
    """One spec per leaf of ``state``'s ``state_dict`` (a ``ForwardState``
    or ``PiGanState``), in the torch layout: every parameter of each flat
    buffer (``"g_params/main.0.weight"``) and of Adam's moments and the EMA
    beside it, each module buffer (BatchNorm running stats), ``()`` for the
    step, the counts and the generator."""
    size = mesh.shape[MODEL_AXIS]
    out = {}
    for key, value in state.state_dict().items():
        out[key] = ()
    for prefix, flat_keys, module in _flat_modules(state):
        params, buffers = module_leaves(module, size, min_shard_dim)
        for key in flat_keys:
            out.pop(key, None)
            for leaf in params:
                out[f"{key}/{leaf.name}"] = leaf.torch_spec
        for leaf in buffers:
            out[f"{prefix}.{leaf.name}"] = leaf.torch_spec
    return out


def _flat_modules(state):
    """(the state_dict prefix of a model's buffers, the keys of its flat
    buffers, the model) for each model of ``state``."""
    if hasattr(state, "g_params"):
        g_keys = ["g_params", "g_opt.m", "g_opt.v"] + (
            ["g_ema"] if state.g_ema is not None else [])
        return [("g", g_keys, state.g), ("d", ["d_params", "d_opt.m", "d_opt.v"], state.d),
                ("f", ["f_params"], state.f)]
    return [("f", ["params", "opt.m", "opt.v"], state.f)]


# ---------------------------------------------------------------------------
# Collectives as autograd functions (each one's backward is its adjoint)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelAxis:
    """This rank's model group: ``size`` ranks, of which this is ``rank``."""

    size: int
    rank: int
    group: object

    def __deepcopy__(self, memo):
        return self

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def block(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * n, n).contiguous()


class _ToShard(torch.autograd.Function):
    """Replicated -> this rank's block along ``dim``; backward all-gathers."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return axis.block(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return _ToFull.apply(grad, ctx.dim, ctx.axis), None, None


class _ToFull(torch.autograd.Function):
    """Sharded along ``dim`` -> replicated (all-gather); backward keeps this
    rank's block of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return torch.cat(axis.all_gather(x), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return _ToShard.apply(grad, ctx.dim, ctx.axis), None, None


class _CopyIn(torch.autograd.Function):
    """Identity on a replicated tensor entering split work; backward sums
    the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _ReduceSum.apply(grad, ctx.axis), None


class _ReduceSum(torch.autograd.Function):
    """The sum over the model group of partial products; backward is the
    identity (the sum is replicated, so is its gradient)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return _CopyIn.apply(grad, ctx.axis), None


class _GatherLeaf(torch.autograd.Function):
    """A stored block -> the whole leaf (all-gather in its view); backward
    reduce-scatters: the mean over the model group of the ranks' gradients
    of the whole leaf, this rank's block of it."""

    @staticmethod
    def forward(ctx, x, leaf, axis):
        ctx.leaf, ctx.axis = leaf, axis
        return leaf.join(axis.all_gather(x))

    @staticmethod
    def backward(ctx, grad):
        leaf, axis = ctx.leaf, ctx.axis
        mean = _ReduceSum.apply(grad, axis) / axis.size
        block = _ToShard.apply(mean.reshape(leaf.view), leaf.dim, axis)
        return block.reshape(leaf.param_shape(axis.size)), None, None


def to_shard(x: torch.Tensor, axis: ModelAxis, dim: int = -1) -> torch.Tensor:
    return _ToShard.apply(x, dim % x.dim(), axis)


def to_full(x: torch.Tensor, axis: ModelAxis, dim: int = -1) -> torch.Tensor:
    return _ToFull.apply(x, dim % x.dim(), axis)


# ---------------------------------------------------------------------------
# The split layers (set as ``layer.tp`` on the baseline models' layers)
# ---------------------------------------------------------------------------

REPL, SHARD = "replicated", "sharded"


@dataclass
class LayerTP:
    """What one layer of a split ``nn.Sequential`` does on the model axis:
    its input's state (``REPL`` / ``SHARD``), its kind (Dense: "repl",
    "out", "in"; a norm: whether its parameters are split), and whether its
    output is gathered (the last split layer of a model whose output would
    be sharded)."""

    axis: ModelAxis
    x_state: str
    kind: str = "repl"
    bias_split: bool = False
    gather_out: bool = False

    def __deepcopy__(self, memo):
        return self

    def finish(self, y: torch.Tensor) -> torch.Tensor:
        return to_full(y, self.axis) if self.gather_out else y


def _dense_apply(layer, x, weight, bias):
    dt = layer.compute_dtype
    if dt is None:
        return torch.nn.functional.linear(x, weight, bias)
    y = torch.matmul(x.to(dt), weight.to(dt).t())
    return y if bias is None else y + bias.to(dt)


def dense_forward(layer, x: torch.Tensor) -> torch.Tensor:
    """``models/blocks.py:Dense`` under ``layer.tp``."""
    tp = layer.tp
    ax = tp.axis
    if tp.kind == "repl":
        if tp.x_state == SHARD:
            x = to_full(x, ax)
        return tp.finish(_dense_apply(layer, x, layer.weight, layer.bias))
    if tp.kind == "out":                      # my columns, from the whole input
        if tp.x_state == SHARD:
            x = to_full(x, ax)
        return tp.finish(_dense_apply(layer, _CopyIn.apply(x, ax), layer.weight, layer.bias))
    # "in": my rows of the kernel times my block of the input, summed
    if tp.x_state == REPL:
        x = to_shard(x, ax)
    z = _ReduceSum.apply(_dense_apply(layer, x, layer.weight, None), ax)
    if not tp.bias_split:
        b = layer.bias if layer.compute_dtype is None else layer.bias.to(layer.compute_dtype)
        return tp.finish(z + b)
    b = layer.bias if layer.compute_dtype is None else layer.bias.to(layer.compute_dtype)
    return tp.finish(to_shard(z, ax) + b)


def layer_norm_forward(layer, x: torch.Tensor) -> torch.Tensor:
    """``FlaxLayerNorm`` under ``layer.tp``: over sharded features the rows'
    float64 sums (Σx, Σx²) go over the model group."""
    tp = layer.tp
    ax = tp.axis
    if tp.kind == "repl":                     # whole parameters
        if tp.x_state == SHARD:
            x = to_full(x, ax)
        return tp.finish(layer.plain_forward(x))
    dt = layer.compute_dtype
    if tp.x_state == REPL:                    # whole statistics, my block of the output
        x32 = x.float() if dt is not None else x
        y = torch.nn.functional.layer_norm(x32, x32.shape[-1:], None, None, layer.eps)
        y = to_shard(y, ax) * layer.weight + layer.bias
        return tp.finish(y if dt is None else y.to(dt))
    x32 = x.float() if dt is not None else x
    xd = x32.double()
    n = x.shape[-1] * ax.size
    sums = _SumOverRanks.apply(torch.cat([xd.sum(-1, keepdim=True),
                                          (xd * xd).sum(-1, keepdim=True)], -1), ax.group)
    mean_d = sums[..., :1] / n
    var = torch.clamp(sums[..., 1:] / n - mean_d * mean_d, min=0.0).to(x32.dtype)
    y = (x32 - mean_d.to(x32.dtype)) * torch.rsqrt(var + layer.eps) * layer.weight + layer.bias
    return tp.finish(y if dt is None else y.to(dt))


def batch_norm_input(layer, x: torch.Tensor) -> torch.Tensor:
    """``FlaxBatchNorm1d``'s input under ``layer.tp``: per feature, so only
    brought to the parameters' state."""
    tp = layer.tp
    if tp.kind == "split" and tp.x_state == REPL:
        return to_shard(x, tp.axis, 1)
    if tp.kind == "repl" and tp.x_state == SHARD:
        return to_full(x, tp.axis, 1)
    return x


def dropout_mask(layer, shape: tuple, device) -> torch.Tensor:
    """A sharded activation's mask: drawn at full width, this rank's block."""
    ax = layer.tp.axis
    full = list(shape)
    full[-1] *= ax.size
    return ax.block(layer.masks(tuple(full), layer.p, device), -1)


def _plan_sequential(seq: nn.Sequential, split: dict, axis: ModelAxis) -> Optional[list]:
    """(layer, LayerTP) for each layer of ``seq`` that needs one, walking the
    activation's state from a replicated input; None when a layer is not of
    the kinds the split path takes."""
    from ..models.blocks import Dense, Dropout, FlaxBatchNorm1d, FlaxLayerNorm, SpectralDense

    state, plan = REPL, []
    for layer in seq:
        if isinstance(layer, Dense) and not isinstance(layer, SpectralDense):
            wdim, bsplit = split[id(layer.weight)], split[id(layer.bias)] is not None
            kind = {None: "repl", 0: "out", 1: "in"}[wdim]
            if kind == "out" and not bsplit or kind == "repl" and bsplit:
                return None
            plan.append((layer, LayerTP(axis, state, kind, bsplit)))
            state = REPL if kind == "repl" or kind == "in" and not bsplit else SHARD
        elif isinstance(layer, (FlaxLayerNorm, FlaxBatchNorm1d)):
            if type(layer) not in (FlaxLayerNorm, FlaxBatchNorm1d):
                return None
            psplit = split[id(layer.weight)] is not None
            plan.append((layer, LayerTP(axis, state, "split" if psplit else "repl")))
            state = SHARD if psplit else REPL
        elif isinstance(layer, Dropout):
            plan.append((layer, LayerTP(axis, state)))
        elif isinstance(layer, (nn.ReLU, nn.LeakyReLU, nn.Tanh, nn.Identity)):
            continue
        else:
            return None
    if state == SHARD:
        plan[-1][1].gather_out = True
    return plan


# ---------------------------------------------------------------------------
# One model's plan, sharding a state, gathering it back
# ---------------------------------------------------------------------------


@dataclass
class ShardPlan:
    """The model axis's plan for one module: its leaves' specs, the full
    module it was made from (a template for ``gather_module``), and whether
    it computes split (the baseline MLPs) or whole (``_GatherLeaf``)."""

    axis: ModelAxis
    params: list
    buffers: list
    template: nn.Module = field(repr=False)
    split: bool = True
    _mask: dict = field(default_factory=dict, repr=False)

    def __deepcopy__(self, memo):
        return self

    def local(self, full_flat: torch.Tensor) -> torch.Tensor:
        """This rank's flat buffer from a full one (parameters' order)."""
        parts, pos = [], 0
        for leaf in self.params:
            n = 1
            for s in leaf.shape:
                n *= s
            parts.append(leaf.take(full_flat[pos:pos + n], self.axis.size,
                                   self.axis.rank).reshape(-1))
            pos += n
        return torch.cat(parts).contiguous()

    def full(self, local_flat: torch.Tensor) -> torch.Tensor:
        """The full flat buffer from every rank's local one (a collective)."""
        blocks = self.axis.all_gather(local_flat)
        parts, pos = [], 0
        for leaf in self.params:
            n = leaf.local_numel(self.axis.size)
            parts.append(leaf.join([b[pos:pos + n] for b in blocks]).reshape(-1))
            pos += n
        return torch.cat(parts)

    def split_mask(self, device) -> torch.Tensor:
        """(local P,) bool: True on the split leaves' entries."""
        key = str(device)
        if key not in self._mask:
            self._mask[key] = torch.cat([
                torch.full((leaf.local_numel(self.axis.size),), leaf.dim is not None,
                           dtype=torch.bool) for leaf in self.params]).to(device)
        return self._mask[key]

    def sq_norm(self, g: torch.Tensor) -> torch.Tensor:
        """The squared global norm of the whole gradient, from this rank's
        flat block ``g``: the split leaves' squares summed over the model
        group, the replicated ones' counted once."""
        sq = g * g
        mask = self.split_mask(g.device)
        split = self.axis.all_reduce(torch.sum(sq[mask]).reshape(1))[0]
        return split + torch.sum(sq[~mask])


def _split_path_sequential(module: nn.Module) -> Optional[nn.Sequential]:
    from ..models.discriminator import MLPDiscriminator
    from ..models.forward_model import ForwardMLP
    from ..models.generator import MLPGenerator

    if type(module) in (MLPGenerator, MLPDiscriminator):
        return module.main
    if type(module) is ForwardMLP:
        return module.model
    return None


def _gathered_forward(self, *args, **kw):
    """The forward of a module that computes whole under a model axis (its
    class swapped for a subclass with this forward): the split leaves and
    buffers gathered, the model's own forward called on them, this rank's
    block of the buffers' update kept."""
    if getattr(self, "_tp_inside", False):
        return super(type(self), self).forward(*args, **kw)
    plan = self.tp_plan
    ax = plan.axis
    named_p = dict(self.named_parameters())
    named_b = dict(self.named_buffers())
    swap = {leaf.name: _GatherLeaf.apply(named_p[leaf.name], leaf, ax)
            for leaf in plan.params if leaf.dim is not None}
    bufs = {leaf.name: leaf.join(ax.all_gather(named_b[leaf.name]))
            for leaf in plan.buffers if leaf.dim is not None}
    self._tp_inside = True
    try:
        out = torch.func.functional_call(self, {**swap, **bufs}, args, kw, strict=False)
    finally:
        self._tp_inside = False
    with torch.no_grad():
        for name, full in bufs.items():
            leaf = next(lf for lf in plan.buffers if lf.name == name)
            named_b[name].copy_(leaf.take(full, ax.size, ax.rank))
    return out


_GATHERED_CLASSES: dict = {}


def _gathered_class(cls):
    if cls not in _GATHERED_CLASSES:
        _GATHERED_CLASSES[cls] = type(f"ModelAxis{cls.__name__}", (cls,),
                                      {"forward": _gathered_forward,
                                       "__module__": cls.__module__})
    return _GATHERED_CLASSES[cls]


def shard_module_(module: nn.Module, flats: list, axis: ModelAxis,
                  min_shard_dim: int = 512) -> list:
    """Make ``module`` (full, its parameters views of ``flats[0]``) this
    rank's part of it on the model axis, in place: each split parameter and
    buffer becomes its block, the parameters views of a new local flat
    buffer.  ``flats`` are the module's full flat buffers (parameters, then
    Adam's moments, the EMA); returns their local ones, the parameters'
    first.  The module computes split (a baseline MLP) or whole."""
    from ..train.state import bind_flat_

    template = copy.deepcopy(module).cpu()
    params, buffers = module_leaves(module, axis.size, min_shard_dim)
    plan = ShardPlan(axis, params, buffers, template)
    local = [plan.local(f) for f in flats]
    split_dims = {}
    with torch.no_grad():
        for leaf, p in zip(params, module.parameters()):
            split_dims[id(p)] = leaf.torch_dim
            if leaf.dim is not None:
                p.data = leaf.take(p.data, axis.size, axis.rank)
        for leaf in buffers:
            if leaf.dim is not None:
                buf = module.get_buffer(leaf.name)
                buf.data = leaf.take(buf.data, axis.size, axis.rank)
        bind_flat_(module, local[0])
    seq = _split_path_sequential(module)
    layer_plan = None if seq is None else _plan_sequential(seq, split_dims, axis)
    if layer_plan is None:
        plan.split = False
        module.__class__ = _gathered_class(type(module))
    else:
        for layer, tp in layer_plan:
            layer.tp = tp
    module.tp_plan = plan
    return local


def plan_of(module: nn.Module) -> Optional[ShardPlan]:
    return getattr(module, "tp_plan", None)


def gather_module(module: nn.Module) -> nn.Module:
    """The whole module (a plain copy, on ``module``'s device) from every
    model rank's part: a collective."""
    plan = plan_of(module)
    if plan is None:
        return module
    full = copy.deepcopy(plan.template).to(next(iter(module.parameters())).device)
    local = torch.cat([p.detach().reshape(-1) for p in module.parameters()])
    with torch.no_grad():
        torch.nn.utils.vector_to_parameters(plan.full(local), full.parameters())
        named_b = dict(module.named_buffers())
        for name, buf in full.named_buffers():
            leaf = next((lf for lf in plan.buffers if lf.name == name), None)
            src = named_b[name]
            if leaf is not None and leaf.dim is not None:
                src = leaf.join(plan.axis.all_gather(src.contiguous()))
            buf.copy_(src.reshape(buf.shape))
    full.train(module.training)
    for p, q in zip(full.parameters(), module.parameters()):
        p.requires_grad_(q.requires_grad)
    return full


def shard_state_(state, mesh: Mesh, min_shard_dim: int = 512):
    """Make a full ``ForwardState`` or ``PiGanState`` (the same on every
    rank) this rank's part on ``mesh``'s model axis, in place."""
    axis = model_axis(mesh)
    if hasattr(state, "g_params"):
        extras = [state.g_opt.m, state.g_opt.v] + (
            [state.g_ema] if state.g_ema is not None else [])
        g = shard_module_(state.g, [state.g_params, *extras], axis, min_shard_dim)
        state.g_params, state.g_opt.m, state.g_opt.v = g[:3]
        if state.g_ema is not None:
            state.g_ema = g[3]
        state.d_params, state.d_opt.m, state.d_opt.v = shard_module_(
            state.d, [state.d_params, state.d_opt.m, state.d_opt.v], axis, min_shard_dim)
        state.f_params, = shard_module_(state.f, [state.f_params], axis, min_shard_dim)
    else:
        state.params, state.opt.m, state.opt.v = shard_module_(
            state.f, [state.params, state.opt.m, state.opt.v], axis, min_shard_dim)
    return state


def gather_state(state):
    """The whole state on every rank (a new world-1 state, its models plain
    modules): every split leaf gathered over the model group.  A state
    without a plan is returned as it is."""
    from ..train.state import ForwardState, PiGanState, bind_flat_

    def whole(module, flats):
        plan = plan_of(module)
        full = gather_module(module)
        out = [torch.empty(sum(p.numel() for p in full.parameters()), dtype=torch.float32,
                           device=flats[0].device)]
        bind_flat_(full, out[0])
        out += [plan.full(f) for f in flats[1:]]
        return full, out

    if hasattr(state, "g_params"):
        if plan_of(state.g) is None:
            return state
        extras = [state.g_opt.m, state.g_opt.v] + (
            [state.g_ema] if state.g_ema is not None else [])
        g, gf = whole(state.g, [state.g_params, *extras])
        d, df = whole(state.d, [state.d_params, state.d_opt.m, state.d_opt.v])
        f, ff = whole(state.f, [state.f_params])
        gen = torch.Generator()
        gen.set_state(state.generator.get_state())
        g_opt, d_opt = state.g_opt.clone(), state.d_opt.clone()
        g_opt.m, g_opt.v = gf[1], gf[2]
        d_opt.m, d_opt.v = df[1], df[2]
        return PiGanState(state.step, g, d, f, gf[0], df[0], ff[0], g_opt, d_opt, gen,
                          gf[3] if state.g_ema is not None else None)
    if plan_of(state.f) is None:
        return state
    f, ff = whole(state.f, [state.params, state.opt.m, state.opt.v])
    opt = state.opt.clone()
    opt.m, opt.v = ff[1], ff[2]
    gen = torch.Generator()
    gen.set_state(state.generator.get_state())
    return ForwardState(state.step, f, ff[0], opt, gen)


def model_axis(mesh: Mesh) -> ModelAxis:
    return ModelAxis(mesh.model, mesh.model_rank, mesh.model_group)


def reshard_into_(state, whole) -> None:
    """Copy this rank's part of the whole state ``whole`` (as
    ``gather_state`` gives it) into the split ``state``, in place: its flat
    buffers, moments, EMA, buffers, step, counts and generator."""
    if hasattr(state, "g_params"):
        ema = ([(state.g_ema, whole.g_ema)]
               if state.g_ema is not None and whole.g_ema is not None else [])
        parts = [(state.g, whole.g, [(state.g_params, whole.g_params),
                                     (state.g_opt.m, whole.g_opt.m),
                                     (state.g_opt.v, whole.g_opt.v), *ema]),
                 (state.d, whole.d, [(state.d_params, whole.d_params),
                                     (state.d_opt.m, whole.d_opt.m),
                                     (state.d_opt.v, whole.d_opt.v)]),
                 (state.f, whole.f, [(state.f_params, whole.f_params)])]
        state.g_opt.count, state.d_opt.count = whole.g_opt.count, whole.d_opt.count
    else:
        parts = [(state.f, whole.f, [(state.params, whole.params), (state.opt.m, whole.opt.m),
                                     (state.opt.v, whole.opt.v)])]
        state.opt.count = whole.opt.count
    with torch.no_grad():
        for module, full_module, flats in parts:
            plan = plan_of(module)
            for local, full in flats:
                local.copy_(plan.local(full.to(local.device)))
            named = dict(full_module.named_buffers())
            split = {lf.name: lf for lf in plan.buffers if lf.dim is not None}
            for name, buf in module.named_buffers():
                src = named[name].to(buf.device)
                if name in split:
                    src = split[name].take(src, plan.axis.size, plan.axis.rank)
                buf.copy_(src)
    state.step = whole.step
    state.generator.set_state(whole.generator.get_state())
