"""Shared building blocks for the port's model zoo (torch.nn).

``mlp_block`` is the Dense -> norm -> activation -> dropout motif of
``pigan_thz_tpu/models/blocks.py:MLPBlock``, returned as a flat list of
layers so that the models' ``nn.Sequential`` carries the reference's torch
state_dict layout (``main.0`` / ``model.0`` ... ; ``interop.py``).

Norm constants are flax's, not torch's defaults:
- LayerNorm eps 1e-6 (flax default; torch's is 1e-5);
- BatchNorm eps 1e-5, torch momentum 0.1 == flax momentum 0.9.
  ``FlaxBatchNorm1d`` is flax's BatchNorm in train mode: the batch variance
  is max(0, E[x²] − E[x]²) and the running variance takes the biased batch
  variance (``nn.BatchNorm1d`` stores the unbiased one).  In eval mode it is
  ``nn.BatchNorm1d``, with the same state_dict keys.

``flax_init_`` reproduces flax's initialisers (truncated lecun_normal
kernels, zero biases, unit norm scales, BatchNorm stats 0 / 1; a conv's
fan-in is in_channels x width, spectral norm's ``u`` a unit normal),
drawing from an explicit ``torch.Generator``.

The enhanced variants stand on four blocks of
``pigan_thz_tpu/models/blocks.py`` (:99-189): ``SpectralDense`` (flax's
``SpectralNorm`` around a Dense, not torch's parametrization),
``ResidualBlock``, ``ConvStack1D`` (torch's (B, C, L) layout inside, the
JAX package's (B, tokens, C) tokens out) and ``SelfAttention`` (flax's
``MultiHeadDotProductAttention`` as plain tensor code).

Dropout.  ``Dropout`` is ``nn.Dropout`` whose train-mode masks can come
from a provider (``dropout_masks``): the training steps key every mask by
(step seed, model call, layer index), so no mask is drawn from torch's
global generator, and the parity tests hand the JAX package's masks in.
Each model's ``Dropout`` layers are registered in the order its forward
runs them.  Attention-weight dropout is flax's ``broadcast_dropout``: one
(Q, K) mask shared by the batch and the heads.

Compute dtype (``train.compute_dtype``).  With "bfloat16" the layers follow
flax's ``dtype=bfloat16`` semantics, not torch autocast: parameters stay
float32; ``Dense`` casts its input, kernel and bias to bfloat16 (flax's
``promote_dtype``), so the product and the bias add round to bfloat16; the
norms compute their statistics and the normalisation in float32 from the
upcast input and round their output to bfloat16 (flax's ``_compute_stats`` /
``_normalize``); the activations run in bfloat16.  With "float32" every layer
is torch's own.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import math
from typing import Callable, Sequence

import torch
from torch import nn
from torch.nn import functional as F

LAYER_NORM_EPS = 1e-6
BATCH_NORM_EPS = 1e-5
BATCH_NORM_MOMENTUM = 0.1

def compute_dtype_of(name: str) -> torch.dtype | None:
    """``train.compute_dtype`` as the layers take it: None for float32 (torch's
    own layers), ``torch.bfloat16`` for bfloat16."""
    if name == "float32":
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"compute_dtype {name!r}: use float32 | bfloat16")


class Dense(nn.Linear):
    """``nn.Linear`` with flax's ``Dense(dtype=...)``: under a compute dtype
    the input, kernel and bias are cast to it, and the output is in it."""

    # set by parallel/tensor.py on a model split over a model axis
    tp = None

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            from ..parallel.tensor import dense_forward

            return dense_forward(self, x)
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return torch.matmul(x.to(dt), self.weight.to(dt).t()) + self.bias.to(dt)


class FlaxLayerNorm(nn.LayerNorm):
    """``nn.LayerNorm``; under a compute dtype flax's LayerNorm(dtype=...):
    the one-pass variance max(0, E[x²] − E[x]²) and the normalisation in
    float32, the output in the compute dtype."""

    tp = None       # set by parallel/tensor.py on a model split over a model axis

    def __init__(self, features: int, eps: float, compute_dtype: torch.dtype | None = None):
        super().__init__(features, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            from ..parallel.tensor import layer_norm_forward

            return layer_norm_forward(self, x)
        return self.plain_forward(x)

    def plain_forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x32 - mean) * mul + self.bias).to(self.compute_dtype)


# flax's variance_scaling(1.0, "fan_in", "truncated_normal") divides the
# standard deviation by the std of a unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


class FlaxBatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` whose train-mode forward is flax's
    (flax/linen/normalization.py: one-pass variance clamped at 0, running
    stats updated with the biased variance).  On (B, C, L) input the
    statistics are over the batch and the length for each channel, as flax's
    BatchNorm reduces every axis but the features.  While ``update_stats``
    is False a train-mode forward leaves the running stats alone (the second
    generator passes of the GAN step, whose statistics flax discards).
    While ``sum_over`` is set (``batch_stats_over``: a data-parallel step)
    the train-mode statistics are over every rank's rows: the local float64
    sums (Σx, Σx², count) go through ``sum_over``, a differentiable sum over
    ranks, so the normalisation, its backward and the running stats see the
    global batch, as the JAX package's one global program does."""

    update_stats: bool = True
    compute_dtype: torch.dtype | None = None
    sum_over: Callable[[torch.Tensor], torch.Tensor] | None = None
    tp = None       # set by parallel/tensor.py on a model split over a model axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self._forward(x)
        from ..parallel.tensor import batch_norm_input

        return self.tp.finish(self._forward(batch_norm_input(self, x)))

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        shape = (1, -1) if x.dim() == 2 else (1, -1, 1)
        weight, bias = self.weight.view(shape), self.bias.view(shape)
        if not self.training:
            if dt is None:
                return super().forward(x)
            mul = torch.rsqrt(self.running_var.view(shape) + self.eps) * weight
            return ((x.float() - self.running_mean.view(shape)) * mul + bias).to(dt)
        # the sums over the batch in float64, as the training kernel and its
        # plain version take them: E[x²] − E[x]² cancels
        dims = (0,) if x.dim() == 2 else (0, 2)
        stat = x.dtype if dt is None else torch.float32
        xd = x.double()
        if self.sum_over is None:
            mean_d, sq_d = xd.mean(dim=dims), (xd * xd).mean(dim=dims)
        else:
            c = x.shape[1]
            sums = self.sum_over(torch.cat([xd.sum(dim=dims), (xd * xd).sum(dim=dims),
                                            xd.new_full((1,), x.numel() / c)]))
            mean_d, sq_d = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
        var = torch.clamp(sq_d - mean_d * mean_d, min=0.0).to(stat)
        mean = mean_d.to(stat)
        if self.update_stats:
            with torch.no_grad():
                keep = 1.0 - self.momentum
                self.running_mean.mul_(keep).add_(self.momentum * mean)
                self.running_var.mul_(keep).add_(self.momentum * var)
                self.num_batches_tracked += 1
        mean, var = mean.view(shape), var.view(shape)
        if dt is not None:
            mul = torch.rsqrt(var + self.eps) * weight
            return ((x.float() - mean) * mul + bias).to(dt)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * weight + bias


class ChannelLayerNorm(FlaxLayerNorm):
    """``FlaxLayerNorm`` over the channels of a (B, C, L) tensor: flax's
    LayerNorm on the JAX package's channels-last layout."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` with flax's ``Conv(padding="SAME")`` for odd widths
    (k // 2 on each side) and ``dtype`` semantics: under a compute dtype
    the input, kernel and bias are cast to it.  flax's kernel is (width,
    in, out), torch's weight (out, in, width) (``interop.py``)."""

    def __init__(self, in_channels: int, out_channels: int, width: int,
                 compute_dtype: torch.dtype | None = None):
        if width % 2 != 1:
            raise ValueError(f"SAME padding is symmetric only for odd widths, not {width}")
        super().__init__(in_channels, out_channels, width, padding=width // 2)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralDense(Dense):
    """flax's ``SpectralNorm(Dense)`` (flax 0.12.3
    ``SpectralNorm._spectral_normalize``), not torch's ``spectral_norm``.

    Every call, in eval mode too, runs one power iteration from the stored
    ``u`` (1, out) on the kernel W = weight.T (in, out): v = l2n(u Wᵀ),
    u' = l2n(v W), l2n(x) = x · rsqrt(Σx² + 1e-12); σ = v W u'ᵀ with u', v
    gradient-stopped, and the kernel is divided by σ (by 1 when σ = 0).  The
    bias is not normalised.  ``u`` and ``sigma`` (the buffers, flax's
    ``batch_stats``) take u' and σ only in train mode while
    ``update_stats`` is set (``frozen_batch_stats`` clears it)."""

    update_stats: bool = True

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype | None = None, eps: float = 1e-12):
        super().__init__(in_features, out_features, compute_dtype)
        self.eps = eps
        self.register_buffer("u", torch.ones(1, out_features))
        self.register_buffer("sigma", torch.ones(()))

    def normalized_weight(self) -> torch.Tensor:
        w = self.weight                                   # (out, in) = Wᵀ
        with torch.no_grad():
            v = _l2_normalize(self.u @ w, self.eps)       # (1, in)
            u = _l2_normalize(v @ w.t(), self.eps)        # (1, out)
        sigma = (v @ w.t() @ u.t())[0, 0]
        if self.training and self.update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, dt = self.normalized_weight(), self.compute_dtype
        if dt is None:
            return F.linear(x, w, self.bias)
        return torch.matmul(x.to(dt), w.to(dt).t()) + self.bias.to(dt)


# A dropout mask provider: (layer index in the model, mask shape, rate,
# device) -> float32 factors of that shape (1/keep where kept, else 0).
MaskFn = Callable[[int, tuple, float, torch.device], torch.Tensor]


class Dropout(nn.Dropout):
    """``nn.Dropout`` with flax's semantics for a provider's masks.

    In train mode with a provider set (``dropout_masks``) the output is
    ``x * masks(layer, shape, p, device)``, where ``shape`` is x's with the
    ``shared_dims`` set to 1 (flax's ``broadcast_dims``; (0, 1) for
    attention weights, flax's ``broadcast_dropout``).  Eval mode and rate 0
    pass x through; train mode without a provider is torch's dropout."""

    tp = None       # set by parallel/tensor.py on a model split over a model axis

    def __init__(self, p: float, shared_dims: Sequence[int] = ()):
        super().__init__(p)
        self.shared_dims = tuple(shared_dims)
        self.masks: Callable[[tuple, float, torch.device], torch.Tensor] | None = None

    def mask_shape(self, x: torch.Tensor) -> tuple:
        return tuple(1 if d in self.shared_dims else n for d, n in enumerate(x.shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._drop(x)
        return y if self.tp is None else self.tp.finish(y)

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.masks is None:
            if self.shared_dims:
                raise RuntimeError("a shared-mask Dropout in train mode needs a provider "
                                   "(dropout_masks)")
            return super().forward(x)
        if self.tp is not None:
            from ..parallel.tensor import SHARD, dropout_mask

            if self.tp.x_state == SHARD:
                return x * dropout_mask(self, self.mask_shape(x), x.device).to(x.dtype)
        return x * self.masks(self.mask_shape(x), self.p, x.device).to(x.dtype)


def dropout_layers(module: nn.Module) -> list[nn.Dropout]:
    """``module``'s dropout layers in registration order, which is the
    order its forward runs them: the index a mask provider is given."""
    return [m for m in module.modules() if isinstance(m, nn.Dropout)]


def has_dropout(module: nn.Module) -> bool:
    """Whether a train-mode forward of ``module`` draws any mask."""
    return any(m.p > 0.0 for m in dropout_layers(module))


@contextlib.contextmanager
def dropout_masks(module: nn.Module, masks: MaskFn):
    """Inside the block ``module``'s train-mode dropout takes its masks from
    ``masks`` (layer index first), never from torch's generator."""
    layers = dropout_layers(module)
    for i, m in enumerate(layers):
        if not isinstance(m, Dropout):
            raise TypeError(f"dropout layer {i} is a plain nn.Dropout: build it as "
                            "models.blocks.Dropout")
        m.masks = functools.partial(masks, i)
    try:
        yield module
    finally:
        for m in layers:
            m.masks = None


def bf16_twin(module: nn.Module, round_params: bool = False) -> nn.Module:
    """A copy of ``module`` whose layers compute in bfloat16 (flax's
    ``dtype=bfloat16`` semantics above): the model the registry builds with
    ``compute_dtype="bfloat16"``, holding ``module``'s weights and stats.
    With ``round_params`` every floating parameter and buffer is also
    rounded to bfloat16 once (kept in float32), as the JAX package does
    where it casts the variables themselves (screening)."""
    twin = copy.deepcopy(module)
    for m in twin.modules():
        if isinstance(m, (Dense, Conv1d, FlaxLayerNorm, FlaxBatchNorm1d)):
            m.compute_dtype = torch.bfloat16
    if round_params:
        with torch.no_grad():
            for t in [*twin.parameters(), *twin.buffers()]:
                if t.is_floating_point():
                    t.copy_(t.to(torch.bfloat16).to(t.dtype))
    return twin


@contextlib.contextmanager
def frozen_batch_stats(module: nn.Module):
    """Train-mode forwards inside the block do not update ``module``'s
    ``batch_stats``: its BatchNorm running stats and spectral norm's ``u``
    and ``sigma`` (flax keeps both in that collection)."""
    norms = [m for m in module.modules() if isinstance(m, (FlaxBatchNorm1d, SpectralDense))]
    before = [m.update_stats for m in norms]
    for m in norms:
        m.update_stats = False
    try:
        yield module
    finally:
        for m, b in zip(norms, before):
            m.update_stats = b


@contextlib.contextmanager
def batch_stats_over(sum_fn: Callable[[torch.Tensor], torch.Tensor], *modules: nn.Module):
    """Inside the block the train-mode BatchNorm statistics of ``modules``
    are over every rank's rows, through ``sum_fn`` (``parallel/mesh.py:
    BatchShard.sum``)."""
    norms = [m for module in modules for m in module.modules()
             if isinstance(m, FlaxBatchNorm1d)]
    for m in norms:
        m.sum_over = sum_fn
    try:
        yield
    finally:
        for m in norms:
            m.sum_over = None


def mlp_block(
    in_features: int,
    features: int,
    norm: str = "layer",
    act: str = "leaky_relu",
    leaky_slope: float = 0.2,
    dropout_rate: float | None = None,
    compute_dtype: torch.dtype | None = None,
) -> list[nn.Module]:
    """Dense -> norm (batch|layer|none) -> act (relu|leaky_relu|none)
    -> dropout.  The dropout layer is there whenever ``dropout_rate`` is a
    number, 0.0 included, so a model's state_dict indices do not depend on
    the rate."""
    layers: list[nn.Module] = [Dense(in_features, features, compute_dtype)]
    if norm == "batch":
        bn = FlaxBatchNorm1d(features, eps=BATCH_NORM_EPS, momentum=BATCH_NORM_MOMENTUM)
        bn.compute_dtype = compute_dtype
        layers.append(bn)
    elif norm == "layer":
        layers.append(FlaxLayerNorm(features, LAYER_NORM_EPS, compute_dtype))
    elif norm != "none":
        raise ValueError(f"unknown norm: {norm!r}")
    if act == "relu":
        layers.append(nn.ReLU())
    elif act == "leaky_relu":
        layers.append(nn.LeakyReLU(leaky_slope))
    elif act != "none":
        raise ValueError(f"unknown activation: {act!r}")
    if dropout_rate is not None:
        layers.append(Dropout(dropout_rate))
    return layers


class FlaxMapped(nn.Module):
    """A model that records, as it builds, which of its layers is which flax
    module of the JAX package's model: ``interop.py`` reads the pairs back as
    a layer map ((torch prefix, flax path, kind), ``flax_layer_map``)."""

    def __init__(self):
        super().__init__()
        self._flax: list = []

    def _pair(self, layer: nn.Module, path: str, kind: str | None = None) -> nn.Module:
        if kind is None:
            kind = {FlaxBatchNorm1d: "batchnorm", FlaxLayerNorm: "layernorm",
                    ChannelLayerNorm: "layernorm", Conv1d: "conv", Dense: "linear",
                    SpectralDense: "spectral"}[type(layer)]
        self._flax.append((layer, path, kind))
        return layer

    def _pair_block(self, layers: Sequence[nn.Module], path: str) -> list[nn.Module]:
        """An ``mlp_block``'s Dense and norm as flax's MLPBlock at ``path``."""
        for layer in layers:
            if isinstance(layer, Dense):
                self._pair(layer, f"{path}/Dense_0")
            elif isinstance(layer, FlaxBatchNorm1d):
                self._pair(layer, f"{path}/NormAct_0/BatchNorm_0")
            elif isinstance(layer, FlaxLayerNorm):
                self._pair(layer, f"{path}/NormAct_0/LayerNorm_0")
        return list(layers)

    def _pair_child(self, child: "FlaxMapped", path: str) -> nn.Module:
        for layer, sub, kind in child._flax:
            self._pair(layer, f"{path}/{sub}" if path else sub, kind)
        return child

    def flax_layer_map(self) -> list[tuple[str, str, str]]:
        names = {id(m): n for n, m in self.named_modules()}
        return [(names[id(layer)], path, kind) for layer, path, kind in self._flax]


def _norm_layer(norm: str, features: int, dt, channels: bool = False) -> list[nn.Module]:
    if norm == "batch":
        bn = FlaxBatchNorm1d(features, eps=BATCH_NORM_EPS, momentum=BATCH_NORM_MOMENTUM)
        bn.compute_dtype = dt
        return [bn]
    if norm == "layer":
        return [(ChannelLayerNorm if channels else FlaxLayerNorm)(features, LAYER_NORM_EPS, dt)]
    if norm != "none":
        raise ValueError(f"unknown norm: {norm!r}")
    return []


def _act_layer(act: str, leaky_slope: float) -> list[nn.Module]:
    if act == "relu":
        return [nn.ReLU()]
    if act == "leaky_relu":
        return [nn.LeakyReLU(leaky_slope)]
    if act != "none":
        raise ValueError(f"unknown activation: {act!r}")
    return []


class ResidualBlock(FlaxMapped):
    """Dense -> norm -> ReLU -> Dropout(0.2) -> Dense -> norm, plus the skip,
    ReLU after the add (``pigan_thz_tpu/models/blocks.py:ResidualBlock``)."""

    def __init__(self, features: int, dropout_rate: float = 0.2, norm: str = "batch",
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        d1, d2 = Dense(features, features, compute_dtype), Dense(features, features,
                                                                 compute_dtype)
        n1, n2 = _norm_layer(norm, features, compute_dtype), _norm_layer(
            norm, features, compute_dtype)
        self.body = nn.Sequential(d1, *n1, nn.ReLU(), Dropout(dropout_rate), d2, *n2)
        kind = {"batch": "BatchNorm_0", "layer": "LayerNorm_0"}.get(norm)
        self._pair(d1, "Dense_0")
        self._pair(d2, "Dense_1")
        for i, n in enumerate((n1, n2)):
            if n:
                self._pair(n[0], f"NormAct_{i}/{kind}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x + self.body(x))


class ConvStack1D(FlaxMapped):
    """The conv pyramid of the enhanced models
    (``pigan_thz_tpu/models/blocks.py:ConvStack1D``): channels 1 -> 64 ->
    128 -> 256, widths 7 / 5 / 3 with SAME padding, norm and activation
    after each conv, a max-pool of 2 (VALID, so 250 -> 125 -> 62) between
    stages, then an adaptive average pool to ``pool_to`` tokens.  torch's
    ``AdaptiveAvgPool1d`` has the bins of the JAX package's pooling matrix
    (floor(i·L/n) to ceil((i+1)·L/n)).  (B, L) in, (B, pool_to, C) out."""

    def __init__(self, channels: Sequence[int] = (64, 128, 256),
                 widths: Sequence[int] = (7, 5, 3), pool_to: int = 32, norm: str = "batch",
                 act: str = "relu", leaky_slope: float = 0.2,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        layers: list[nn.Module] = []
        c_in, n = 1, len(channels)
        for i, (ch, k) in enumerate(zip(channels, widths)):
            conv = self._pair(Conv1d(c_in, ch, k, compute_dtype), f"Conv_{i}")
            norm_layers = _norm_layer(norm, ch, compute_dtype, channels=True)
            for layer in norm_layers:
                kind = "BatchNorm_0" if norm == "batch" else "LayerNorm_0"
                self._pair(layer, f"NormAct_{i}/{kind}")
            layers += [conv, *norm_layers, *_act_layer(act, leaky_slope)]
            if i < n - 1:
                layers.append(nn.MaxPool1d(2, 2))
            c_in = ch
        self.convs = nn.Sequential(*layers)
        self.pool = nn.AdaptiveAvgPool1d(pool_to)
        self.channels = c_in

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.convs(x.reshape(x.shape[0], 1, -1))
        return self.pool(h).transpose(1, 2)


class SelfAttention(FlaxMapped):
    """Self-attention with the semantics of flax's
    ``MultiHeadDotProductAttention(num_heads, dropout_rate)(x, x)``, written
    as tensor code: q, k, v projections of ``features`` -> (heads,
    features / heads), q scaled by 1/√head_dim, softmax over the keys,
    dropout on the weights (one (Q, K) mask for the batch and the heads:
    flax's ``broadcast_dropout``), then the output projection.  The four
    projections are ``Dense`` (out, in) layers; ``interop.py`` reshapes
    flax's (in, heads, head_dim) / (heads, head_dim, out) kernels."""

    def __init__(self, features: int, num_heads: int = 8, dropout_rate: float = 0.1,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"{features} features do not split into {num_heads} heads")
        self.num_heads, self.head_dim = num_heads, features // num_heads
        self.query, self.key, self.value, self.out = (
            Dense(features, features, compute_dtype) for _ in range(4))
        self.dropout = Dropout(dropout_rate, shared_dims=(0, 1))
        for name in ("query", "key", "value"):
            self._pair(getattr(self, name), f"MultiHeadDotProductAttention_0/{name}",
                       "attn_in")
        self._pair(self.out, "MultiHeadDotProductAttention_0/out", "attn_out")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        h, d = self.num_heads, self.head_dim
        q = self.query(x).view(b, n, h, d) / math.sqrt(d)
        k = self.key(x).view(b, n, h, d)
        v = self.value(x).view(b, n, h, d)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        w = self.dropout(w)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, n, h * d))


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise ``module`` in place the way flax initialises the JAX
    package's models; draws come from ``generator`` (a CPU generator for a
    module on the CPU)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            fan_in = m.weight[0].numel()      # in, or in_channels x width
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(
                m.weight, std=std, a=-2.0 * std, b=2.0 * std, generator=generator
            )
            nn.init.zeros_(m.bias)
            if isinstance(m, SpectralDense):
                m.u.copy_(torch.randn(m.u.shape, generator=generator))
                m.sigma.fill_(1.0)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            if isinstance(m, nn.BatchNorm1d):
                m.reset_running_stats()
    return module
