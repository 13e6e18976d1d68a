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
kernels, zero biases, unit norm scales, BatchNorm stats 0 / 1), drawing
from an explicit ``torch.Generator``.

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
import math

import torch
from torch import nn

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

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return torch.matmul(x.to(dt), self.weight.to(dt).t()) + self.bias.to(dt)


class FlaxLayerNorm(nn.LayerNorm):
    """``nn.LayerNorm``; under a compute dtype flax's LayerNorm(dtype=...):
    the one-pass variance max(0, E[x²] − E[x]²) and the normalisation in
    float32, the output in the compute dtype."""

    def __init__(self, features: int, eps: float, compute_dtype: torch.dtype | None = None):
        super().__init__(features, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
    stats updated with the biased variance).  While ``update_stats`` is
    False a train-mode forward leaves the running stats alone (the second
    generator passes of the GAN step, whose statistics flax discards)."""

    update_stats: bool = True
    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if not self.training:
            if dt is None:
                return super().forward(x)
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return ((x.float() - self.running_mean) * mul + self.bias).to(dt)
        # the sums over the batch in float64, as the training kernel and its
        # plain version take them: E[x²] − E[x]² cancels
        stat = x.dtype if dt is None else torch.float32
        xd = x.double()
        mean_d = xd.mean(dim=0)
        var = torch.clamp((xd * xd).mean(dim=0) - mean_d * mean_d, min=0.0).to(stat)
        mean = mean_d.to(stat)
        if self.update_stats:
            with torch.no_grad():
                keep = 1.0 - self.momentum
                self.running_mean.mul_(keep).add_(self.momentum * mean)
                self.running_var.mul_(keep).add_(self.momentum * var)
                self.num_batches_tracked += 1
        if dt is not None:
            mul = torch.rsqrt(var + self.eps) * self.weight
            return ((x.float() - mean) * mul + self.bias).to(dt)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


@contextlib.contextmanager
def frozen_batch_stats(module: nn.Module):
    """Train-mode forwards inside the block do not update ``module``'s
    BatchNorm running stats."""
    norms = [m for m in module.modules() if isinstance(m, FlaxBatchNorm1d)]
    before = [m.update_stats for m in norms]
    for m in norms:
        m.update_stats = False
    try:
        yield module
    finally:
        for m, b in zip(norms, before):
            m.update_stats = b


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
        layers.append(nn.Dropout(dropout_rate))
    return layers


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise ``module`` in place the way flax initialises the JAX
    package's models; draws come from ``generator`` (a CPU generator for a
    module on the CPU)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(
                m.weight, std=std, a=-2.0 * std, b=2.0 * std, generator=generator
            )
            nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            if isinstance(m, nn.BatchNorm1d):
                m.reset_running_stats()
    return module
