"""Shared building blocks for the port's model zoo (torch.nn).

``mlp_block`` is the Dense -> norm -> activation -> dropout motif of
``pigan_thz_tpu/models/blocks.py:MLPBlock``, returned as a flat list of
layers so that the models' ``nn.Sequential`` carries the reference's torch
state_dict layout (``main.0`` / ``model.0`` ... ; ``interop.py``).

Norm constants are flax's, not torch's defaults:
- LayerNorm eps 1e-6 (flax default; torch's is 1e-5);
- BatchNorm eps 1e-5, torch momentum 0.1 == flax momentum 0.9.
  flax updates the running variance with the biased batch variance and
  torch with the unbiased one; that matters only to the GAN training step
  (G's BatchNorms), which the port does not have yet.

``flax_init_`` reproduces flax's initialisers (truncated lecun_normal
kernels, zero biases, unit norm scales, BatchNorm stats 0 / 1), drawing
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

LAYER_NORM_EPS = 1e-6
BATCH_NORM_EPS = 1e-5
BATCH_NORM_MOMENTUM = 0.1

# flax's variance_scaling(1.0, "fan_in", "truncated_normal") divides the
# standard deviation by the std of a unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def mlp_block(
    in_features: int,
    features: int,
    norm: str = "layer",
    act: str = "leaky_relu",
    leaky_slope: float = 0.2,
    dropout_rate: float | None = None,
) -> list[nn.Module]:
    """Dense -> norm (batch|layer|none) -> act (relu|leaky_relu|none)
    -> dropout.  The dropout layer is there whenever ``dropout_rate`` is a
    number, 0.0 included, so a model's state_dict indices do not depend on
    the rate."""
    layers: list[nn.Module] = [nn.Linear(in_features, features)]
    if norm == "batch":
        layers.append(
            nn.BatchNorm1d(features, eps=BATCH_NORM_EPS, momentum=BATCH_NORM_MOMENTUM)
        )
    elif norm == "layer":
        layers.append(nn.LayerNorm(features, eps=LAYER_NORM_EPS))
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
