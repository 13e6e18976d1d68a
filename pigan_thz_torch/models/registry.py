"""Model registry: config name -> torch module, built and initialised.

The counterpart of ``pigan_thz_tpu/models/registry.py``: the same eleven
names, each built from the same config fields.  Modules are built on the
CPU, initialised with flax's scheme from ``generator`` (torch's global
generator when None), so one seed gives the same weights on every device,
then moved to ``device``, which every build function takes as a required
keyword.  ``dtype`` is the compute dtype (``models/blocks.py``);
``build_trio`` reads it from ``train.compute_dtype``, as the JAX package's
does.  An unknown name raises ``ValueError``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import DiscriminatorConfig, ForwardModelConfig, GeneratorConfig, PiGanConfig
from .blocks import flax_init_
from .discriminator import (
    ConvDiscriminator,
    DualEncoderDiscriminator,
    MLPDiscriminator,
    MultiScaleDiscriminator,
)
from .forward_model import (
    BranchedForwardModel,
    ForwardMLP,
    PhysicsForwardModel,
    UncertaintyForwardModel,
)
from .generator import ConvAttnGenerator, MLPGenerator, ResidualGenerator


def build_generator(
    cfg: GeneratorConfig,
    spectrum_dim: int = 250,
    param_dim: int = 4,
    *,
    device: torch.device | str,
    generator: torch.Generator | None = None,
    dtype: str = "float32",
) -> nn.Module:
    common = dict(input_dim=spectrum_dim, output_dim=param_dim, norm=cfg.norm,
                  compute_dtype=dtype)
    if cfg.name == "mlp":
        g = MLPGenerator(hidden_dims=tuple(cfg.hidden_dims), **common)
    elif cfg.name == "conv_attn":
        g = ConvAttnGenerator(use_attention=cfg.use_attention, **common)
    elif cfg.name == "residual":
        g = ResidualGenerator(num_residual_blocks=cfg.num_residual_blocks, **common)
    else:
        raise ValueError(f"unknown generator: {cfg.name!r}")
    return flax_init_(g, generator).to(device)


def build_discriminator(
    cfg: DiscriminatorConfig,
    spectrum_dim: int = 250,
    param_dim: int = 4,
    *,
    device: torch.device | str,
    generator: torch.Generator | None = None,
    dtype: str = "float32",
) -> nn.Module:
    common = dict(spectrum_dim=spectrum_dim, param_dim=param_dim,
                  leaky_slope=cfg.leaky_slope, compute_dtype=dtype)
    if cfg.name == "mlp":
        d = MLPDiscriminator(hidden_dims=tuple(cfg.hidden_dims), **common)
    elif cfg.name == "dual_encoder":
        d = DualEncoderDiscriminator(use_spectral_norm=cfg.use_spectral_norm, **common)
    elif cfg.name == "conv":
        d = ConvDiscriminator(**common)
    elif cfg.name == "multi_scale":
        d = MultiScaleDiscriminator(use_spectral_norm=cfg.use_spectral_norm, **common)
    else:
        raise ValueError(f"unknown discriminator: {cfg.name!r}")
    return flax_init_(d, generator).to(device)


def build_forward_model(
    cfg: ForwardModelConfig,
    spectrum_dim: int = 250,
    metrics_dim: int = 8,
    param_dim: int = 4,
    *,
    device: torch.device | str,
    generator: torch.Generator | None = None,
    dtype: str = "float32",
) -> nn.Module:
    common = dict(param_dim=param_dim, spectrum_dim=spectrum_dim, metrics_dim=metrics_dim,
                  compute_dtype=dtype)
    if cfg.name == "mlp":
        f = ForwardMLP(hidden_dims=tuple(cfg.hidden_dims), dropout_rate=cfg.dropout_rate,
                       leaky_slope=cfg.leaky_slope, **common)
    elif cfg.name == "branched":
        f = BranchedForwardModel(**common)
    elif cfg.name == "physics":
        f = PhysicsForwardModel(**common)
    elif cfg.name == "uncertainty":
        f = UncertaintyForwardModel(**common)
    else:
        raise ValueError(f"unknown forward model: {cfg.name!r}")
    return flax_init_(f, generator).to(device)


def build_trio(
    cfg: PiGanConfig,
    *,
    device: torch.device | str,
    generator: torch.Generator | None = None,
) -> tuple[nn.Module, nn.Module, nn.Module]:
    """(generator, discriminator, forward_model) from the run config, drawn
    in that order from ``generator``, computing in ``train.compute_dtype``."""
    d, dt = cfg.data, cfg.train.compute_dtype
    return (
        build_generator(cfg.generator, d.spectrum_dim, d.param_dim, device=device,
                        generator=generator, dtype=dt),
        build_discriminator(cfg.discriminator, d.spectrum_dim, d.param_dim, device=device,
                            generator=generator, dtype=dt),
        build_forward_model(cfg.forward_model, d.spectrum_dim, d.metrics_dim, d.param_dim,
                            device=device, generator=generator, dtype=dt),
    )
