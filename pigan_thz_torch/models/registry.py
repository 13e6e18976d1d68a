"""Model registry: config name -> torch module, built and initialised.

The counterpart of ``pigan_thz_tpu/models/registry.py`` for the variants
the port has.  Modules are built on the CPU, initialised with flax's scheme
from ``generator`` (torch's global generator when None), so one seed gives
the same weights on every device, then moved to ``device``, which every
build function takes as a required keyword.  ``dtype`` is the compute dtype
(``models/blocks.py``); ``build_trio`` reads it from ``train.compute_dtype``,
as the JAX package's does.
"""

from __future__ import annotations

import torch

from ..config import DiscriminatorConfig, ForwardModelConfig, GeneratorConfig, PiGanConfig
from .blocks import flax_init_
from .discriminator import MLPDiscriminator
from .forward_model import ForwardMLP
from .generator import MLPGenerator

# Variants of the JAX package that the port does not have yet, with the
# ROADMAP.md item that brings them.
_NOT_PORTED = {
    "conv_attn": "queue 1, item 15 (enhanced variants)",
    "residual": "queue 1, item 15 (enhanced variants)",
    "branched": "queue 1, item 15 (enhanced variants)",
    "physics": "queue 1, item 15 (enhanced variants)",
    "uncertainty": "queue 1, item 15 (enhanced variants)",
    "dual_encoder": "queue 1, item 15 (enhanced variants)",
    "conv": "queue 1, item 15 (enhanced variants)",
    "multi_scale": "queue 1, item 15 (enhanced variants)",
}


def _check_ported(kind: str, name: str) -> None:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{kind} {name!r} is not ported yet: ROADMAP.md {_NOT_PORTED[name]}"
        )
    if name != "mlp":
        raise ValueError(f"unknown {kind}: {name!r}")


def build_generator(
    cfg: GeneratorConfig,
    spectrum_dim: int = 250,
    param_dim: int = 4,
    *,
    device: torch.device | str,
    generator: torch.Generator | None = None,
    dtype: str = "float32",
) -> MLPGenerator:
    _check_ported("generator", cfg.name)
    g = MLPGenerator(
        input_dim=spectrum_dim, output_dim=param_dim,
        hidden_dims=tuple(cfg.hidden_dims), norm=cfg.norm, compute_dtype=dtype,
    )
    return flax_init_(g, generator).to(device)


def build_discriminator(
    cfg: DiscriminatorConfig,
    spectrum_dim: int = 250,
    param_dim: int = 4,
    *,
    device: torch.device | str,
    generator: torch.Generator | None = None,
    dtype: str = "float32",
) -> MLPDiscriminator:
    _check_ported("discriminator", cfg.name)
    d = MLPDiscriminator(
        spectrum_dim=spectrum_dim, param_dim=param_dim,
        hidden_dims=tuple(cfg.hidden_dims), leaky_slope=cfg.leaky_slope,
        compute_dtype=dtype,
    )
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
) -> ForwardMLP:
    _check_ported("forward model", cfg.name)
    f = ForwardMLP(
        param_dim=param_dim, spectrum_dim=spectrum_dim, metrics_dim=metrics_dim,
        hidden_dims=tuple(cfg.hidden_dims), dropout_rate=cfg.dropout_rate,
        leaky_slope=cfg.leaky_slope, compute_dtype=dtype,
    )
    return flax_init_(f, generator).to(device)


def build_trio(
    cfg: PiGanConfig,
    *,
    device: torch.device | str,
    generator: torch.Generator | None = None,
) -> tuple[MLPGenerator, MLPDiscriminator, ForwardMLP]:
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
