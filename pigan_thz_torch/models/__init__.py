from .blocks import (
    Dropout,
    FlaxBatchNorm1d,
    SpectralDense,
    dropout_masks,
    flax_init_,
    frozen_batch_stats,
    mlp_block,
)
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
from .registry import build_discriminator, build_forward_model, build_generator, build_trio

__all__ = [
    "BranchedForwardModel",
    "ConvAttnGenerator",
    "ConvDiscriminator",
    "Dropout",
    "DualEncoderDiscriminator",
    "FlaxBatchNorm1d",
    "ForwardMLP",
    "MLPDiscriminator",
    "MLPGenerator",
    "MultiScaleDiscriminator",
    "PhysicsForwardModel",
    "ResidualGenerator",
    "SpectralDense",
    "UncertaintyForwardModel",
    "build_discriminator",
    "build_forward_model",
    "build_generator",
    "build_trio",
    "dropout_masks",
    "flax_init_",
    "frozen_batch_stats",
    "mlp_block",
]
