from .blocks import FlaxBatchNorm1d, flax_init_, frozen_batch_stats, mlp_block
from .discriminator import MLPDiscriminator
from .forward_model import ForwardMLP
from .generator import MLPGenerator
from .registry import build_discriminator, build_forward_model, build_generator, build_trio

__all__ = [
    "FlaxBatchNorm1d",
    "ForwardMLP",
    "MLPDiscriminator",
    "MLPGenerator",
    "build_discriminator",
    "build_forward_model",
    "build_generator",
    "build_trio",
    "flax_init_",
    "frozen_batch_stats",
    "mlp_block",
]
