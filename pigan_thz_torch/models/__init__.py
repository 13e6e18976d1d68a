from .blocks import flax_init_, mlp_block
from .forward_model import ForwardMLP
from .generator import MLPGenerator
from .registry import build_forward_model, build_generator

__all__ = [
    "ForwardMLP",
    "MLPGenerator",
    "build_forward_model",
    "build_generator",
    "flax_init_",
    "mlp_block",
]
