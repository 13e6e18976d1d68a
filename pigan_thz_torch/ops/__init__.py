from . import fused_kernels

__all__ = ["fused_kernels"]
