from . import fused_kernels, peaks

__all__ = ["fused_kernels", "peaks"]
