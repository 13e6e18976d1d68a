from . import fused_kernels, losses, peaks

__all__ = ["fused_kernels", "losses", "peaks"]
