from .inverse import DesignResult, InverseDesigner
from .screening import (
    METRIC_INDEX,
    ScreeningConfig,
    ScreeningResult,
    screen_chunk,
    screen_designs,
    screening_throughput,
)

__all__ = [
    "DesignResult",
    "InverseDesigner",
    "METRIC_INDEX",
    "ScreeningConfig",
    "ScreeningResult",
    "screen_chunk",
    "screen_designs",
    "screening_throughput",
]
