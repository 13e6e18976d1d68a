from .screening import (
    METRIC_INDEX,
    ScreeningConfig,
    ScreeningResult,
    screen_chunk,
    screen_designs,
    screening_throughput,
)

__all__ = [
    "METRIC_INDEX",
    "ScreeningConfig",
    "ScreeningResult",
    "screen_chunk",
    "screen_designs",
    "screening_throughput",
]
