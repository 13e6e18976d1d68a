"""Latency arithmetic, over every request of a window: numpy's percentile
with linear interpolation between the two nearest ranks (a frozen copy of
``examples/torch_serving_bench.py``'s)."""

import numpy as np


def percentile(latencies_ms, q: float) -> float | None:
    if not latencies_ms:
        return None
    return float(np.percentile(np.asarray(latencies_ms, dtype=np.float64), q))
