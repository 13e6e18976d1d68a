"""Profiling: a trace of a region and warm-up-aware step timing.

The port of ``pigan_thz_tpu/utils/profiling.py`` on ``torch.profiler``:
- ``trace(log_dir)`` records the enclosed region (CPU activity, and CUDA
  activity where there is a card) and writes it as a Chrome trace,
  ``<log_dir>/trace.json``, which Perfetto or ``chrome://tracing`` opens;
- ``StepTimer`` measures steady-state steps/s with an explicit warm-up, and
  synchronises the device of each result it is given, so that the build and
  the enqueue never count as work;
- ``device_memory_stats`` reports each card's bytes in use and at peak.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Any, List

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the enclosed region with ``torch.profiler`` and write
    ``<log_dir>/trace.json``; yields the profiler (``key_averages()`` for
    sums by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _cuda_devices(result: Any) -> set:
    """The CUDA devices of the tensors in ``result`` (nested dicts,
    lists and tuples)."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.is_cuda else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        return set().union(*(_cuda_devices(r) for r in result)) if result else set()
    return set()


@dataclass
class StepTimer:
    """Warm-up-aware throughput timer.

    >>> timer = StepTimer(warmup=2)
    >>> for i in range(10):
    ...     out = step(...)
    ...     timer.tick(out)
    >>> timer.steps_per_sec()
    """

    warmup: int = 2
    _count: int = 0
    _t0: float | None = None
    _laps: List[float] = field(default_factory=list)

    def tick(self, result: Any = None) -> None:
        for device in _cuda_devices(result):
            torch.cuda.synchronize(device)
        self._count += 1
        now = time.perf_counter()
        if self._t0 is None:
            # warmup <= 1 anchors on the first tick (no start time before
            # the first step exists), so warmup=0 measures from step 2 as
            # warmup=1 does
            if self._count >= max(1, self.warmup):
                self._t0 = now
        else:
            self._laps.append(now)

    def steps_per_sec(self) -> float:
        if not self._laps or self._t0 is None:
            return float("nan")
        return len(self._laps) / (self._laps[-1] - self._t0)

    def mean_step_ms(self) -> float:
        sps = self.steps_per_sec()
        return 1000.0 / sps if sps == sps and sps > 0 else float("nan")


def device_memory_stats() -> dict:
    """{"cuda:i": {"bytes_in_use", "peak_bytes_in_use"}} for each card
    (PyTorch's caching allocator: bytes allocated to tensors now and at
    peak); empty without a card."""
    out = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0)}
    return out
