"""Profiling: a trace of a region, the program's own spans and counters,
and warm-up-aware step timing.

The port of ``pigan_thz_tpu/utils/profiling.py`` on ``torch.profiler``:
- ``trace(log_dir)`` records the enclosed region (CPU activity, and CUDA
  activity where there is a card) and writes it as a Chrome trace,
  ``<log_dir>/trace.json``, which Perfetto or ``chrome://tracing`` opens;
- ``span(name, **attrs)`` and ``count(name, n)`` record the program's
  phases and counts in memory (``snapshot()``, ``reset()``), each span also
  as a ``record_function`` range on the profiler's timeline, on the clock
  of the kernels it enqueues;
- ``StepTimer`` measures steady-state steps/s with an explicit warm-up, and
  synchronises the device of each result it is given, so that the build and
  the enqueue never count as work;
- ``device_memory_stats`` reports each card's bytes in use and at peak.

Spans and counters record only while a ``torch.profiler`` session runs or
inside ``recording()``; otherwise a span site costs one flag check (``on()``)
and reads no clock.  A span is kept only if it was on at both its start and
its end, so a traced segment that starts or stops inside a span leaves no
part of it.  The spans of one chunk or one request share an ``id``: a span
takes its parent's, a root span a new one, or with ``follows=True`` that of
the root span closed last on its thread (the bookkeeping after a chunk, a
request's F stage after its G stage).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, List

import torch
import torch.autograd.profiler as _autograd_profiler

TRACE_FILE = "trace.json"
HOST_SYNCS = "host_syncs"     # the counter of device-to-host reads on the chunk path
GRAPH_CAPTURES = "serve_graph_captures"   # CUDA graphs a serving stage captured
GRAPH_REPLAYS = "serve_graph_replays"     # and its calls that replayed one
RECENT_SPANS = 4096           # raw spans kept, newest last


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


class _Store:
    """What the spans and counters recorded: per-name aggregates, the most
    recent raw spans and the counters."""

    def __init__(self):
        self.lock = threading.Lock()
        self.recording = 0            # open recording() contexts, every thread's
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.clear()

    def clear(self) -> None:
        with self.lock:
            self.spans: dict = {}     # name -> [count, total ns, self ns, {attr: sum}]
            self.recent: deque = deque(maxlen=RECENT_SPANS)
            self.counters: dict = {}

    def stack(self) -> list:
        local = self.local
        if not hasattr(local, "stack"):
            local.stack, local.last_root = [], 0
        return local.stack


_STORE = _Store()


def on() -> bool:
    """Whether spans and counters record now: a ``torch.profiler`` session
    runs, or a ``recording()`` context is open."""
    return _autograd_profiler._is_profiler_enabled or _STORE.recording > 0


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block without a profiler (no
    ``record_function`` ranges then)."""
    with _STORE.lock:
        _STORE.recording += 1
    try:
        yield
    finally:
        with _STORE.lock:
            _STORE.recording -= 1


class _Off:
    """The span of a site while nothing records: enters and exits only."""

    on = False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    """The span of a site while ``on()``: see ``span``."""

    on = True

    def __init__(self, name: str, attrs: dict, follows: bool):
        self.name, self.attrs, self.follows = name, attrs, follows
        self.child_ns = 0

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span (a count of work)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _STORE.stack()
        self.parent = stack[-1] if stack else None
        if self.parent is not None:
            self.id = self.parent.id
        elif self.follows:
            self.id = _STORE.local.last_root
        else:
            self.id = next(_STORE.ids)
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end_ns = time.perf_counter_ns()
        stack = _STORE.stack()
        stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.parent is None:
            _STORE.local.last_root = self.id
        if not on():
            return None                     # cut by the end of a traced segment
        dur = end_ns - self.start_ns
        if self.parent is not None:
            self.parent.child_ns += dur
        with _STORE.lock:
            agg = _STORE.spans.setdefault(self.name, [0, 0, 0, {}])
            agg[0] += 1
            agg[1] += dur
            agg[2] += dur - self.child_ns
            for k, v in self.attrs.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    agg[3][k] = agg[3].get(k, 0) + v
            _STORE.recent.append({
                "name": self.name, "start_ns": self.start_ns, "end_ns": end_ns,
                "parent": None if self.parent is None else self.parent.name,
                "id": self.id, "attrs": dict(self.attrs)})
        return None


def span(name: str, *, follows: bool = False, **attrs):
    """A context manager that records the enclosed block as span ``name``
    with ``attrs`` while ``on()``; ``.set(**attrs)`` adds attributes inside
    it and ``.on`` says whether it records.  ``follows``: a root span takes
    the id of the root span closed last on its thread."""
    if not on():
        return _OFF
    return _Span(name, attrs, follows)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while ``on()``."""
    if on():
        with _STORE.lock:
            _STORE.counters[name] = _STORE.counters.get(name, 0) + n


def host_bool(t: torch.Tensor) -> bool:
    """``bool(t)`` of a one-element tensor: one device-to-host read, counted
    under ``host_syncs``."""
    count(HOST_SYNCS)
    return bool(t)


def snapshot() -> dict:
    """What was recorded since the last ``reset()``: ``spans`` {name:
    {"count", "total_s", "self_s" (the time no child span covers), "attrs"
    (sums of the numeric attributes)}}, ``recent`` (the newest raw spans:
    name, start_ns, end_ns on ``time.perf_counter_ns``, parent, id, attrs)
    and ``counters`` {name: total}."""
    with _STORE.lock:
        spans = {name: {"count": c, "total_s": total * 1e-9, "self_s": own * 1e-9,
                        "attrs": dict(attrs)}
                 for name, (c, total, own, attrs) in _STORE.spans.items()}
        return {"spans": spans, "recent": [dict(r) for r in _STORE.recent],
                "counters": dict(_STORE.counters)}


def reset() -> None:
    """Forget every span and counter recorded so far."""
    _STORE.clear()


def span_table(snap: dict) -> str:
    """The spans and counters of a ``snapshot()`` as a text table: per span
    name its count, total, self and mean host ms; then each counter."""
    lines = [f"{'span':<26} {'count':>7} {'total ms':>11} {'self ms':>11} {'mean ms':>10}"]
    for name, a in sorted(snap["spans"].items(), key=lambda kv: -kv[1]["total_s"]):
        lines.append(f"{name:<26} {a['count']:>7} {a['total_s'] * 1e3:>11.3f} "
                     f"{a['self_s'] * 1e3:>11.3f} {a['total_s'] * 1e3 / a['count']:>10.4f}")
    if len(lines) == 1:
        lines.append("(no span recorded)")
    counters = snap["counters"]
    lines.append("counters: " + (", ".join(f"{k} {v}" for k, v in sorted(counters.items()))
                                 or "none"))
    return "\n".join(lines)


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
