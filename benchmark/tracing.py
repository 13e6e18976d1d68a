"""Traced segments of a run: ``torch.profiler`` over a bounded, synchronised
part of the window, read in memory and reduced to a few numbers.

A segment starts and ends with the device idle (the caller synchronises at
both ends), so its length on the host clock is the window the device
activity lies in.  What a segment keeps:

- ``window_s``: its length;
- ``busy_s``: the union of the intervals in which the device ran a kernel,
  a copy or a fill;
- ``kernels``: the number of device kernels;
- ``ranges``: for each ``record_function`` range named ``bench.*``, the
  device time of the kernels launched inside it (matched through the CUDA
  runtime call that launched them, by correlation id);
- ``by_kernel``: device seconds by kernel name;
- ``gaps``: idle seconds on the device, by what the host was doing then
  (the innermost host operation or range open in the middle of the gap).

No trace file is written.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

RANGE_PREFIX = "bench."


class Segment:
    """One traced segment: ``start()`` and ``stop()`` around device work
    that the caller synchronises at both ends."""

    def __init__(self, name: str):
        self.name = name
        self._prof = None
        self._t0 = self._outer = 0.0
        self.summary: dict | None = None
        self.outer_s = 0.0          # start() to the end of stop(): the tracer's cost too

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._outer = time.perf_counter()
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        window = time.perf_counter() - self._t0
        self._prof.stop()
        self.summary = summarize(self._prof.profiler.kineto_results.events(), window)
        self.summary["name"] = self.name
        self._prof = None
        self.outer_s = time.perf_counter() - self._outer


def _union(intervals: list) -> tuple[float, list]:
    """(total length, merged intervals) of (start, end) pairs."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _is_runtime(name: str) -> bool:
    """A CUDA runtime or driver call (a launch, a copy, a sync)."""
    return name.startswith("cuda") or name.startswith("cu")


def summarize(events, window_s: float) -> dict:
    device, host, ranges, launch_at, threads = [], [], [], {}, defaultdict(int)
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith(RANGE_PREFIX):
                continue
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), name,
                           e.correlation_id()))
            continue
        start, end, tid = e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id()
        threads[tid] += 1
        if name.startswith(RANGE_PREFIX):
            ranges.append((start, end, name, tid))
        else:
            host.append((start, end, name, tid))
            if _is_runtime(name) and e.correlation_id():
                launch_at[e.correlation_id()] = start
    busy_ns, merged = _union([(s, e) for s, e, _, _ in device])
    by_kernel: dict = defaultdict(float)
    for s, e, name, _ in device:
        by_kernel[name] += (e - s) * 1e-9
    per_range: dict = defaultdict(float)
    for s, e, _, corr in device:
        t = launch_at.get(corr)
        if t is None:
            continue
        for rs, re_, rname, _ in ranges:
            if rs <= t <= re_:
                per_range[rname] += (e - s) * 1e-9
    # idle gaps by what the main thread was doing: the innermost span open at
    # the gap's middle (the main thread's spans nest, so a stack finds it)
    main = max(threads, key=threads.get) if threads else None
    spans = sorted((s for s in host + ranges if s[3] == main), key=lambda s: (s[0], -s[1]))
    gaps: dict = defaultdict(float)
    stack: list = []
    i = 0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) / 2
        while i < len(spans) and spans[i][0] <= mid:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        gaps[stack[-1][2] if stack else "(no host operation)"] += (b - a) * 1e-9
    return {"window_s": window_s, "busy_s": busy_ns * 1e-9, "kernels": len(device),
            "ranges": dict(per_range), "by_kernel": dict(by_kernel), "gaps": dict(gaps)}


def merge(summaries: list) -> dict | None:
    """The segments of a run as one: sums of their numbers."""
    if not summaries:
        return None
    out = {"window_s": 0.0, "busy_s": 0.0, "kernels": 0,
           "ranges": defaultdict(float), "by_kernel": defaultdict(float),
           "gaps": defaultdict(float), "segments": {}}
    for s in summaries:
        for k in ("window_s", "busy_s", "kernels"):
            out[k] += s[k]
        for k in ("ranges", "by_kernel", "gaps"):
            for name, v in s[k].items():
                out[k][name] += v
        out["segments"][s["name"]] = s
    for k in ("ranges", "by_kernel", "gaps"):
        out[k] = dict(out[k])
    return out


def breakdown(trace: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten largest idle totals by host operation."""
    def top(d):
        return [[name, v] for name, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(trace["by_kernel"]), "idle_gaps": top(trace["gaps"])}
