"""The 95th percentile of the latencies of every request in the window
(device clock: an event before the call, one after it)."""

from benchmark.metrics.latency import percentile


def read(run):
    return percentile(run["record"].get("latencies_ms"), 95)
