"""F's stage's share of its roofline (K5)."""

from benchmark.metrics.stage_roofline import share


def read(run):
    return share(run, "fwd")
