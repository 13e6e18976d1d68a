"""G's stage's share of its roofline (K6 in the base designer, G's modules
in the enhanced one)."""

from benchmark.metrics.stage_roofline import share


def read(run):
    return share(run, "gen")
