"""Optimiser steps completed in the window over the window's host time (a
member's step counts one)."""


def read(run):
    rec = run["record"]
    if "steps" not in rec or rec["window_s"] <= 0:
        return None
    return rec["steps"] / rec["window_s"]
