"""Hostile spectra for the peak metrics, from numpy with a seed.

Shared by tests/test_torch_peak_metrics.py (the port's plain versions
against the JAX package, on the CPU) and tests/test_torch_cuda.py (the
metrics kernel against its plain version, on the card).  The frequency grid
steps by 1/32, so differences of grid frequencies are exact and a centre
halfway between two of them is equally far from both.
"""

import numpy as np

# the rows of hostile_rows, in order
ROWS = ("nan_sample", "nan_at_dip", "minus_inf", "plus_inf", "all_equal",
        "border_plateaus", "dip_at_0", "dip_at_last", "depth_tie", "distance_tie",
        "flat_bottom", "top_plateaus")
NOISE_ROWS = 8


def _dips(n, *dips):
    """A row of exact V-shaped dips (centre, depth) on a 0 baseline."""
    t = np.zeros(n, np.float32)
    shape = np.array([0.2, 0.5, 0.8, 1.0, 0.8, 0.5, 0.2], np.float32)
    for c, depth in dips:
        lo, hi = max(c - 3, 0), min(c + 4, n)
        t[lo:hi] = np.minimum(t[lo:hi], -depth * shape[lo - c + 3:hi - c + 3])
    return t


def hostile_rows(n: int = 64, seed: int = 0):
    """(freq (n,), t (R, n), c1 (R,), c2 (R,)), float32: the rows of ROWS,
    then NOISE_ROWS of white noise; each row's centres at its two dips."""
    assert n >= 48
    freq = (0.5 + np.arange(n) / 32).astype(np.float32)
    a, b = n // 3, 2 * n // 3
    base = _dips(n, (a, 5.0), (b, 4.0))
    rows, cents = [], []

    def add(t, ia=a, ib=b):
        rows.append(np.asarray(t, np.float32))
        cents.append((freq[ia], freq[ib]))

    for name in ROWS:
        t = base.copy()
        if name == "nan_sample":
            t[(a + b) // 2] = np.nan
        elif name == "nan_at_dip":
            t[a] = np.nan
        elif name == "minus_inf":
            t[a // 2] = -np.inf
        elif name == "plus_inf":
            t[(a + b) // 2] = np.inf
        elif name == "all_equal":
            t[:] = -2.0
        elif name == "border_plateaus":
            t[:5] = -7.0
            t[-5:] = -7.0
        elif name == "dip_at_0":
            t[0] = -9.0
        elif name == "dip_at_last":
            t[-1] = -9.0
        elif name == "depth_tie":
            t = _dips(n, (a, 5.0), (b, 5.0))
        elif name == "distance_tie":
            mid = (a + b) // 2   # both centres halfway between the dips
            add(_dips(n, (mid - 8, 5.0), (mid + 8, 4.0)), mid, mid)
            continue
        elif name == "flat_bottom":
            t[a - 1:a + 2] = -5.0
        elif name == "top_plateaus":
            t[a - 6:a - 3] = 0.5
            t[b + 3:b + 6] = 0.5
        add(t)
    rng = np.random.default_rng(seed)
    for _ in range(NOISE_ROWS):
        ia, ib = rng.integers(0, n, 2)
        add(np.minimum(rng.normal(-1.0, 0.6, n), 0.0), ia, ib)
    c1, c2 = (np.array(c, np.float32) for c in zip(*cents))
    return freq, np.stack(rows), c1, c2
