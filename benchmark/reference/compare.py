"""The numbers a check compares, each against its limit.

Training (by leaf; a leaf is one named parameter tensor).  The check
follows the first epoch that the timed path trains in each of several
trained copies (trios, members), one launch of ``spe`` steps on the rows it
drew itself:

- ``loss_gap``: |program - reference| / |reference| of the epoch's mean
  loss (the program reports each epoch's mean of its steps' losses), by
  the median copy;
- ``moment_gap``: Adam's first moment after the epoch (the clipped
  gradients as the optimiser holds them), by the worst leaf of every copy's
  leaves together:
  | |m_p| - |m_r| | / max(|m_r|, median leaf |m_r|);
- ``moment_median_gap``: the same at the median leaf;
- ``change_gap`` / ``change_median_gap``: the parameters' change over the
  epoch, by the same measure, at the worst / the median leaf.  Leaves whose
  reference gradient at the first step is below a thousandth of the median
  leaf's (a bias under BatchNorm: nought up to rounding, so Adam moves it by
  round-off alone) are left out of the change;
- ``repeated_rows``: rows that the epoch's draws hold twice, or that lie
  outside the set (an epoch trains on rows that all differ).

Answers (the design cells): ``*_gap`` = max |program - reference| over the
sampled answers, divided by the root mean square of the reference's.
"""

from __future__ import annotations

import statistics

import torch

EXCLUDE_BELOW = 1e-3      # of the median leaf's reference gradient norm


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def worst_leaf_gap(program: dict, reference: dict, keep=None) -> float:
    """max over leaves of | |p| - |r| | / max(|r|, median |r|)."""
    np_, nr = _norms(program), _norms(reference)
    keys = [k for k in nr if keep is None or k in keep]
    med = statistics.median(nr[k] for k in keys)
    return max(abs(np_[k] - nr[k]) / max(nr[k], med) for k in keys)


def median_leaf_gap(program: dict, reference: dict, keep=None) -> float:
    """The median over leaves of | |p| - |r| | / max(|r|, median |r|)."""
    np_, nr = _norms(program), _norms(reference)
    keys = [k for k in nr if keep is None or k in keep]
    med = statistics.median(nr[k] for k in keys)
    return statistics.median(abs(np_[k] - nr[k]) / max(nr[k], med) for k in keys)


def moving_leaves(ref_grad: dict) -> set:
    """The leaves whose reference gradient is not nought to rounding."""
    n = _norms(ref_grad)
    med = statistics.median(n.values())
    return {k for k, v in n.items() if v >= EXCLUDE_BELOW * med}


def loss_gap(program: float, reference: list) -> float:
    """The program's epoch mean against the mean of the reference's steps."""
    if not reference or not program == program:
        return float("inf")
    ref = sum(reference) / len(reference)
    return abs(program - ref) / max(abs(ref), 1e-30)


def repeated_rows(indices: torch.Tensor, num_samples: int) -> int:
    """Rows of one epoch's draws ``indices`` drawn twice or out of range."""
    flat = indices.reshape(-1)
    outside = int(((flat < 0) | (flat >= num_samples)).sum())
    return int(flat.numel() - torch.unique(flat).numel()) + outside


def merged(readings: list, key: str) -> dict:
    """The ``key`` leaves of several trained copies (trios, members) as one
    set, "t<i>:" before each name."""
    return {f"t{i}:{x}": v for i, r in enumerate(readings) for x, v in r[key].items()}


def leaf_readings(prefix: str, prog: dict, ref: dict) -> dict:
    """The by-leaf numbers of one trained epoch: ``prog`` and ``ref`` hold
    ``moment`` and ``change`` ({leaf: tensor}), ``ref`` also ``first_grad``."""
    moving = moving_leaves(ref["first_grad"])
    return {
        f"{prefix}.moment_gap": worst_leaf_gap(prog["moment"], ref["moment"]),
        f"{prefix}.moment_median_gap": median_leaf_gap(prog["moment"], ref["moment"]),
        f"{prefix}.change_gap": worst_leaf_gap(prog["change"], ref["change"], moving),
        f"{prefix}.change_median_gap": median_leaf_gap(prog["change"], ref["change"], moving),
    }


def answer_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    if program.shape != reference.shape or not bool(torch.isfinite(program).all()):
        return float("inf")
    ref = reference.double()
    rms = float(torch.sqrt(torch.mean(ref * ref)))
    return float((program.double() - ref).abs().max()) / max(rms, 1e-30)


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [[name, value, limit], ...]): correct when every number is
    finite and at most its limit.  A number without a limit fails."""
    rows, ok = [], True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = limit is not None and value == value and value <= limit
        ok = ok and good
        rows.append([name, value, limit])
    return ok and bool(rows), rows
