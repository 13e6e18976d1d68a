"""Regression and evaluation metrics as plain PyTorch functions: the port of
``pigan_thz_tpu/ops/metrics.py``.

They replace the sklearn / scipy calls of the reference evaluator
(core/evaluate/unified_evaluator.py:138-184: MSE, MAE, RMSE, R², Pearson,
MAPE) with functions that run where their inputs are.  Epsilons follow the
reference (MAPE adds 1e-8 to the denominator, unified_evaluator.py:182).
Each returns a 0-dim tensor unless it says otherwise.
"""

from __future__ import annotations

from typing import Dict

import torch


def mse(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return torch.mean((y_true - y_pred) ** 2)


def mae(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(y_true - y_pred))


def rmse(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(mse(y_true, y_pred))


def r2_score(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Coefficient of determination, the uniform average over output columns:
    sklearn's default multioutput behaviour, which the reference evaluator
    calls (unified_evaluator.py:158)."""
    y_true = y_true.reshape(y_true.shape[0], -1)
    y_pred = y_pred.reshape(y_pred.shape[0], -1)
    return torch.mean(r2_per_column(y_true, y_pred))


def r2_pooled(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """One pooled R² with the squared errors summed over all elements: the
    reference trainers' in-loop variant
    (unified_constraint_trainer.py:349-362)."""
    y_true = y_true.reshape(y_true.shape[0], -1)
    y_pred = y_pred.reshape(y_pred.shape[0], -1)
    mean = torch.mean(y_true, dim=0, keepdim=True)
    tss = torch.sum((y_true - mean) ** 2)
    rss = torch.sum((y_true - y_pred) ** 2)
    return 1.0 - rss / torch.where(tss > 0, tss, torch.ones_like(tss))


def r2_per_column(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Column-wise R² (sklearn's multioutput='raw_values'), shape (C,).

    A column of ``y_true`` that is constant follows sklearn's convention:
    1.0 where the prediction is exact, 0.0 otherwise.  (``1 - rss`` there
    would be arbitrarily negative and wreck the uniform average on
    noise-free data whose clamped spectrum columns are exactly 0 dB.)"""
    mean = torch.mean(y_true, dim=0, keepdim=True)
    tss = torch.sum((y_true - mean) ** 2, dim=0)
    rss = torch.sum((y_true - y_pred) ** 2, dim=0)
    plain = 1.0 - rss / torch.where(tss > 0, tss, torch.ones_like(tss))
    degenerate = torch.where(rss > 0, 0.0, 1.0).to(plain.dtype)
    return torch.where(tss > 0, plain, degenerate)


def pearson_r(y_true: torch.Tensor, y_pred: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Mean column-wise Pearson correlation (unified_evaluator.py:163-178);
    a column whose denominator is at most ``eps`` is left out of the mean
    (NaN when every column is)."""
    if y_true.ndim == 1:
        y_true = y_true[:, None]
        y_pred = y_pred[:, None]
    xt = y_true - torch.mean(y_true, dim=0, keepdim=True)
    yp = y_pred - torch.mean(y_pred, dim=0, keepdim=True)
    num = torch.sum(xt * yp, dim=0)
    den = torch.sqrt(torch.sum(xt**2, dim=0) * torch.sum(yp**2, dim=0))
    ok = den > eps
    r = num / torch.where(ok, den, torch.ones_like(den))
    r = torch.where(ok, r, torch.full_like(r, float("nan")))
    return torch.nanmean(r)


def mape(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Percent error with the reference's +1e-8 denominator
    (unified_evaluator.py:182)."""
    return torch.mean(torch.abs((y_true - y_pred) / (y_true + 1e-8))) * 100.0


def regression_metrics(y_true: torch.Tensor, y_pred: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The full kit of unified_evaluator.calculate_metrics (:138-184)."""
    m = mse(y_true, y_pred)
    return {
        "mse": m,
        "mae": mae(y_true, y_pred),
        "rmse": torch.sqrt(m),
        "r2": r2_score(y_true, y_pred),
        "pearson_r": pearson_r(y_true, y_pred),
        "mape": mape(y_true, y_pred),
    }
