"""``pigan_thz_torch/ops/metrics.py`` against ``pigan_thz_tpu/ops/metrics.py``:
every function on the same numpy inputs, including a constant target column
(predicted inexactly and exactly) and a column without variance for Pearson.

Tolerance: rtol 1e-6 (both sides are a handful of float32 reductions of the
same values), atol 1e-6 for values near zero."""

import numpy as np
import pytest
import torch

from pigan_thz_torch.ops import metrics as tm
from pigan_thz_tpu.ops import metrics as jm

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-6
SCALAR_FNS = ("mse", "mae", "rmse", "r2_score", "r2_pooled", "pearson_r", "mape")


def _pair(kind: str):
    rng = np.random.default_rng(11)
    y = rng.normal(1.5, 0.7, (96, 5)).astype(np.float32)
    p = (y + rng.normal(0.0, 0.2, y.shape)).astype(np.float32)
    if kind == "constant_column":           # sklearn's rule: rss > 0 -> 0.0
        y[:, 2] = 0.0
    elif kind == "exact_constant_column":   # rss == 0 -> 1.0
        y[:, 2] = 0.0
        p[:, 2] = 0.0
    elif kind == "flat_prediction":         # Pearson leaves the column out
        p[:, 1] = 0.25
    elif kind == "vector":
        y, p = y[:, 0], p[:, 0]
    elif kind == "rank_3":
        y, p = y.reshape(96, 5, 1), p.reshape(96, 5, 1)
    return y, p


KINDS = ("plain", "constant_column", "exact_constant_column", "flat_prediction", "vector",
         "rank_3")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", SCALAR_FNS)
def test_metric_matches_jax(name, kind):
    y, p = _pair(kind)
    if kind == "rank_3" and name == "pearson_r":
        y, p = y[..., 0], p[..., 0]          # column-wise on matrices
    if kind == "vector" and name in ("r2_score", "r2_pooled"):
        y, p = y[:, None], p[:, None]
    got = getattr(tm, name)(torch.from_numpy(y), torch.from_numpy(p))
    want = np.asarray(getattr(jm, name)(y, p))
    assert got.ndim == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["plain", "constant_column", "exact_constant_column"])
def test_r2_per_column_matches_jax_and_sklearns_constant_rule(kind):
    y, p = _pair(kind)
    got = tm.r2_per_column(torch.from_numpy(y), torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.r2_per_column(y, p)), rtol=RTOL,
                               atol=ATOL)
    assert got.shape == (5,)
    if kind == "constant_column":
        assert float(got[2]) == 0.0
    if kind == "exact_constant_column":
        assert float(got[2]) == 1.0


def test_pearson_without_any_variance_is_nan_on_both_sides():
    y = np.ones((8, 2), np.float32)
    got = tm.pearson_r(torch.from_numpy(y), torch.from_numpy(y))
    assert bool(torch.isnan(got)) and bool(np.isnan(np.asarray(jm.pearson_r(y, y))))


@pytest.mark.parametrize("kind", ["plain", "exact_constant_column"])
def test_regression_metrics_matches_jax(kind):
    y, p = _pair(kind)
    got = tm.regression_metrics(torch.from_numpy(y), torch.from_numpy(p))
    want = jm.regression_metrics(y, p)
    assert set(got) == set(want) == {"mse", "mae", "rmse", "r2", "pearson_r", "mape"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
