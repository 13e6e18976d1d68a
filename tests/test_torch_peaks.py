"""The port's peak analysis (ops/peaks.py) against the JAX package and scipy,
on the CPU.

Both plain versions of the dip-qualification kernel (the lattice and the
sparse-table form) and the CPU route of its wrapper are held against JAX's
``dip_qualification`` and against its Pallas kernel in interpret mode, as
tests/test_peaks.py runs it; selection, FWHM and the eight metrics against
JAX's functions; the qualified set against ``scipy.signal.find_peaks``.
The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import find_peaks, peak_prominences, peak_widths

from pigan_thz_torch.design.screening import _score
from pigan_thz_torch.ops import peaks as tp
from pigan_thz_tpu.config import DataConfig
from pigan_thz_tpu.data import dip_centers, synthesize_spectra
from pigan_thz_tpu.ops import peaks as jp

torch.set_num_threads(1)

CLASSES = ("random_walk", "quantized", "white_noise", "noisy_dips")
FREQ = np.array(DataConfig().frequencies)     # JAX's grid, given to both sides


def _spectra(kind, n, rng, b=11):
    """(b, n) float32 spectra of one class of tests/test_peaks.py."""
    f = np.linspace(0.5, 3.0, n)
    rows = []
    for _ in range(b):
        if kind == "random_walk":
            t = np.minimum(np.cumsum(rng.normal(0, 0.8, n)), 0)
        elif kind == "quantized":
            t = np.round(np.minimum(rng.normal(-2, 1.5, n), 0) * 2) / 2
        elif kind == "white_noise":
            t = np.minimum(rng.normal(-1.0, 0.6, n), 0)
        else:   # two dips under wiggles that straddle the threshold
            t = -8 * np.exp(-((f - 0.9) ** 2) / (2 * 0.08**2))
            t -= 6 * np.exp(-((f - 2.1) ** 2) / (2 * 0.15**2))
            t = np.minimum(t + rng.normal(0, 0.45, n), 0)
        rows.append(t)
    return np.stack(rows).astype(np.float32)


def _assert_same(got, want):
    """Masks exact; prominence and width at the peaks (don't-care elsewhere)."""
    for name in ("qualified", "is_peak"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    pk = np.asarray(want.is_peak)
    np.testing.assert_allclose(got.prominence.numpy()[pk],
                               np.asarray(want.prominence)[pk], rtol=1e-6)
    np.testing.assert_allclose(got.width.numpy()[pk],
                               np.asarray(want.width)[pk], rtol=1e-5)


@pytest.mark.parametrize("kind", CLASSES)
@pytest.mark.parametrize("n", [250, 199, 64])
def test_plain_versions_match_jax(n, kind):
    t = _spectra(kind, n, np.random.default_rng(n + len(kind)))
    want = jax.vmap(jp.dip_qualification)(jnp.asarray(t))
    tt = torch.from_numpy(t)
    _assert_same(tp.dip_qualification(tt), want)
    _assert_same(tp._dip_qualification_lifted(tt), want)
    _assert_same(tp.batched_dip_qualification(tt), want)   # the CPU route


@pytest.mark.parametrize("n", [250, 199, 64])
def test_plain_versions_match_pallas_interpret(n):
    """Against the Pallas kernel itself, run in interpret mode (its N pad to
    the lane multiple and B pad to the tile are exercised: B = 11)."""
    rng = np.random.default_rng(99 + n)
    t = np.concatenate([_spectra(k, n, rng, b=3) for k in CLASSES[:3]] +
                       [_spectra("white_noise", n, rng, b=2)])
    want = jp.batched_dip_qualification(jnp.asarray(t), interpret=True)
    _assert_same(tp.dip_qualification(torch.from_numpy(t)), want)
    _assert_same(tp._dip_qualification_lifted(torch.from_numpy(t)), want)


def _scipy_qualified(t):
    return find_peaks(-np.asarray(t, np.float64), prominence=1.0, width=1)[0]


@pytest.mark.parametrize("kind", ["random_walk", "white_noise", "noisy_dips"])
def test_qualified_set_matches_scipy(kind):
    t = _spectra(kind, 250, np.random.default_rng(23), b=40)
    for form in (tp.dip_qualification, tp._dip_qualification_lifted):
        qual = form(torch.from_numpy(t)).qualified.numpy()
        for row, q in zip(t, qual):
            np.testing.assert_array_equal(np.flatnonzero(q), _scipy_qualified(row))


def test_quantized_differs_from_scipy_only_at_thresholds():
    """fp32 cannot decide a dip whose fp64 prominence or width lies on the
    filter threshold (tests/test_peaks.py:302-350); every other dip agrees."""
    t = _spectra("quantized", 250, np.random.default_rng(7), b=200)
    qual = tp._dip_qualification_lifted(torch.from_numpy(t)).qualified.numpy()
    for row, q in zip(t, qual):
        x64 = -row.astype(np.float64)
        for idx in set(_scipy_qualified(row).tolist()) ^ set(np.flatnonzero(q).tolist()):
            prom = peak_prominences(x64, [idx])
            w = peak_widths(x64, [idx], rel_height=0.5, prominence_data=prom)[0][0]
            assert abs(prom[0][0] - 1.0) < 1e-6 or abs(w - 1.0) < 1e-6, (idx, prom, w)
    # the knife-edge instance: fp64 width exactly 1.0 at index 4
    edge = np.array([-5, -2.5, 0, 0, -3, -1.5, -1, -5] + [0] * 242, np.float32)
    ours = set(np.flatnonzero(tp.dip_qualification(torch.from_numpy(edge[None]))
                              .qualified.numpy()[0]).tolist())
    sp = set(_scipy_qualified(edge).tolist())
    assert sp - ours == {4} and ours <= sp


def test_measures_match_scipy():
    rng = np.random.default_rng(3)
    t = -8 * np.exp(-((FREQ - 0.9) ** 2) / (2 * 0.08**2)) + rng.normal(0, 0.3, 250)
    t = np.minimum(t, 0).astype(np.float32)
    x = -t.astype(np.float64)
    idx = _scipy_qualified(t)
    prom = peak_prominences(x, idx)
    w = peak_widths(x, idx, rel_height=0.5, prominence_data=prom)
    q = tp._dip_qualification_lifted(torch.from_numpy(t[None]))
    np.testing.assert_allclose(q.prominence.numpy()[0, idx], prom[0], rtol=1e-4)
    np.testing.assert_allclose(q.width.numpy()[0, idx], w[0], rtol=1e-3)


@pytest.fixture(scope="module")
def synthetic():
    """Noisy synthetic spectra on JAX's grid, their params' centres with a
    few rows' centres NaN (depth-selection fallback), and class spectra."""
    key = jax.random.PRNGKey(3)
    params = jax.random.uniform(key, (48, 4), minval=2.2, maxval=2.8)
    spec = np.asarray(synthesize_spectra(jnp.asarray(FREQ), params,
                                         key=jax.random.PRNGKey(9)))
    spec = np.concatenate([spec, _spectra("random_walk", 250, np.random.default_rng(1), 16)])
    c1, c2 = (np.asarray(c) for c in dip_centers(params))
    c1 = np.concatenate([c1, np.full(16, 0.9, np.float32)])
    c2 = np.concatenate([c2, np.full(16, 2.1, np.float32)])
    c1[::5] = np.nan
    return spec, c1.astype(np.float32), c2.astype(np.float32)


@pytest.mark.parametrize("with_centers", [True, False], ids=["centres", "depth"])
def test_find_two_dips_matches_jax(synthetic, with_centers):
    spec, c1, c2 = synthetic
    qual = jax.vmap(jp.dip_qualification)(jnp.asarray(spec)).qualified
    if with_centers:
        want = jax.vmap(lambda t, a, b, q: jp.find_two_dips(
            t, freq=jnp.asarray(FREQ), centers=(a, b), qualified=q))(
            jnp.asarray(spec), jnp.asarray(c1), jnp.asarray(c2), qual)
        got = tp.find_two_dips(torch.from_numpy(spec), freq=torch.from_numpy(FREQ),
                               centers=(torch.from_numpy(c1), torch.from_numpy(c2)))
    else:
        want = jax.vmap(lambda t: jp.find_two_dips(t))(jnp.asarray(spec))
        got = tp.find_two_dips(torch.from_numpy(spec))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_peak_parameters_match_jax(synthetic):
    spec = synthetic[0]
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 250, spec.shape[0])
    idx[:3] = (0, 249, 125)
    want = jax.vmap(lambda t, i: jp.peak_parameters(jnp.asarray(FREQ), t, i))(
        jnp.asarray(spec), jnp.asarray(idx))
    got = tp.peak_parameters(torch.from_numpy(FREQ), torch.from_numpy(spec),
                             torch.from_numpy(idx))
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   equal_nan=True, err_msg=name)


@pytest.mark.parametrize("with_centers", [True, False], ids=["centres", "no_centres"])
def test_metrics_match_jax(synthetic, with_centers):
    spec, c1, c2 = synthetic
    fb = (c1, c2) if with_centers else (None, None)
    want = jp.batched_peak_metrics(
        jnp.asarray(FREQ), jnp.asarray(spec),
        *(None if c is None else jnp.asarray(c) for c in fb))
    got = tp.batched_peak_metrics(torch.from_numpy(FREQ), torch.from_numpy(spec),
                                  *(None if c is None else torch.from_numpy(c) for c in fb))
    assert got.shape == (spec.shape[0], 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, equal_nan=True)
    assert np.isnan(got.numpy()).any() and np.isfinite(got.numpy()).any()
    # spectrum_metrics with the qualification given is the same function
    qual = tp.batched_dip_qualification(torch.from_numpy(spec)).qualified
    again = tp.spectrum_metrics(torch.from_numpy(FREQ), torch.from_numpy(spec),
                                *(None if c is None else torch.from_numpy(c) for c in fb),
                                qualified=qual)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_flat_spectrum_falls_back_to_centres():
    freq = torch.linspace(0.5, 3.0, 100)
    m = tp.spectrum_metrics(freq, torch.zeros(2, 100), fallback_f1=0.9, fallback_f2=2.1)
    np.testing.assert_allclose(m[:, :2].numpy(), [[0.9, 2.1]] * 2, rtol=1e-6)
    assert np.isnan(m[:, 2:].numpy()).all()


def test_degenerate_spectra_score_minus_inf():
    """Monotone roll-off spectra: NaN f1 without fallback, so -inf scores
    (tests/test_peaks.py:245-261)."""
    f = np.linspace(0.5, 3.0, 250)
    rolloff = np.minimum.accumulate(np.minimum(-3.0 * (f - 0.5) / 2.5, 0)).astype(np.float32)
    batch = torch.from_numpy(np.stack([rolloff] * 4))
    metrics = tp.batched_peak_metrics(torch.from_numpy(f.astype(np.float32)), batch)
    assert torch.isnan(metrics[:, 0]).all()
    assert (_score(metrics, "FoM1") == -torch.inf).all()
    assert (_score(metrics, "FoM1+FoM2") == -torch.inf).all()
