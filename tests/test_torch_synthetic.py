"""The port's data functions against the JAX package on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.config import DataConfig as TDataConfig
from pigan_thz_torch.data import dataset as tds
from pigan_thz_torch.data import synthetic as tsyn
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.data import dataset as jds
from pigan_thz_tpu.data import synthetic as jsyn
from pigan_thz_tpu.ops.peaks import batched_peak_metrics as j_batched_peak_metrics

torch.set_num_threads(1)

ATOL = 1e-5


def _params(rng, n):
    return rng.uniform(2.2, 2.8, size=(n, 4)).astype(np.float32)


def _metrics(rng, n):
    m = rng.normal(3.0, 2.0, size=(n, 8)).astype(np.float32)
    m[rng.random((n, 8)) < 0.2] = np.nan
    m[:, 5] = np.nan            # an all-NaN column
    m[:, 6] = 1.25              # a zero-span column
    return m


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


def test_param_normalisation_matches_jax():
    rng = np.random.default_rng(0)
    p = _params(rng, 64)
    lo = np.full(4, 2.2, np.float32)
    hi = np.array([2.8, 2.8, 2.2, 2.9], np.float32)   # one zero-span column
    t = [torch.from_numpy(a) for a in (p, lo, hi)]
    j = [jnp.asarray(a) for a in (p, lo, hi)]
    _close(tds.normalize_params(*t), jds.normalize_params(*j))
    pn = rng.uniform(-1, 1, size=(64, 4)).astype(np.float32)
    _close(tds.denormalize_params(torch.from_numpy(pn), t[1], t[2]),
           jds.denormalize_params(jnp.asarray(pn), j[1], j[2]))


def test_metric_normalisation_matches_jax():
    rng = np.random.default_rng(1)
    m = _metrics(rng, 50)
    tlo, thi = tds.metric_ranges_from_data(torch.from_numpy(m))
    jlo, jhi = jds.metric_ranges_from_data(jnp.asarray(m))
    _close(tlo, jlo)
    _close(thi, jhi)
    tn = tds.normalize_metrics(torch.from_numpy(m), tlo, thi)
    _close(tn, jds.normalize_metrics(jnp.asarray(m), jlo, jhi))
    mn = rng.uniform(0, 1, size=(50, 8)).astype(np.float32)
    mn[0, 0] = np.nan
    _close(tds.denormalize_metrics(torch.from_numpy(mn), tlo, thi),
           jds.denormalize_metrics(jnp.asarray(mn), jlo, jhi))


@pytest.mark.parametrize("bounds", [(None, None), (-20.0, 0.0), (-1.0, -1.0)])
def test_normalize_spectrum_matches_jax(bounds):
    rng = np.random.default_rng(2)
    s = rng.uniform(-15, 0, size=(8, 250)).astype(np.float32)
    got = tds.normalize_spectrum(torch.from_numpy(s), *bounds)
    _close(got, jds.normalize_spectrum(jnp.asarray(s), *bounds))


def test_dip_centers_match_jax():
    p = _params(np.random.default_rng(3), 128)
    for got, want in zip(tsyn.dip_centers(torch.from_numpy(p)),
                         jsyn.dip_centers(jnp.asarray(p))):
        _close(got, want)


@pytest.mark.parametrize("apply_offset", [True, False])
def test_noise_free_spectra_match_jax(apply_offset):
    """Same frequency grid on both sides: the two packages' linspace grids
    differ in the last bit, which the steep dips amplify past 1e-5."""
    p = _params(np.random.default_rng(4), 96)
    freq = np.asarray(j_default_config().data.frequencies)
    got = tsyn.synthesize_spectra(
        torch.from_numpy(freq), torch.from_numpy(p), apply_offset=apply_offset
    )
    want = jsyn.synthesize_spectra(
        jnp.asarray(freq), jnp.asarray(p), apply_offset=apply_offset
    )
    assert got.shape == (96, 250) and got.dtype == torch.float32
    _close(got, want)


def test_noise_statistics_and_clamp():
    """threefry and Philox never agree: check the noise's std and the
    clamp at 0 dB only."""
    cfg = t_default_config().data
    gen = torch.Generator().manual_seed(0)
    p = tsyn.sample_params(gen, 2000, cfg, device="cpu")
    clean = tsyn.synthesize_spectra(cfg.frequencies, p)
    noisy = tsyn.synthesize_spectra(cfg.frequencies, p, gen, noise_level=0.1)
    assert float(noisy.max()) <= 0.0
    deep = clean < -1.0            # far from the clamp: noise is untouched
    resid = (noisy - clean)[deep]
    assert resid.numel() > 100_000
    assert abs(float(resid.std()) - 0.1) < 0.002
    assert abs(float(resid.mean())) < 0.002
    # without the offset the low band sits just under 0 dB, where the clamp
    # bites: noise pushes about half of those values to exactly 0
    near = tsyn.synthesize_spectra(cfg.frequencies, p, apply_offset=False)
    noisy = tsyn.synthesize_spectra(cfg.frequencies, p, gen, noise_level=0.1,
                                    apply_offset=False)
    assert float(noisy.max()) <= 0.0
    top = near > -0.02
    assert int(top.sum()) > 1000
    assert 0.3 < float((noisy[top] == 0.0).float().mean()) < 0.6


def test_sample_params_box_and_determinism():
    cfg = t_default_config().data
    a = tsyn.sample_params(torch.Generator().manual_seed(5), 4096, cfg, device="cpu")
    b = tsyn.sample_params(torch.Generator().manual_seed(5), 4096, cfg, device="cpu")
    assert a.shape == (4096, 4) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert float(a.min()) >= cfg.param_min and float(a.max()) <= cfg.param_max
    assert abs(float(a.mean()) - 2.5) < 0.01


def test_build_dataset_matches_jax():
    rng = np.random.default_rng(6)
    cfg_t, cfg_j = t_default_config().data, j_default_config().data
    p = _params(rng, 40)
    s = np.asarray(jsyn.synthesize_spectra(cfg_j.frequencies, jnp.asarray(p)))
    m = _metrics(rng, 40)
    got = tds.build_dataset(s, p, m, cfg_t, device="cpu")
    want = jds.build_dataset(jnp.asarray(s), jnp.asarray(p), jnp.asarray(m), cfg_j)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        assert g.device.type == "cpu" and g.dtype == torch.float32, name
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0,
                                   err_msg=name)
    assert got.num_samples == 40 and got.spectrum_dim == 250


@pytest.mark.parametrize("with_noise", [True, False], ids=["noisy", "clean"])
def test_generate_dataset_metrics_match_jax(with_noise):
    """The port's dataset on the CPU; its metrics against JAX's peak
    analysis on the same spectra, centres and (the port's) grid."""
    cfg = t_default_config().data
    raw = tsyn.generate_dataset(torch.Generator().manual_seed(1), 96, cfg,
                                with_noise=with_noise, device="cpu")
    assert isinstance(raw, tsyn.SyntheticBatch)
    assert [tuple(t.shape) for t in raw] == [(96, 250), (96, 4), (96, 8)]
    assert all(t.dtype == torch.float32 for t in raw)
    p = raw.params.numpy()
    c1, c2 = jsyn.dip_centers(jnp.asarray(p))
    want = j_batched_peak_metrics(jnp.asarray(cfg.frequencies.numpy()),
                                  jnp.asarray(raw.spectra.numpy()),
                                  fallback_f1=c1, fallback_f2=c2)
    np.testing.assert_allclose(raw.metrics.numpy(), np.asarray(want), rtol=1e-5,
                               equal_nan=True)
    assert np.isfinite(raw.metrics.numpy()[:, :2]).all()   # f falls back to the centres
    clean = tsyn.synthesize_spectra(cfg.frequencies, raw.params)
    assert torch.equal(raw.spectra, clean) != with_noise


def test_generate_dataset_draws_params_then_noise():
    """One generator: params first, then the noise, so the params do not
    depend on with_noise and a seed gives one dataset."""
    cfg = t_default_config().data
    a = tsyn.generate_dataset(torch.Generator().manual_seed(2), 40, cfg, device="cpu")
    b = tsyn.generate_dataset(torch.Generator().manual_seed(2), 40, cfg,
                              with_noise=False, device="cpu")
    gen = torch.Generator().manual_seed(2)
    p = tsyn.sample_params(gen, 40, cfg, device="cpu")
    assert torch.equal(a.params, b.params) and torch.equal(a.params, p)
    noisy = tsyn.synthesize_spectra(cfg.frequencies, p, gen, cfg.noise_level)
    assert torch.equal(a.spectra, noisy)


def test_synthetic_dataset_is_seeded_from_the_config():
    cfg = TDataConfig(num_samples=48, seed=5)
    ds = tds.synthetic_dataset(cfg, device="cpu")
    raw = tsyn.generate_dataset(torch.Generator().manual_seed(5), 48, cfg, device="cpu")
    want = tds.build_dataset(raw.spectra, raw.params, raw.metrics, cfg, device="cpu")
    for name, got, w in zip(ds._fields, ds, want):
        assert torch.equal(got.nan_to_num(9.0), w.nan_to_num(9.0)), name
    assert ds.num_samples == 48 and not torch.isnan(ds.metrics_norm).any()
