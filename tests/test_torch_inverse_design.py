"""The port's InverseDesigner (pigan_thz_torch/design/inverse.py) and
MC-dropout (``models/forward_model.py:mc_dropout_predict``) against the JAX
package's (pigan_thz_tpu/design/inverse.py), on the CPU, at the baseline
trio's full widths with JAX-initialised weights carried over (G's BatchNorm
stats perturbed).

- ``design(refine_steps=0)``: G's prediction and F's check within
  DESIGN_TOL (fp32, other summation orders).
- ``design(refine_steps=20)``: Adam in atanh space with optax's defaults;
  params_norm within REFINE_TOL of JAX's (twenty steps of an adaptive
  optimiser carry the fp32 differences of the gradients), and the refined
  spectrum MSE no higher than the unrefined one (tests/test_inverse_yaml.py:52).
- The single-spectrum interface.
- ``uncertainty``: at dropout 0 the std is exactly 0 and the mean is the
  eval-mode forward (bit for bit on the samples' stacked batch, within
  DESIGN_TOL on the B rows alone); at 0.2 the masks are not the JAX
  package's (threefry there, Philox here), so statistics are compared: the
  means within
  MC_SIGMAS standard errors of the difference of two N-sample means, the
  average std within STD_RTOL of JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.data import build_dataset
from pigan_thz_torch.design import DesignResult, InverseDesigner
from pigan_thz_torch.interop import from_flax
from pigan_thz_torch.models import build_forward_model, build_generator
from pigan_thz_torch.models.forward_model import mc_dropout_predict
from pigan_thz_tpu.design import InverseDesigner as JInverseDesigner
from pigan_thz_tpu.models import build_forward_model as j_build_forward_model
from pigan_thz_tpu.models import build_trio
from pigan_thz_tpu.models.forward_model import mc_dropout_predict as j_mc_dropout_predict

torch.set_num_threads(1)

DESIGN_TOL = 1e-5
REFINE_TOL = 1e-4
MC_SIGMAS = 5.0
STD_RTOL = 0.1
SAMPLES = 256
B = 8


def _forward_pair(cfg, small_ds, rate):
    jf = j_build_forward_model(dataclasses.replace(cfg.forward_model, dropout_rate=rate),
                               cfg.data.spectrum_dim, cfg.data.metrics_dim)
    k = jax.random.PRNGKey(0)
    fv = jf.init({"params": k, "dropout": k}, small_ds.params_norm[:2], train=False)
    tf = build_forward_model(dataclasses.replace(t_default_config().forward_model,
                                                 dropout_rate=rate), device="cpu")
    tf.load_state_dict(from_flax(jax.tree.map(np.asarray, fv), "forward_model"))
    return jf, fv, tf.eval()


@pytest.fixture(scope="module")
def designers(cfg, small_ds):
    g = build_trio(cfg)[0]
    k = jax.random.PRNGKey(4)
    gv = dict(g.init(k, small_ds.spectra[:2], train=False))
    gv["batch_stats"] = jax.tree.map(
        lambda a: a + 0.1 * jax.random.normal(k, a.shape) ** 2, gv["batch_stats"])
    tg = build_generator(t_default_config().generator, device="cpu")
    tg.load_state_dict(from_flax(jax.tree.map(np.asarray, gv), "generator"))
    tds = build_dataset(
        np.asarray(small_ds.spectra), np.asarray(small_ds.params),
        np.asarray(small_ds.metrics), t_default_config().data,
        frequencies=np.asarray(small_ds.frequencies), device="cpu")
    out = {}
    for rate in (0.2, 0.0):
        jf, fv, tf = _forward_pair(cfg, small_ds, rate)
        out[rate] = (JInverseDesigner(g, jf, gv, fv, small_ds),
                     InverseDesigner(tg.eval(), tf, tds), (jf, fv, tf))
    return out


def _np(t):
    return np.asarray(t, np.float32)


def test_design_without_refinement_matches_jax(designers, small_ds):
    jd, td, _ = designers[0.2]
    x = np.asarray(small_ds.spectra[:B])
    want = jd.design(jnp.asarray(x))
    got = td.design(torch.from_numpy(x))
    assert isinstance(got, DesignResult)
    for name in DesignResult._fields:
        a, b = getattr(got, name), _np(getattr(want, name))
        assert tuple(a.shape) == b.shape, name
        assert np.abs(a.numpy() - b).max() <= DESIGN_TOL * max(1.0, np.abs(b).max()), name


def test_refinement_matches_jax_and_lowers_the_mse(designers, small_ds):
    jd, td, _ = designers[0.2]
    x = np.asarray(small_ds.spectra[:B])
    want = jd.design(jnp.asarray(x), refine_steps=20)
    got = td.design(torch.from_numpy(x), refine_steps=20)
    base = td.design(torch.from_numpy(x))
    np.testing.assert_allclose(got.params_norm.numpy(), _np(want.params_norm), rtol=0,
                               atol=REFINE_TOL)
    assert float(got.spectrum_mse.mean()) <= float(base.spectrum_mse.mean())
    assert float(got.params_norm.abs().max()) <= 1.0
    assert not torch.equal(got.params_norm, base.params_norm)
    np.testing.assert_allclose(got.spectrum_mse.numpy(), _np(want.spectrum_mse), rtol=1e-3)


def test_single_spectrum_interface(designers, small_ds):
    _, td, _ = designers[0.2]
    x = torch.from_numpy(np.asarray(small_ds.spectra[:1]))
    one = td.design(x[0])
    assert one.params.shape == (4,) and one.pred_spectrum.shape == (250,)
    assert one.spectrum_mse.shape == ()
    batch = td.design(x)
    for name in DesignResult._fields:
        assert torch.equal(getattr(one, name), getattr(batch, name)[0]), name
    s_mean, s_std, m_mean, m_std = td.uncertainty(x[0], torch.Generator().manual_seed(0),
                                                  num_samples=8)
    assert s_mean.shape == (1, 250) and m_std.shape == (1, 8)
    assert float(s_std.mean()) > 0.0


def test_uncertainty_without_dropout_is_exact(designers, small_ds):
    _, td, (_, _, tf) = designers[0.0]
    x = torch.from_numpy(np.asarray(small_ds.spectra[:B]))
    s_mean, s_std, m_mean, m_std = td.uncertainty(x, torch.Generator().manual_seed(0),
                                                  num_samples=16)
    assert torch.equal(s_std, torch.zeros_like(s_std))
    assert torch.equal(m_std, torch.zeros_like(m_std))
    pn = td.design(x).params_norm
    with torch.no_grad():
        # the eval forward on the samples' stacked batch, exactly; on B rows
        # alone the products block differently, so within fp32 rounding
        spec, met = tf(pn.repeat(16, 1))
        spec_b, met_b = tf(pn)
    assert torch.equal(s_mean, spec[:B]) and torch.equal(m_mean, met[:B])
    torch.testing.assert_close(s_mean, spec_b, rtol=0, atol=DESIGN_TOL)
    torch.testing.assert_close(m_mean, met_b, rtol=0, atol=DESIGN_TOL)


def test_uncertainty_statistics_match_jax(designers, small_ds):
    jd, td, _ = designers[0.2]
    x = np.asarray(small_ds.spectra[:4])
    want = [_np(t) for t in jd.uncertainty(jnp.asarray(x), jax.random.PRNGKey(0),
                                           num_samples=SAMPLES)]
    got = [t.numpy() for t in td.uncertainty(torch.from_numpy(x),
                                             torch.Generator().manual_seed(0),
                                             num_samples=SAMPLES)]
    for (mean, std), (j_mean, j_std) in ((got[0:2], want[0:2]), (got[2:4], want[2:4])):
        assert mean.shape == j_mean.shape and std.shape == j_std.shape
        assert (std > 0).all()
        se = np.sqrt(2.0 / SAMPLES) * np.maximum(std, j_std)
        assert (np.abs(mean - j_mean) <= MC_SIGMAS * se + 1e-6).all()
        assert abs(std.mean() / j_std.mean() - 1.0) <= STD_RTOL


def test_mc_dropout_keep_share_and_scale(designers):
    """Each dropout layer keeps 1 - p of its entries, scaled by 1 / (1 - p):
    the model's layers run once more by hand with the masks recorded."""
    _, _, (_, _, tf) = designers[0.2]
    pn = torch.rand((64, 4), generator=torch.Generator().manual_seed(1)) * 2 - 1
    gen_a, gen_b = (torch.Generator().manual_seed(7) for _ in range(2))
    got = mc_dropout_predict(tf, pn, gen_a, num_samples=4)
    h = pn.repeat(4, 1)
    kept = []
    with torch.no_grad():
        for layer in tf.model:
            h = layer(h)
            if isinstance(layer, torch.nn.Dropout):
                mask = torch.rand(h.shape, generator=gen_b) < 1 - layer.p
                kept.append(float(mask.float().mean()))
                h = torch.where(mask, h / (1 - layer.p), torch.zeros_like(h))
    spec = h[:, :250].double().reshape(4, 64, 250)
    torch.testing.assert_close(got[0], spec.mean(0).float(), rtol=0, atol=0)
    assert all(abs(k - 0.8) < 0.01 for k in kept) and len(kept) == 5
    assert tf.training is False


def test_jax_reference_mc_runs(designers, small_ds):
    """The JAX function the port's is held against draws what its designer
    reports (a guard on the comparison above)."""
    jd, _, (jf, fv, _) = designers[0.2]
    x = jnp.asarray(small_ds.spectra[:2])
    pn = jd.design(x).params_norm
    a = j_mc_dropout_predict(jf, fv, pn, jax.random.PRNGKey(0), num_samples=8)
    b = jd.uncertainty(x, jax.random.PRNGKey(0), num_samples=8)
    for u, v in zip(a, b):
        np.testing.assert_allclose(_np(u), _np(v), rtol=1e-6, atol=1e-6)
