"""``pigan_thz_torch/evaluate/evaluator.py`` against the JAX package's
``Evaluator``: carried-over weights, one dataset, one noise array, every
number of ``run_comprehensive_evaluation`` and every array of
``sample_arrays`` within 1e-5 (relative, with 1e-5 absolute for the values
near zero): float32 on both sides, other summation orders."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.data.dataset import ThzDataset
from pigan_thz_torch.evaluate import Evaluator
from pigan_thz_torch.interop import load_pigan_state_
from pigan_thz_torch.train.steps import StepSettings
from pigan_thz_torch.train.trainer import Trainer
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.data.dataset import build_dataset as j_build_dataset
from pigan_thz_tpu.train.trainer import Trainer as JTrainer

torch.set_num_threads(1)

N, B = 96, 32
TOL = 1e-5
NARROW = dict(g=(48, 24), d=(40, 20), f=(16, 32, 48, 32, 16))


def _narrow(cfg):
    rep = dataclasses.replace
    return cfg.replace(
        data=rep(cfg.data, num_samples=N),
        train=rep(cfg.train, batch_size=B, num_epochs=2, fwd_pretrain_epochs=2),
        generator=rep(cfg.generator, hidden_dims=NARROW["g"]),
        discriminator=rep(cfg.discriminator, hidden_dims=NARROW["d"]),
        forward_model=rep(cfg.forward_model, hidden_dims=NARROW["f"]))


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def carry_over(jst, tst):
    """A JAX PiGanState's weights, moments and stats into the port's state."""
    ga, da = jst.g_opt[1][0], jst.d_opt[1][0]
    load_pigan_state_(tst, {
        "g": {"params": _np32(jst.g.params),
              "batch_stats": _np32(jst.g.extra["batch_stats"])},
        "d": {"params": _np32(jst.d.params)}, "f": {"params": _np32(jst.f.params)},
        "g_mu": _np32(ga.mu), "g_nu": _np32(ga.nu), "g_count": int(ga.count),
        "d_mu": _np32(da.mu), "d_nu": _np32(da.nu), "d_count": int(da.count),
        "step": int(jst.step)})


@pytest.fixture(scope="module")
def pair():
    """A JAX trainer after a short run (F pretrained, G and D trained: the
    BatchNorm stats and D's scores are non-trivial) and the port's trainer
    carrying its weights, on one dataset."""
    tc, jc = _narrow(t_default_config()), _narrow(j_default_config())
    raw = synthetic_dataset(tc.data, device="cpu")
    jds = j_build_dataset(raw.spectra.numpy(), raw.params.numpy(), raw.metrics.numpy(), jc.data)
    tds = ThzDataset(*(torch.from_numpy(np.array(x, np.float32)) for x in jds))
    jtr = JTrainer(jc, ds=jds, epochs_per_call=1, megakernel="off")
    jtr.train(mode="full", forward_epochs=2, gan_epochs=2)
    ttr = Trainer(tc, ds=tds, device="cpu")
    ttr.init_pigan()
    carry_over(jtr.pigan_state, ttr.pigan_state)
    return jtr, ttr, jds, tds


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_every_number_matches_the_jax_evaluator(pair):
    jtr, ttr, jds, tds = pair
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, jds.spectra.shape))
    want = _flat(jtr.evaluate(key))
    got = _flat(ttr.evaluate(noise))
    assert set(got) == set(want) and len(want) == 36      # jax sorts its keys
    assert got["total_samples"] == want["total_samples"] == N
    for k in want:
        assert isinstance(got[k], (float, int)), k
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)
    # the numbers say something: D separates, stds are population stds
    assert got["pigan_evaluation/discriminator_performance/overall_accuracy"] > 0.0
    assert got["model_validation/prediction_stability_std"] > 0.0


@pytest.mark.parametrize("window", [(0.0, 1.0), (-1.0, 1.0)])
def test_suites_and_the_violation_window(window, pair):
    jtr, ttr, jds, tds = pair
    jev, tev = jtr.evaluator(violation_window=window), ttr.evaluator(violation_window=window)
    want, got = jev.structural_prediction(jds), tev.structural_prediction(tds)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=TOL, atol=TOL, err_msg=k)
    if window == (-1.0, 1.0):
        assert float(got["param_range_violation_rate"]) == 0.0      # a tanh output
    for suite in ("forward_network", "pigan"):
        w, g = _flat(getattr(jev, suite)(jds)), _flat(getattr(tev, suite)(tds))
        assert set(w) == set(g)
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].ndim == 0
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=TOL, atol=TOL, err_msg=k)


def test_sample_arrays_match(pair):
    jtr, ttr, jds, tds = pair
    key = jax.random.PRNGKey(2)
    noise = np.asarray(jax.random.normal(key, jds.spectra.shape))
    want = jtr.evaluator().sample_arrays(jds, key)
    got = ttr.evaluator().sample_arrays(tds, noise)
    assert set(got) == set(want)
    for k in want:
        assert isinstance(got[k], np.ndarray) and got[k].shape == want[k].shape, k
        # spectra in dB are of size 10: the absolute part scales with them
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL * max(
            1.0, float(np.abs(want[k]).max())), err_msg=k)


def test_noise_is_explicit_and_seeded(pair):
    _, ttr, _, tds = pair
    ev = ttr.evaluator()
    a = ev.model_validation(tds)                                   # generator seeded 0
    b = ev.model_validation(tds, torch.Generator().manual_seed(0))
    c = ev.model_validation(tds, torch.Generator().manual_seed(1))
    assert float(a["prediction_stability_mean"]) == float(b["prediction_stability_mean"])
    assert float(a["prediction_stability_mean"]) != float(c["prediction_stability_mean"])
    assert float(a["cycle_consistency_error_mean"]) == float(c["cycle_consistency_error_mean"])
    zero = ev.model_validation(tds, np.zeros(tuple(tds.spectra.shape), np.float32))
    assert float(zero["prediction_stability_mean"]) == 0.0
    with pytest.raises(ValueError, match="noise"):
        ev.model_validation(tds, np.zeros((3, 250), np.float32))


def test_evaluation_leaves_the_modules_as_it_found_them(pair):
    _, ttr, _, tds = pair
    st = ttr.pigan_state
    st.g.train()
    stats = [bn.running_mean.clone() for bn in st.batch_norms()]
    before = st.g_params.clone()
    ttr.evaluate()
    assert st.g.training and not st.f.training
    assert all(torch.equal(a, bn.running_mean) for a, bn in zip(stats, st.batch_norms()))
    assert torch.equal(before, st.g_params)


def test_the_ema_track_is_evaluated_on_request(pair):
    _, ttr, _, tds = pair
    with pytest.raises(ValueError, match="no EMA track"):
        ttr.evaluator(use_ema=True)
    other = Trainer(ttr.cfg, ds=tds, device="cpu")
    with pytest.raises(ValueError, match="init_pigan"):
        other.evaluator()
    other.train_pigan(epochs=1, settings=StepSettings.from_config(other.cfg, ema_decay=0.5))
    live = other.evaluate()["pigan_evaluation"]["parameter_prediction"]["mse"]
    ema = other.evaluate(use_ema=True)["pigan_evaluation"]["parameter_prediction"]["mse"]
    assert live != ema
    # the EMA generator is a copy: the live one is untouched
    manual = Evaluator(other.pigan_state.g, other.pigan_state.d, other.pigan_state.f)
    assert float(manual.pigan(tds)["parameter_prediction"]["mse"]) == live
