"""Seed-ensemble scoring and ensemble-mean serving against the JAX package:
``parallel/ensemble.py`` (``evaluate_ensemble``, ``evaluate_ensemble_mean``)
and ``serve.py:make_ensemble_inverse_design_fn``.

Three members at the baseline widths with a shared F, their BatchNorm running
stats perturbed per member, the weights carried across with
``ensemble_states_to_flax``; 96 samples.  Tolerances: the scores within rtol
1e-4 (fp32 reductions of the same forwards in another order; ``param_r2`` is
1 - a ratio of two such sums); the served params within atol 1e-5 in
normalised units (times the parameter span in physical units), the served
spectrum and metrics within 1e-4."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.data.dataset import ThzDataset
from pigan_thz_torch.interop import ensemble_states_to_flax
from pigan_thz_torch.models import build_trio as t_build_trio
from pigan_thz_torch.parallel import ensemble as te
from pigan_thz_torch.serve import make_ensemble_inverse_design_fn, make_inverse_design_fn
from pigan_thz_torch.train.state import make_optimizers
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu import serve as jserve
from pigan_thz_tpu.data.dataset import build_dataset as j_build_dataset
from pigan_thz_tpu.models import build_trio as j_build_trio
from pigan_thz_tpu.parallel import ensemble as je
from pigan_thz_tpu.train.state import ModelState

torch.set_num_threads(1)

N, M = 96, 3
SCORE_RTOL, PARAMS_NORM_ATOL, OUT_ATOL = 1e-4, 1e-5, 1e-4
BF16_RTOL = 2e-2


@pytest.fixture(scope="module")
def tcfg():
    c = t_default_config()
    return c.replace(data=dataclasses.replace(c.data, num_samples=N))


@pytest.fixture(scope="module")
def datasets(tcfg):
    raw = synthetic_dataset(tcfg.data, device="cpu")
    jc = j_default_config()
    jds = j_build_dataset(raw.spectra.numpy(), raw.params.numpy(), raw.metrics.numpy(),
                          jc.replace(data=dataclasses.replace(jc.data, num_samples=N)).data)
    tds = ThzDataset(*(torch.from_numpy(np.array(x, np.float32)) for x in jds))
    return jds, tds


@pytest.fixture(scope="module")
def ensembles(tcfg):
    """The port's stacked members and the same weights as the JAX package's
    member-stacked state (only ``g`` and ``f`` are read by the scorers)."""
    g, d, f = t_build_trio(tcfg, device="cpu", generator=torch.Generator().manual_seed(2))
    gtx, dtx, _ = make_optimizers(tcfg, 1)
    states = te.init_ensemble_states(g, d, f, gtx, dtx,
                                     [te.member_generator(4, i) for i in range(M)],
                                     device="cpu")
    noise = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for st in states:                    # non-trivial, per-member BatchNorm stats
            for bn in st.batch_norms():
                bn.running_mean += 0.3 * torch.randn(bn.num_features, generator=noise)
                bn.running_var += 0.2 * torch.rand(bn.num_features, generator=noise)
    assert not torch.equal(states.bn[0][0], states.bn[0][1])
    trees = ensemble_states_to_flax(states)
    jstates = types.SimpleNamespace(
        g=ModelState(params=trees["g"]["params"],
                     extra={"batch_stats": trees["g"]["batch_stats"]}),
        f=ModelState(params=trees["f"]["params"], extra={}))
    return states, jstates


def test_evaluate_ensemble_matches_jax(ensembles, datasets):
    states, jstates = ensembles
    jds, tds = datasets
    jg, _, jf = j_build_trio(j_default_config())
    got = te.evaluate_ensemble(states, tds)
    want = je.evaluate_ensemble(jg, jf, jstates, jds)
    assert set(got) == set(want) == {"param_r2", "recon_mse", "violation_rate", "cycle_error"}
    for k in want:
        assert got[k].shape == (M,)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=SCORE_RTOL,
                                   atol=1e-6, err_msg=k)
    assert len(set(got["param_r2"].tolist())) == M          # the members differ
    assert all(st.g.training for st in states)              # eval mode was put back


def test_evaluate_ensemble_mean_matches_jax(ensembles, datasets):
    states, jstates = ensembles
    jds, tds = datasets
    jg, _, jf = j_build_trio(j_default_config())
    got = te.evaluate_ensemble_mean(states, tds)
    want = je.evaluate_ensemble_mean(jg, jf, jstates, jds)
    assert set(got) == set(want) and "member_spread" in got
    for k in want:
        assert got[k].ndim == 0
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=SCORE_RTOL,
                                   atol=1e-6, err_msg=k)
    # the population form of the spread (jnp.std), not torch.std's default
    preds = te.member_predictions(states, tds.spectra)
    assert preds.shape == (M, N, 4)
    np.testing.assert_allclose(float(got["member_spread"]),
                               float(preds.numpy().std(axis=0).mean()), rtol=1e-5)
    assert float(torch.std(preds, dim=0).mean()) > float(got["member_spread"]) * 1.1
    # the cycle term averages every member on the mean reconstruction
    with torch.no_grad():
        states[0].g.eval()
        mean = preds.mean(0)
        only0 = torch.mean((states[0].g(states.f(mean)[0]) - mean) ** 2)
        states[0].g.train()
    assert abs(float(only0) - float(got["cycle_error"])) > 1e-6


def test_ensemble_mean_serving_matches_jax(ensembles, datasets):
    states, jstates = ensembles
    jds, tds = datasets
    jg, _, jf = j_build_trio(j_default_config())
    spectra = tds.spectra[:64].contiguous()
    fn = make_ensemble_inverse_design_fn([st.g for st in states], states.f, tds)
    params, spec, met = fn(spectra)
    jfn = jserve.make_ensemble_inverse_design_fn(
        jg, jf, jstates.g.variables, jax.tree.map(lambda x: x[0], jstates.f.variables), jds)
    jparams, jspec, jmet = (np.asarray(x) for x in jfn(jnp.asarray(spectra.numpy())))
    assert params.shape == (64, 4) and spec.shape == (64, 250) and met.shape == (64, 8)
    span = (tds.param_hi - tds.param_lo).numpy() / 2.0      # physical per normalised unit
    assert (np.abs(params.numpy() - jparams) <= PARAMS_NORM_ATOL * span).all()
    np.testing.assert_allclose(spec.numpy(), jspec, rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(met.numpy(), jmet, rtol=0, atol=OUT_ATOL)
    # it is the mean of the members' own served params
    own = torch.stack([make_inverse_design_fn(st.g, states.f, tds)(spectra)[0]
                       for st in states]).mean(dim=0)
    torch.testing.assert_close(params, own, rtol=0, atol=2e-5)
    # the weights were read at construction: later training is not seen
    with torch.no_grad():
        states.g_params.mul_(0.5)
        again = fn(spectra)[0]
        states.g_params.mul_(2.0)
    assert torch.equal(again, params)
    # bf16: the members and F as their bf16 twins, against the JAX package's
    # bf16 ensemble mean within the bf16 models' MODEL_RTOL (tests/test_torch_bf16.py)
    got16 = make_ensemble_inverse_design_fn([st.g for st in states], states.f, tds,
                                            compute_dtype="bfloat16")(spectra)
    want16 = jserve.make_ensemble_inverse_design_fn(
        jg, jf, jstates.g.variables, jax.tree.map(lambda x: x[0], jstates.f.variables), jds,
        compute_dtype=jnp.bfloat16)(jnp.asarray(spectra.numpy()))
    for a, b in zip(got16, want16):
        b = np.asarray(b, np.float32)
        assert a.dtype == torch.float32
        assert np.abs(a.numpy() - b).max() <= BF16_RTOL * np.abs(b).max()
    with pytest.raises(ValueError, match="int8"):
        make_ensemble_inverse_design_fn([st.g for st in states], states.f, tds,
                                        compute_dtype="int8")
    with pytest.raises(ValueError, match="no member"):
        make_ensemble_inverse_design_fn([], states.f, tds)
