"""The λ-ensemble with runtime loss weights: the port against the JAX
package on the CPU (``parallel/ensemble.py``, ``make_pigan_step(
runtime_weights=True)``).

- One runtime-weights step with a non-default weight vector against the
  JAX step's, from the same weights, batch and draws: rows, Adam's first
  moments and G's BatchNorm stats within STEP_TOL (rtol and atol; JAX's
  BatchNorm variance is float32's one-pass form, the port's from float64
  sums).  With the settings' weights the runtime step is the static step,
  bit for bit.
- ``make_ensemble_multi_epoch_fn``, 3 members with their own weight rows, 2
  epochs on JAX's shuffle indices, against the JAX package's vmapped one:
  the port's trajectory tolerances of tests/test_torch_gan_step.py (8 Adam
  steps); members whose weights differ end apart, and member m is bit for
  bit a run of the one step on member m alone.

Narrow widths (G 48-24, D 40-20, F 16-32-48-32-16), 128 samples, B = 32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.data.dataset import ThzDataset, gather_batch
from pigan_thz_torch.interop import load_pigan_state_
from pigan_thz_torch.models import build_trio as t_build_trio
from pigan_thz_torch.parallel import (
    WEIGHT_NAMES,
    EnsembleSettings,
    init_ensemble_states,
    make_ensemble_epoch_fn,
    make_ensemble_multi_epoch_fn,
    make_ensemble_pigan_step,
    member_generator,
    weight_vector,
)
from pigan_thz_torch.train.state import init_pigan_state as t_init_pigan_state
from pigan_thz_torch.train.state import make_optimizers as t_make_optimizers
from pigan_thz_torch.train.steps import StepSettings as TSettings
from pigan_thz_torch.train.steps import make_pigan_step as t_make_pigan_step
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.data.dataset import build_dataset as j_build_dataset
from pigan_thz_tpu.data.dataset import epoch_indices as j_epoch_indices
from pigan_thz_tpu.data.dataset import gather_batch as j_gather_batch
from pigan_thz_tpu.models import build_trio as j_build_trio
from pigan_thz_tpu.parallel import ensemble as j_ens
from pigan_thz_tpu.train.state import init_pigan_state as j_init_pigan_state
from pigan_thz_tpu.train.state import make_optimizers as j_make_optimizers
from pigan_thz_tpu.train.steps import StepSettings as JSettings
from pigan_thz_tpu.train.steps import make_pigan_step as j_make_pigan_step

torch.set_num_threads(1)

N, B, E, M = 128, 32, 2, 3
SPE = N // B
NARROW = dict(g=(48, 24), d=(40, 20), f=(16, 32, 48, 32, 16))
STEP_TOL = 1e-5
# tests/test_torch_gan_step.py, 8 steps against the JAX XLA path
ROWS_RTOL, PARAM_ATOL, STATS_ATOL = 2e-3, 8e-4, 8e-3
GAUGE = ("main.0.bias", "main.3.bias")
WEIGHTS = ((1.0, 100.0, 10.0, 1.0, 5.0, 2.0, 0.5), (0.5, 30.0, 3.0, 2.0, 0.0, 0.0, 1.0),
           (1.0, 100.0, 10.0, 1.0, 1.0, 1.0, 0.1))


def _narrow(cfg):
    return cfg.replace(
        data=dataclasses.replace(cfg.data, num_samples=N),
        train=dataclasses.replace(cfg.train, batch_size=B, num_epochs=E),
        generator=dataclasses.replace(cfg.generator, hidden_dims=NARROW["g"]),
        discriminator=dataclasses.replace(cfg.discriminator, hidden_dims=NARROW["d"]),
        forward_model=dataclasses.replace(cfg.forward_model, hidden_dims=NARROW["f"]))


@pytest.fixture(scope="module")
def datasets():
    tc = _narrow(t_default_config())
    raw = synthetic_dataset(tc.data, device="cpu")
    jds = j_build_dataset(raw.spectra.numpy(), raw.params.numpy(), raw.metrics.numpy(),
                          _narrow(j_default_config()).data)
    tds = ThzDataset(*(torch.from_numpy(np.array(x, np.float32)) for x in jds))
    return jds, tds


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _trees(jst) -> dict:
    ga, da = jst.g_opt[1][0], jst.d_opt[1][0]
    return {
        "g": {"params": _np(jst.g.params), "batch_stats": _np(jst.g.extra["batch_stats"])},
        "d": {"params": _np(jst.d.params)}, "f": {"params": _np(jst.f.params)},
        "g_mu": _np(ga.mu), "g_nu": _np(ga.nu), "g_count": int(ga.count),
        "d_mu": _np(da.mu), "d_nu": _np(da.nu), "d_count": int(da.count),
        "step": int(jst.step),
    }


def _jax_trio():
    jc = _narrow(j_default_config())
    g, d, f = j_build_trio(jc)
    g_tx, d_tx, _ = j_make_optimizers(jc, SPE)
    return (g, d, f), (g_tx, d_tx)


def _port_trio():
    tc = _narrow(t_default_config())
    g, d, f = t_build_trio(tc, device="cpu", generator=torch.Generator().manual_seed(0))
    gtx, dtx, _ = t_make_optimizers(tc, SPE)
    return (g, d, f), (gtx, dtx)


def _port_state(jst=None):
    (g, d, f), (gtx, dtx) = _port_trio()
    st = t_init_pigan_state(g, d, f, gtx, dtx, 0, device="cpu")
    if jst is not None:
        load_pigan_state_(st, _trees(jst))
    return (gtx, dtx), st


def _payload(st) -> dict:
    return {k: v.detach().clone() for k, v in st.state_dict().items()
            if isinstance(v, torch.Tensor) and v.is_floating_point()}


def test_weight_vector_and_settings_match_jax():
    assert WEIGHT_NAMES == j_ens.WEIGHT_NAMES
    np.testing.assert_array_equal(weight_vector().numpy(), np.asarray(j_ens.weight_vector()))
    np.testing.assert_array_equal(
        weight_vector(maxwell=3.0, range_=0.7).numpy(),
        np.asarray(j_ens.weight_vector(maxwell=3.0, range_=0.7)))
    assert dataclasses.asdict(EnsembleSettings()) == dataclasses.asdict(j_ens.EnsembleSettings())


@pytest.mark.parametrize("detach", [False, True], ids=["through_f", "detached"])
def test_runtime_weights_step_matches_jax(detach, datasets):
    jds, tds = datasets
    (g, d, f), (jg_tx, jd_tx) = _jax_trio()
    jst = j_init_pigan_state(g, d, f, jg_tx, jd_tx, jax.random.PRNGKey(1))
    (gtx, dtx), tst = _port_state(jst)
    w = np.asarray(WEIGHTS[0], np.float32)
    idx = np.arange(B)
    jstep = j_make_pigan_step(g, d, f, jg_tx, jd_tx, JSettings(detach_forward=detach),
                              jds.param_lo, jds.param_hi, runtime_weights=True)
    jst, jm = jax.jit(jstep)(jst, j_gather_batch(jds, idx), jnp.asarray(w))
    tstep = t_make_pigan_step(gtx, dtx, TSettings(detach_forward=detach), tds.param_lo,
                              tds.param_hi, runtime_weights=True)
    tst, tm = tstep(tst, gather_batch(tds, torch.from_numpy(idx)), torch.from_numpy(w))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=k)
    (_, _), want = _port_state(jst)
    got, want = _payload(tst), _payload(want)
    for k in ("g_opt.m", "d_opt.m", *(k for k in want if "running_" in k)):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=k)


@pytest.mark.parametrize("settings", [TSettings(), TSettings(
    detach_forward=False, maxwell_w=5.0, lc_w=2.0, range_w=0.5, recon_w=30.0,
    physics_metrics_w=2.0, constraint_w=0.7, window_w=0.3)], ids=["defaults", "knobs"])
def test_runtime_step_with_the_settings_weights_is_the_static_step(settings, datasets):
    """One implementation: bit for bit over 3 steps (the constraint scale
    of the runtime step is 1)."""
    _, tds = datasets
    w = torch.tensor([settings.adv_w, settings.recon_w, settings.physics_spec_w,
                      settings.physics_metrics_w, settings.maxwell_w, settings.lc_w,
                      settings.range_w])
    runs = []
    for runtime in (False, True):
        (gtx, dtx), st = _port_state()
        step = t_make_pigan_step(gtx, dtx, settings, tds.param_lo, tds.param_hi,
                                 runtime_weights=runtime)
        rows = []
        for s in range(3):
            batch = gather_batch(tds, torch.arange(s * B, (s + 1) * B))
            _, m = step(st, batch, w if runtime else 1.0, s)
            rows.append(m)
        runs.append((_payload(st), rows))
    (a, ra), (b, rb) = runs
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(x[k], y[k]) for x, y in zip(ra, rb) for k in x)


def test_runtime_weights_shape_is_checked(datasets):
    _, tds = datasets
    (gtx, dtx), st = _port_state()
    step = t_make_pigan_step(gtx, dtx, TSettings(), runtime_weights=True)
    with pytest.raises(ValueError, match=r"\(7,\)"):
        step(st, gather_batch(tds, torch.arange(B)), torch.ones(6))


@pytest.fixture(scope="module")
def ensembles(datasets):
    """The 3-member λ-ensemble, 2 epochs, in both packages from the same
    initial members, on JAX's indices; and each member run alone on the
    same indices and seeds."""
    jds, tds = datasets
    (g, d, f), (jg_tx, jd_tx) = _jax_trio()
    # one frozen F shared by the members, as the sweep pretrains it
    fv = f.init({"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(5)},
                jnp.zeros((2, 4)), train=False)
    jstates = j_ens.init_ensemble_states(g, d, f, jg_tx, jd_tx, M, jax.random.PRNGKey(0),
                                         forward_variables=fv)
    members = [jax.tree.map(lambda x, m=m: x[m], jstates) for m in range(M)]
    weights = np.asarray(WEIGHTS, np.float32)
    key = jax.random.PRNGKey(1)
    idx = np.stack([np.asarray(j_epoch_indices(k, N, B)) for k in jax.random.split(key, E)])
    jstep = j_ens.make_ensemble_pigan_step(g, d, f, jg_tx, jd_tx,
                                           j_ens.EnsembleSettings(detach_forward=False),
                                           jds.param_lo, jds.param_hi)
    jout, jrows = j_ens.make_ensemble_multi_epoch_fn(jstep, B)(
        jstates, jds, key, jnp.asarray(weights), E)

    def port_members():
        (tg, td, tf), (gtx, dtx) = _port_trio()
        states = init_ensemble_states(tg, td, tf, gtx, dtx,
                                      [member_generator(3, m) for m in range(M)],
                                      device="cpu")
        for m in range(M):
            load_pigan_state_(states[m], _trees(members[m]))
        return states, gtx, dtx

    states, gtx, dtx = port_members()
    step = make_ensemble_pigan_step(gtx, dtx, EnsembleSettings(detach_forward=False),
                                    tds.param_lo, tds.param_hi)
    seeds = torch.arange(E * SPE) + 100
    indices = torch.from_numpy(idx).to(torch.int64)
    states, rows = make_ensemble_multi_epoch_fn(step, B)(
        states, tds, torch.Generator(), torch.from_numpy(weights), E, indices, seeds)
    # member m alone: the one step on its own state, the same batches and seeds
    solo, solo_rows = [], []
    for m in range(M):
        alone, gtx, dtx = port_members()
        st = alone[m]
        one = t_make_pigan_step(gtx, dtx, TSettings(detach_forward=False), tds.param_lo,
                                tds.param_hi, runtime_weights=True)
        per_epoch = []
        for e in range(E):
            ms = [one(st, gather_batch(tds, indices[e, s]), torch.from_numpy(weights[m]),
                      int(seeds[e * SPE + s]))[1]["g_loss"] for s in range(SPE)]
            per_epoch.append(torch.stack(ms).mean())
        solo.append(_payload(st))
        solo_rows.append(torch.stack(per_epoch))
    want = []
    for m in range(M):
        (_, _), st = _port_state(jax.tree.map(lambda x, m=m: x[m], jout))
        want.append(_payload(st))
    return dict(states=states, rows=rows, jrows=jrows, jstates=want, solo=solo,
                solo_rows=solo_rows)


def test_ensemble_rows_are_per_epoch_and_member(ensembles):
    rows = ensembles["rows"]
    assert set(rows) == set(ensembles["jrows"])
    for k, v in rows.items():
        assert tuple(v.shape) == (E, M), k
        assert bool(torch.isfinite(v).all()), k
    assert all(st.step == E * SPE and st.g_opt.count == E * SPE for st in ensembles["states"])


def test_ensemble_matches_jax(ensembles):
    rows, jrows = ensembles["rows"], ensembles["jrows"]
    for k in jrows:
        atol = 1.0 / (SPE * B) if k in ("d_accuracy", "violation_rate") else 1e-6
        np.testing.assert_allclose(rows[k].numpy(), np.asarray(jrows[k]), rtol=ROWS_RTOL,
                                   atol=atol, err_msg=k)
    for m, st in enumerate(ensembles["states"]):
        got, want = _payload(st), ensembles["jstates"][m]
        for k in ("g_params", "d_params"):
            a, b = got[k].clone(), want[k]
            if k == "g_params":
                pos = 0
                for name, p in st.g.named_parameters():
                    if name in GAUGE:
                        a[pos:pos + p.numel()] = b[pos:pos + p.numel()]
                    pos += p.numel()
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"member {m} {k}")
        for k in (k for k in want if "running_" in k):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                       atol=STATS_ATOL, err_msg=f"member {m} {k}")


def test_members_diverge_with_their_weights(ensembles):
    rows, states = ensembles["rows"], ensembles["states"]
    assert float(rows["g_loss"][-1, 0]) != float(rows["g_loss"][-1, 1])
    assert not torch.equal(states.g_params[0], states.g_params[1])
    # members 0 and 2 differ in maxwell / lc / range only
    assert float(rows["maxwell_loss"][-1, 0]) != float(rows["maxwell_loss"][-1, 2])


@pytest.mark.parametrize("member", range(M))
def test_member_is_a_solo_run_bit_for_bit(member, ensembles):
    got = _payload(ensembles["states"][member])
    want = ensembles["solo"][member]
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert torch.equal(ensembles["rows"]["g_loss"][:, member], ensembles["solo_rows"][member])


def test_one_epoch_fn_and_its_draws(datasets):
    """``make_ensemble_epoch_fn``: (M,) rows; the shuffle and seeds drawn
    from the generator, so one generator state gives one run; a weight
    matrix of another shape raises."""
    _, tds = datasets
    runs = []
    for _ in range(2):
        (tg, td, tf), (gtx, dtx) = _port_trio()
        states = init_ensemble_states(tg, td, tf, gtx, dtx,
                                      [member_generator(1, m) for m in range(2)],
                                      device="cpu")
        step = make_ensemble_pigan_step(gtx, dtx, EnsembleSettings(), tds.param_lo,
                                        tds.param_hi)
        epoch = make_ensemble_epoch_fn(step, B)
        states, rows = epoch(states, tds, torch.Generator().manual_seed(4),
                             torch.stack([weight_vector(), weight_vector(recon=1.0)]))
        assert rows["g_loss"].shape == (2,)
        runs.append(states.g_params.clone())
        with pytest.raises(ValueError, match=r"\(N, 7\)"):
            epoch(states, tds, torch.Generator(), torch.ones(3, 7))
    assert torch.equal(runs[0], runs[1])
