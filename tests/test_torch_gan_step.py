"""The eager PI-GAN step and its state: the port against the JAX package.

- ``PiGanState``: flat buffers, clone, finiteness, and the carry-over of a
  JAX ``PiGanState`` both ways (``load_pigan_state_`` / ``pigan_state_to_flax``);
- ``StepSettings`` field for field;
- the eager step's 2-epoch trajectory (8 steps) against the JAX XLA path
  ``make_multi_epoch_fn(make_pigan_step(...))`` from one JAX-initialised
  state, on the JAX package's shuffle indices, at narrow widths, for both
  ``detach_forward`` modes, ``d_update_every`` 2, constraint (with a
  per-epoch scale) + window + ``sigmoid_squash``, EMA, cycle, stability and
  ``wgan_gp`` (the latter two fed the JAX step's own noise and interpolation
  weights, drawn from its key chain).

Tolerances (fp32 on both sides, other summation orders, 8 Adam steps at lr
2e-4): per-epoch metric rows within ROWS_RTOL; parameters within PARAM_ATOL,
a few steps of lr (Adam divides each moment by its root, so an entry whose
gradient is at the rounding level moves by up to lr in either direction in
each package).  G's two Dense biases feed BatchNorm: their true gradient is
zero, both packages' computed ones are rounding noise, and they are the only
parameters left out (the gauge leaves).  BatchNorm running stats within
STATS_ATOL (they absorb the gauge leaves' walk); each tensor of Adam's first
moments within MOMENT_RTOL in relative L2 (they hold the last gradients,
which the drift of the parameters moves)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.data.dataset import ThzDataset
from pigan_thz_torch.interop import load_pigan_state_, pigan_state_to_flax
from pigan_thz_torch.models import build_trio as t_build_trio
from pigan_thz_torch.train.state import init_pigan_state as t_init_pigan_state
from pigan_thz_torch.train.state import make_optimizers as t_make_optimizers
from pigan_thz_torch.train.steps import StepSettings as TSettings
from pigan_thz_torch.train.steps import make_multi_epoch_fn as t_make_multi_epoch_fn
from pigan_thz_torch.train.steps import make_pigan_step as t_make_pigan_step
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.data.dataset import build_dataset as j_build_dataset
from pigan_thz_tpu.data.dataset import epoch_indices as j_epoch_indices
from pigan_thz_tpu.models import build_trio as j_build_trio
from pigan_thz_tpu.train.state import init_pigan_state as j_init_pigan_state
from pigan_thz_tpu.train.state import make_optimizers as j_make_optimizers
from pigan_thz_tpu.train.steps import StepSettings as JSettings
from pigan_thz_tpu.train.steps import make_multi_epoch_fn as j_make_multi_epoch_fn
from pigan_thz_tpu.train.steps import make_pigan_step as j_make_pigan_step

torch.set_num_threads(1)

N, B, E = 128, 32, 2
SPE = N // B
ROWS_RTOL, PARAM_ATOL, STATS_ATOL, MOMENT_RTOL = 2e-3, 8e-4, 8e-3, 2e-2
GAUGE = ("MLPBlock_0/Dense_0/bias", "MLPBlock_1/Dense_0/bias")
NARROW = dict(g=(48, 24), d=(40, 20), f=(16, 32, 48, 32, 16))

CASES = {
    "through_f": dict(detach_forward=False),
    "detached": dict(detach_forward=True),
    "d_every_2": dict(detach_forward=False, d_update_every=2),
    "constraint_window_squash": dict(detach_forward=False, constraint_w=0.7, window_w=0.3,
                                     sigmoid_squash=True),
    "ema": dict(detach_forward=True, ema_decay=0.9),
    "cycle": dict(detach_forward=False, cycle_w=1.0),
    "stability": dict(detach_forward=True, stability_w=0.5),
    "wgan_gp": dict(detach_forward=True, gan_loss="wgan_gp"),
}


def _narrow(cfg):
    return cfg.replace(
        data=dataclasses.replace(cfg.data, num_samples=N),
        train=dataclasses.replace(cfg.train, batch_size=B, num_epochs=E),
        generator=dataclasses.replace(cfg.generator, hidden_dims=NARROW["g"]),
        discriminator=dataclasses.replace(cfg.discriminator, hidden_dims=NARROW["d"]),
        forward_model=dataclasses.replace(cfg.forward_model, hidden_dims=NARROW["f"]))


@pytest.fixture(scope="module")
def datasets():
    """One dataset in both packages: the port's synthetic samples,
    normalised by the JAX package, then carried across as-is."""
    tc = _narrow(t_default_config())
    raw = synthetic_dataset(tc.data, device="cpu")
    jds = j_build_dataset(raw.spectra.numpy(), raw.params.numpy(), raw.metrics.numpy(),
                          _narrow(j_default_config()).data)
    tds = ThzDataset(*(torch.from_numpy(np.array(x, np.float32)) for x in jds))
    return jds, tds


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _trees(jst) -> dict:
    """A JAX PiGanState as the numpy pieces ``load_pigan_state_`` takes."""
    ga, da = jst.g_opt[1][0], jst.d_opt[1][0]
    out = {
        "g": {"params": _np(jst.g.params), "batch_stats": _np(jst.g.extra["batch_stats"])},
        "d": {"params": _np(jst.d.params)}, "f": {"params": _np(jst.f.params)},
        "g_mu": _np(ga.mu), "g_nu": _np(ga.nu), "g_count": int(ga.count),
        "d_mu": _np(da.mu), "d_nu": _np(da.nu), "d_count": int(da.count),
        "step": int(jst.step),
    }
    if jst.g_ema is not None:
        out["g_ema"] = _np(jst.g_ema)
    return out


def _jax_setup(settings: JSettings, seed=1):
    jc = _narrow(j_default_config())
    g, d, f = j_build_trio(jc)
    g_tx, d_tx, _ = j_make_optimizers(jc, SPE)
    jst = j_init_pigan_state(g, d, f, g_tx, d_tx, jax.random.PRNGKey(seed),
                             ema=settings.ema_decay > 0)
    return (g, d, f), (g_tx, d_tx), jst


def _port_state(ema: bool, seed=0):
    tc = _narrow(t_default_config())
    g, d, f = t_build_trio(tc, device="cpu", generator=torch.Generator().manual_seed(seed))
    gtx, dtx, _ = t_make_optimizers(tc, SPE)
    return (gtx, dtx), t_init_pigan_state(g, d, f, gtx, dtx, seed, device="cpu", ema=ema)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_step_settings_match_field_for_field():
    j = {f.name: f.default for f in dataclasses.fields(JSettings)}
    t = {f.name: f.default for f in dataclasses.fields(TSettings)}
    assert j == t
    jc, tc = j_default_config(), t_default_config()
    assert dataclasses.asdict(JSettings.from_config(jc, detach_forward=False, ema_decay=0.5)) \
        == dataclasses.asdict(TSettings.from_config(tc, detach_forward=False, ema_decay=0.5))
    assert TSettings.from_config(tc).detach_forward is True


def test_state_buffers_clone_and_finiteness():
    _, st = _port_state(ema=True)
    for module, flat in ((st.g, st.g_params), (st.d, st.d_params), (st.f, st.f_params)):
        params = list(module.parameters())
        assert params[0].data_ptr() == flat.data_ptr()
        assert sum(p.numel() for p in params) == flat.numel()
    assert not any(p.requires_grad for p in st.f.parameters()) and not st.f.training
    assert torch.equal(st.g_ema, st.g_params) and st.g_ema.data_ptr() != st.g_params.data_ptr()
    assert (st.step, st.g_opt.count, st.d_opt.count) == (0, 0, 0)
    other = st.clone()
    other.g_params.add_(1.0)
    other.batch_norms()[0].running_mean.add_(1.0)
    other.generator.manual_seed(99)
    assert not torch.equal(other.g_params, st.g_params)
    assert float(st.batch_norms()[0].running_mean.abs().max()) == 0.0
    assert torch.equal(other.g.main[0].weight.reshape(-1),
                       other.g_params[: other.g.main[0].weight.numel()])
    assert st.is_finite()
    st.batch_norms()[1].running_var[0] = float("nan")
    assert not st.is_finite()


def test_same_seed_gives_the_same_state():
    _, a = _port_state(ema=False, seed=5)
    _, b = _port_state(ema=False, seed=5)
    _, c = _port_state(ema=False, seed=6)
    assert torch.equal(a.g_params, b.g_params) and torch.equal(a.d_params, b.d_params)
    assert not torch.equal(a.g_params, c.g_params)
    assert a.g_ema is None


def test_state_carry_over_round_trip():
    _, _, jst = _jax_setup(JSettings(ema_decay=0.5))
    rng = np.random.default_rng(0)
    trees = _trees(jst)
    for key in ("g_mu", "g_nu", "d_mu", "d_nu", "g_ema"):
        trees[key] = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                                  trees[key])
    trees["g"]["batch_stats"] = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), trees["g"]["batch_stats"])
    trees.update(g_count=7, d_count=4, step=9)
    _, st = _port_state(ema=True)
    load_pigan_state_(st, trees)
    assert (st.g_opt.count, st.d_opt.count, st.step) == (7, 4, 9)
    w = st.g.main[0].weight          # still a view of the flat buffer
    assert w.data_ptr() == st.g_params.data_ptr()
    np.testing.assert_array_equal(
        w.detach().numpy(), trees["g"]["params"]["MLPBlock_0"]["Dense_0"]["kernel"].T)
    back = pigan_state_to_flax(st)
    for key, want in trees.items():
        if isinstance(want, int):
            assert back[key] == want, key
            continue
        got, want = _flat(back[key]), _flat(want)
        assert set(got) == set(want), key
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{key}/{name}")
    # without the buffer an EMA tree is refused
    _, plain = _port_state(ema=False)
    with pytest.raises(ValueError, match="g_ema"):
        load_pigan_state_(plain, trees)


def _jax_draws(rng, settings, steps):
    """The noise the JAX step draws from its key chain (steps.py: the state's
    key splits in 9 each step), as the port's per-step ``draws``."""
    out = []
    for _ in range(steps):
        ks = jax.random.split(rng, 9)
        rng = ks[0]
        out.append({
            "stability_noise": torch.from_numpy(np.array(jax.random.normal(ks[5], (B, 250)))),
            "gp_eps": torch.from_numpy(np.array(jax.random.uniform(ks[8], (B, 1)))),
        })
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_eager_trajectory_matches_jax_xla(case, datasets):
    jds, tds = datasets
    knobs = CASES[case]
    jset, tset = JSettings(**knobs), TSettings(**knobs)
    (g, d, f), (jg_tx, jd_tx), jst = _jax_setup(jset)
    (gtx, dtx), tst = _port_state(ema=tset.ema_decay > 0)
    load_pigan_state_(tst, _trees(jst))
    draws = _jax_draws(jst.rng, jset, E * SPE)
    key = jax.random.PRNGKey(11)
    idx = np.stack([np.asarray(j_epoch_indices(k, N, B)) for k in jax.random.split(key, E)])
    scales = np.array([1.0, 0.5], np.float32)
    jstep = j_make_pigan_step(g, d, f, jg_tx, jd_tx, jset, jds.param_lo, jds.param_hi)
    jfn = j_make_multi_epoch_fn(jstep, B, with_scale=True, unroll=1)
    jst, jrows = jfn(jst, jds, key, jnp.asarray(scales))
    tstep = t_make_pigan_step(gtx, dtx, tset, tds.param_lo, tds.param_hi)
    tfn = t_make_multi_epoch_fn(tstep, B)
    tst, trows = tfn(tst, tds, torch.from_numpy(scales), indices=torch.from_numpy(idx),
                     draws=draws)

    assert set(trows) == set(jrows)
    for k in jrows:
        atol = 1.0 / (SPE * B) if k in ("d_accuracy", "violation_rate") else 1e-6
        np.testing.assert_allclose(trows[k].numpy(), np.asarray(jrows[k]), rtol=ROWS_RTOL,
                                   atol=atol, err_msg=k)
    back, want = pigan_state_to_flax(tst), _trees(jst)
    assert (back["step"], back["g_count"], back["d_count"]) == (
        want["step"], want["g_count"], want["d_count"])
    assert back["g_count"] == E * SPE
    assert back["d_count"] == (E * SPE // 2 if knobs.get("d_update_every") == 2 else E * SPE)
    for key_, tol in (("g", PARAM_ATOL), ("d", PARAM_ATOL), ("g_ema", PARAM_ATOL),
                      ("g_mu", None), ("d_mu", None)):
        if key_ not in want:
            continue
        got_t = back[key_]["params"] if key_ in ("g", "d") else back[key_]
        want_t = want[key_]["params"] if key_ in ("g", "d") else want[key_]
        got_f, want_f = _flat(got_t), _flat(want_t)
        for name in want_f:
            if key_.startswith("g") and name in GAUGE:
                continue
            if tol is None:
                # (the critic's head bias has gradient 0 under wgan_gp)
                scale = max(np.linalg.norm(want_f[name]), 1e-6)
                rel = np.linalg.norm(got_f[name] - want_f[name]) / scale
                assert rel <= MOMENT_RTOL, (key_, name, rel)
                continue
            np.testing.assert_allclose(got_f[name], want_f[name], rtol=0, atol=tol,
                                       err_msg=f"{key_}/{name}")
    for a, b in zip(jax.tree.leaves(back["g"]["batch_stats"]),
                    jax.tree.leaves(want["g"]["batch_stats"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=STATS_ATOL)


def test_runtime_weights_and_unknown_loss_raise(datasets):
    """runtime_weights builds the λ-ensemble's step, which refuses a weight
    vector that is not the seven core weights; an unknown GAN loss raises
    (the runtime step itself: tests/test_torch_lambda_ensemble.py)."""
    _, tds = datasets
    (gtx, dtx), st = _port_state(ema=False)
    step = t_make_pigan_step(gtx, dtx, TSettings(), tds.param_lo, tds.param_hi,
                             runtime_weights=True)
    with pytest.raises(ValueError, match=r"shape \(7,\)"):
        step(st, tuple(t[:B] for t in tds[:5]), torch.ones(8))
    with pytest.raises(ValueError, match="hinge"):
        t_make_pigan_step(gtx, dtx, TSettings(gan_loss="hinge"))


def test_ema_needs_the_buffer(datasets):
    _, tds = datasets
    (gtx, dtx), st = _port_state(ema=False)
    fn = t_make_multi_epoch_fn(t_make_pigan_step(gtx, dtx, TSettings(ema_decay=0.9)), B)
    with pytest.raises(ValueError, match="g_ema"):
        fn(st, tds, torch.ones(1))


def test_stochastic_knobs_draw_from_the_step_seed(datasets):
    """Instance noise and augmentation: one seed, one trajectory; another
    seed, another; and no draw touches torch's global generator."""
    _, tds = datasets
    knobs = dict(instance_noise=0.05, augment_noise=0.05, augment_shift=0.02,
                 augment_scale=0.1)
    runs = []
    torch.manual_seed(123)
    states = [_port_state(ema=False, seed=1) for _ in range(3)]
    before = torch.get_rng_state()
    for ((gtx, dtx), st), seeds in zip(states, ([3, 4, 5, 6], [3, 4, 5, 6], [7, 8, 9, 10])):
        fn = t_make_multi_epoch_fn(t_make_pigan_step(gtx, dtx, TSettings(**knobs)), B)
        idx = torch.arange(N).reshape(1, SPE, B)
        st, rows = fn(st, tds, torch.ones(1), indices=idx, seeds=torch.tensor(seeds))
        assert all(bool(torch.isfinite(v).all()) for v in rows.values())
        runs.append(st.g_params.clone())
    assert torch.equal(torch.get_rng_state(), before)
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
