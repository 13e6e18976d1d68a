"""PI-GAN training through the kernel path on the CPU: ``ops/gan_train.py``.

On CPU tensors the wrapper runs the kernel's plain version (hand-derived
backward, no autograd), the port's analogue of Pallas interpret mode.  Held
here, at the baseline widths the kernel needs (128 samples, batch 32, 2
epochs = 8 steps, a freshly initialised F as in tests/test_megakernel.py):

- the plain version against the eager autograd step over the kernel's
  envelope (both ``detach_forward`` modes, gated D updates, constraint with a
  per-epoch scale, window, ``sigmoid_squash``, EMA, non-default range, labels
  and weights);
- the plain version against the JAX package's Pallas kernel itself in
  interpret mode, one short case;
- ``build_streams``' schedule lanes against the JAX package's
  ``_build_streams`` (lr, bias corrections, D gate, constraint scale);
- the envelope, the refusals, the optimiser overrides and the wrapper's
  argument checks.

Tolerances: per-epoch rows within ROWS_RTOL; parameters within PARAM_ATOL,
a few steps of lr 2e-4 (Adam turns rounding in near-zero gradients into
steps of up to lr); G's two Dense biases before BatchNorm (the gauge leaves:
true gradient zero, computed gradient rounding noise) are the only
parameters left out; BatchNorm running stats within STATS_ATOL."""

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
from pigan_thz_torch.ops import gan_train as gt
from pigan_thz_torch.train.schedules import cosine_schedule, step_schedule
from pigan_thz_torch.train.state import init_pigan_state, make_optimizers
from pigan_thz_torch.train.steps import StepSettings, make_multi_epoch_fn, make_pigan_step
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.data.dataset import build_dataset as j_build_dataset
from pigan_thz_tpu.data.dataset import epoch_indices as j_epoch_indices
from pigan_thz_tpu.models import build_trio as j_build_trio
from pigan_thz_tpu.ops import megakernel as jmk
from pigan_thz_tpu.train.schedules import cosine_schedule as j_cosine_schedule
from pigan_thz_tpu.train.schedules import step_schedule as j_step_schedule
from pigan_thz_tpu.train.state import init_pigan_state as j_init_pigan_state
from pigan_thz_tpu.train.state import make_optimizers as j_make_optimizers
from pigan_thz_tpu.train.steps import StepSettings as JSettings

torch.set_num_threads(1)

N, B, E = 128, 32, 2
SPE = N // B
ROWS_RTOL, PARAM_ATOL, STATS_ATOL = 1e-3, 8e-4, 8e-3
PALLAS_ROWS_RTOL, PALLAS_PARAM_ATOL = 5e-3, 1.2e-3

CASES = {
    "through_f": dict(detach_forward=False),
    "detached": dict(detach_forward=True),
    "knob_mix": dict(detach_forward=False, d_update_every=2, constraint_w=0.7, window_w=0.3,
                     sigmoid_squash=True, ema_decay=0.9),
    "d_every_3": dict(detach_forward=True, d_update_every=3),
    "weights_range_labels": dict(detach_forward=False, adv_w=0.5, recon_w=20.0,
                                 physics_metrics_w=2.0, maxwell_w=3.0, lc_w=0.5, range_w=1.0,
                                 range_lo=-0.5, range_hi=0.5, label_real=1.0, label_fake=0.0,
                                 constraint_w=1.0),
}


def _small(cfg):
    return cfg.replace(data=dataclasses.replace(cfg.data, num_samples=N),
                       train=dataclasses.replace(cfg.train, batch_size=B, num_epochs=E))


@pytest.fixture(scope="module")
def tcfg():
    return _small(t_default_config())


@pytest.fixture(scope="module")
def datasets(tcfg):
    raw = synthetic_dataset(tcfg.data, device="cpu")
    jds = j_build_dataset(raw.spectra.numpy(), raw.params.numpy(), raw.metrics.numpy(),
                          _small(j_default_config()).data)
    tds = ThzDataset(*(torch.from_numpy(np.array(x, np.float32)) for x in jds))
    return jds, tds


def _state(tcfg, settings, seed=0):
    g, d, f = t_build_trio(tcfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    gtx, dtx, _ = make_optimizers(tcfg, SPE)
    st = init_pigan_state(g, d, f, gtx, dtx, seed, device="cpu", ema=settings.ema_decay > 0)
    return (gtx, dtx), st


def _assert_states_close(a, b, spec, param_atol=PARAM_ATOL):
    keep = ~spec.gauge_mask("cpu")
    torch.testing.assert_close(a.g_params[keep], b.g_params[keep], rtol=0, atol=param_atol)
    torch.testing.assert_close(a.d_params, b.d_params, rtol=0, atol=param_atol)
    if a.g_ema is not None:
        torch.testing.assert_close(a.g_ema[keep], b.g_ema[keep], rtol=0, atol=param_atol)
    for m, n in zip(a.batch_norms(), b.batch_norms()):
        torch.testing.assert_close(m.running_mean, n.running_mean, rtol=0, atol=STATS_ATOL)
        torch.testing.assert_close(m.running_var, n.running_var, rtol=0, atol=STATS_ATOL)
        assert int(m.num_batches_tracked) == int(n.num_batches_tracked)
    assert (a.step, a.g_opt.count, a.d_opt.count) == (b.step, b.g_opt.count, b.d_opt.count)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_kernel_matches_eager_step(case, tcfg, datasets):
    _, tds = datasets
    settings = StepSettings.from_config(tcfg, **CASES[case])
    (gtx, dtx), eager_state = _state(tcfg, settings)
    kernel_state = eager_state.clone()
    idx, seeds = gt.resolve_draws(torch.Generator().manual_seed(4), N, B, E)
    scales = torch.tensor([1.0, 0.25])
    eager = make_multi_epoch_fn(
        make_pigan_step(gtx, dtx, settings, tds.param_lo, tds.param_hi), B)
    kernel = gt.make_gan_epoch_fn(tcfg, settings)
    before = dict(gt.LAUNCHES)
    eager_state, erows = eager(eager_state, tds, scales, indices=idx, seeds=seeds)
    kernel_state, krows = kernel(kernel_state, tds, scales, indices=idx, seeds=seeds)
    assert gt.LAUNCHES == before          # CPU tensors: the plain version
    assert set(krows) == set(erows)
    assert ("constraint_loss" in krows) == bool(settings.constraint_w)
    for k in erows:
        atol = 1.0 / (SPE * B) if k in ("d_accuracy", "violation_rate") else 1e-6
        torch.testing.assert_close(krows[k], erows[k], rtol=ROWS_RTOL, atol=atol, msg=k)
    _assert_states_close(kernel_state, eager_state, gt.gan_train_spec(tcfg, settings))
    every = settings.d_update_every
    assert kernel_state.d_opt.count == len(range(0, E * SPE, every))


def test_plain_kernel_matches_the_pallas_kernel_in_interpret_mode(tcfg, datasets):
    """One epoch (4 steps) through the JAX package's kernel in interpret
    mode, as tests/test_megakernel.py runs it, and through the port's plain
    version from the same state on the same batches.  Rows within
    PALLAS_ROWS_RTOL: on this case the JAX package's own two paths, the
    kernel and the XLA step, are 2.2e-3 apart in ``recon_metrics_loss``
    (a freshly initialised F is steep in its input), and the port's plain
    version lies between them.  Parameters within PALLAS_PARAM_ATOL, six
    steps of lr (measured 9.0e-4 on 6 of G's 128000 first-layer weights)."""
    jds, tds = datasets
    jc = _small(j_default_config())
    jset = JSettings.from_config(jc, detach_forward=False)
    g, d, f = j_build_trio(jc)
    g_tx, d_tx, _ = j_make_optimizers(jc, SPE)
    jst = j_init_pigan_state(g, d, f, g_tx, d_tx, jax.random.PRNGKey(1))
    settings = StepSettings.from_config(tcfg, detach_forward=False)
    _, tst = _state(tcfg, settings)
    ga, da = jst.g_opt[1][0], jst.d_opt[1][0]
    np32 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float32), tree)  # noqa: E731
    load_pigan_state_(tst, {
        "g": {"params": np32(jst.g.params), "batch_stats": np32(jst.g.extra["batch_stats"])},
        "d": {"params": np32(jst.d.params)}, "f": {"params": np32(jst.f.params)},
        "g_mu": np32(ga.mu), "g_nu": np32(ga.nu), "g_count": 0,
        "d_mu": np32(da.mu), "d_nu": np32(da.nu), "d_count": 0, "step": 0})
    key = jax.random.PRNGKey(7)
    idx = np.stack([np.asarray(j_epoch_indices(k, N, B)) for k in jax.random.split(key, 1)])
    pallas = jmk.make_pallas_multi_epoch_fn(jc, jset, interpret=True)
    jst, jrows = pallas(jst, jds, key, jnp.ones((1,), jnp.float32))
    tst, trows = gt.make_gan_epoch_fn(tcfg, settings)(tst, tds, torch.ones(1),
                                                      indices=torch.from_numpy(idx))
    assert set(trows) == set(jmk.METRIC_KEYS) == set(gt.METRIC_KEYS)
    for k in gt.METRIC_KEYS:
        atol = 1.0 / (SPE * B) if k in ("d_accuracy", "violation_rate") else 1e-6
        np.testing.assert_allclose(trows[k].numpy(), np.asarray(jrows[k]),
                                   rtol=PALLAS_ROWS_RTOL, atol=atol, err_msg=k)
    back = pigan_state_to_flax(tst)
    for a, b in zip(jax.tree.leaves(back["d"]["params"]), jax.tree.leaves(np32(jst.d.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
    for a, b in zip(jax.tree.leaves(back["g"]["batch_stats"]),
                    jax.tree.leaves(np32(jst.g.extra["batch_stats"]))):
        np.testing.assert_allclose(a, b, rtol=0, atol=STATS_ATOL)
    flat = jax.tree_util.tree_flatten_with_path(np32(jst.g.params))[0]
    for (path, want), got in zip(flat, jax.tree.leaves(back["g"]["params"])):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name in ("MLPBlock_0/Dense_0/bias", "MLPBlock_1/Dense_0/bias"):
            continue                                            # the gauge leaves
        np.testing.assert_allclose(got, want, rtol=0, atol=PALLAS_PARAM_ATOL, err_msg=name)
    assert back["g_count"] == int(jst.g_opt[1][0].count) == SPE


@pytest.mark.parametrize("k_d", [1, 2, 3])
def test_schedule_lanes_match_the_jax_prologue(k_d, tcfg, datasets):
    """lr_g, lr_d, the four bias corrections, the D gate and the constraint
    scale of a chunk that starts mid-run (step 5, G's count 5, D's count 3),
    and the gathered batches."""
    jds, tds = datasets
    jc = _small(j_default_config())
    jc = jc.replace(train=dataclasses.replace(jc.train, num_epochs=6))
    tc = tcfg.replace(train=dataclasses.replace(tcfg.train, num_epochs=6))
    key = jax.random.PRNGKey(3)
    scales = np.array([1.0, 0.5, 0.25], np.float32)
    out = jmk._build_streams(
        jc, JSettings(d_update_every=k_d), k_d,
        lambda spe: j_cosine_schedule(jc.train.lr_g, jc.train.num_epochs, spe, 0.01),
        lambda spe: j_step_schedule(jc.train.lr_d, jc.train.num_epochs, spe, 0.5, 0.25),
        jax.random.PRNGKey(0), jnp.int32(5), jnp.int32(5), jnp.int32(3), jds, key,
        jnp.asarray(scales))
    spec_g, par_g, met_g, sched = (np.asarray(x) for x in out[:4])
    idx = np.stack([np.asarray(j_epoch_indices(k, N, B)) for k in jax.random.split(key, 3)])
    got = gt.build_streams(
        tds, torch.from_numpy(idx), torch.from_numpy(scales), 5, 5, 3, k_d,
        cosine_schedule(tc.train.lr_g, tc.train.num_epochs, SPE, 0.01),
        step_schedule(tc.train.lr_d, tc.train.num_epochs, SPE, 0.5, 0.25))
    steps = 3 * SPE
    assert tuple(got.sched.shape) == (steps, len(gt.SCHED_LANES)) and sched.shape[0] == steps
    np.testing.assert_allclose(got.sched.numpy(), sched[:, 0, :8], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.sched[:, 6].numpy(), sched[:, 0, 6])       # the gate
    np.testing.assert_array_equal(got.spectra.numpy(), spec_g[:, :, :250])
    np.testing.assert_array_equal(got.params.numpy(), par_g[:, :, :4])
    np.testing.assert_array_equal(got.metrics_norm.numpy(), met_g[:, :, :8])
    np.testing.assert_array_equal(got.param_lo.numpy(), np.asarray(out[-2])[0, :4])
    np.testing.assert_array_equal(got.param_hi.numpy(), np.asarray(out[-1])[0, :4])


def test_flat_layout_is_the_kernel_layout(tcfg):
    settings = StepSettings.from_config(tcfg)
    _, st = _state(tcfg, settings)
    spec = gt.gan_train_spec(tcfg, settings)
    assert (spec.num_g, spec.num_d) == (st.g_params.numel(), st.d_params.numel())
    assert spec.f_spec.num_params == st.f_params.numel()
    for views, module in ((spec.g_views(st.g_params), st.g), (spec.d_views(st.d_params), st.d)):
        params = list(module.parameters())
        assert len(views) == len(params)
        for v, p in zip(views, params):
            assert v.shape == p.shape and v.data_ptr() == p.data_ptr()
    mask = spec.gauge_mask("cpu")
    b1, b2 = st.g.main[0].bias, st.g.main[3].bias
    assert int(mask.sum()) == b1.numel() + b2.numel() == 768
    first = int(mask.nonzero()[0])
    assert st.g_params[first:].data_ptr() == b1.data_ptr()
    assert gt.workspace_floats(spec, 64) > spec.num_g + spec.num_d


def test_envelope_and_refusals(tcfg):
    base = StepSettings.from_config(tcfg)
    rep = dataclasses.replace
    assert gt.supports_gan_kernel(tcfg, base) is None
    for knobs in (dict(detach_forward=False), dict(d_update_every=3), dict(constraint_w=1.0),
                  dict(window_w=0.5), dict(sigmoid_squash=True), dict(ema_decay=0.99),
                  dict(kl_w=1.0), dict(adv_w=0.0), dict(range_lo=-1.0, label_real=1.0)):
        s = rep(base, **knobs)
        assert gt.supports_gan_kernel(tcfg, s) is None
    assert "gan_loss" in gt.supports_gan_kernel(tcfg, rep(base, gan_loss="hinge"))
    assert "generator" in gt.supports_gan_kernel(
        tcfg.replace(generator=rep(tcfg.generator, hidden_dims=(256, 128))), base)
    assert "norm" in gt.supports_gan_kernel(
        tcfg.replace(generator=rep(tcfg.generator, norm="layer")), base)
    assert "discriminator" in gt.supports_gan_kernel(
        tcfg.replace(discriminator=rep(tcfg.discriminator, hidden_dims=(64, 32))), base)
    assert "forward" in gt.supports_gan_kernel(
        tcfg.replace(forward_model=rep(tcfg.forward_model, hidden_dims=(64, 64))), base)
    assert "leaky" in gt.supports_gan_kernel(
        tcfg.replace(discriminator=rep(tcfg.discriminator, leaky_slope=0.1)), base)
    assert "grad_clip" in gt.supports_gan_kernel(
        tcfg.replace(train=rep(tcfg.train, grad_clip=0.0)), base)
    # no TPU tiling rule: a batch that is no multiple of 8 is inside
    assert gt.supports_gan_kernel(tcfg.replace(train=rep(tcfg.train, batch_size=100)),
                                  base) is None
    with pytest.raises(ValueError, match="unsupported"):
        gt.make_gan_epoch_fn(tcfg, rep(base, gan_loss="hinge"))


@pytest.mark.parametrize("knobs", [dict(gan_loss="wgan_gp"), dict(stability_w=0.1),
                                   dict(cycle_w=0.1), dict(instance_noise=0.05),
                                   dict(augment_noise=0.05), dict(augment_shift=0.02),
                                   dict(augment_scale=0.1)],
                         ids=lambda k: next(iter(k)))
def test_kernel_refuses_what_it_does_not_take_yet(knobs, tcfg):
    settings = StepSettings.from_config(tcfg, **knobs)
    reason = gt.supports_gan_kernel(tcfg, settings)
    assert "does not take" in reason and reason.endswith("K2's remaining paths)")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2"):
        gt.make_gan_epoch_fn(tcfg, settings)


def test_bf16_is_refused(tcfg):
    cfg = tcfg.replace(train=dataclasses.replace(tcfg.train, compute_dtype="bfloat16"))
    with pytest.raises(NotImplementedError, match="bfloat16"):
        gt.make_gan_epoch_fn(cfg, StepSettings.from_config(cfg))


def test_overrides_set_the_lanes_and_need_a_horizon(tcfg, datasets):
    _, tds = datasets
    settings = StepSettings.from_config(tcfg)
    with pytest.raises(ValueError, match="horizon_epochs"):
        gt.make_gan_epoch_fn(tcfg, settings, lr_g=1e-3)
    (_, _), st = _state(tcfg, settings)
    base = st.clone()
    fn = gt.make_gan_epoch_fn(tcfg, settings, lr_g=1e-3, schedule_d="constant",
                              horizon_epochs=1)
    idx = torch.arange(N).reshape(1, SPE, B)
    st, _ = fn(st, tds, torch.ones(1), indices=idx)
    base, _ = gt.make_gan_epoch_fn(tcfg, settings)(base, tds, torch.ones(1), indices=idx)
    moved = (st.g_params - base.g_params).abs().max()
    assert float(moved) > 1e-3                     # five times the default lr
    assert st.step == base.step == SPE


def test_wrapper_checks_its_arguments(tcfg, datasets):
    _, tds = datasets
    settings = StepSettings.from_config(tcfg, ema_decay=0.9)
    _, st = _state(tcfg, settings)
    spec = gt.gan_train_spec(tcfg, settings)
    idx = torch.arange(N).reshape(1, SPE, B)
    streams = gt.build_streams(tds, idx, torch.ones(1), 0, 0, 0, 1,
                               cosine_schedule(2e-4, 2, SPE, 0.01),
                               step_schedule(2e-4, 2, SPE, 0.5, 0.25))
    bufs = gt.state_buffers(st)
    with pytest.raises(ValueError, match="g_ema"):
        gt.gan_train(bufs._replace(g_ema=None), streams, spec)
    with pytest.raises(ValueError, match="g_m"):
        gt.gan_train(bufs._replace(g_m=bufs.g_m[:-1]), streams, spec)
    with pytest.raises(ValueError, match="float32"):
        gt.gan_train(bufs._replace(d=bufs.d.double()), streams, spec)
    with pytest.raises(ValueError, match="sched"):
        gt.gan_train(bufs, streams._replace(sched=streams.sched[:, :7]), spec)
    with pytest.raises(ValueError, match="bn"):
        gt.gan_train(bufs._replace(bn=bufs.bn[:2]), streams, spec)
    empty = streams._replace(spectra=streams.spectra[:0], params=streams.params[:0],
                             metrics_norm=streams.metrics_norm[:0], sched=streams.sched[:0])
    before = st.g_params.clone()
    assert gt.gan_train(bufs, empty, spec).shape == (0, gt.ROW_WIDTH)
    assert torch.equal(st.g_params, before)


def test_state_diffs_and_float64_yardstick(tcfg, datasets):
    _, tds = datasets
    settings = StepSettings.from_config(tcfg, detach_forward=False)
    _, st = _state(tcfg, settings)
    spec = gt.gan_train_spec(tcfg, settings)
    idx = torch.arange(B).reshape(1, 1, B)
    streams = gt.build_streams(tds, idx, torch.ones(1), 0, 0, 0, 1,
                               cosine_schedule(2e-4, 2, SPE, 0.01),
                               step_schedule(2e-4, 2, SPE, 0.5, 0.25))
    a, b = st.clone(), st.clone()
    start = gt.state_buffers(st.clone())
    same = gt.state_diffs(gt.state_buffers(a), gt.state_buffers(b), start, spec)
    assert all(v == (0.0, 0.0) for v in same.values())
    rows32 = gt.gan_train_plain(gt.state_buffers(a), streams, spec)
    exact = gt.to_double(gt.state_buffers(b))
    rows64 = gt.gan_train_plain(exact, gt.to_double(streams), spec)
    assert rows64.dtype == torch.float64 and exact.g.dtype == torch.float64
    torch.testing.assert_close(rows32.double(), rows64, rtol=1e-4, atol=1e-6)
    keep = ~spec.gauge_mask("cpu")
    err = torch.linalg.norm(a.g_opt.m.double()[keep] - exact.g_m[keep]) / torch.linalg.norm(
        exact.g_m[keep])
    assert float(err) <= 1e-3
    # against the start itself the distance is the whole of what the step changed
    diffs = gt.state_diffs(start, gt.state_buffers(a), start, spec)
    assert set(diffs) == {"g", "d", "g_m", "d_m", "g_v", "d_v", "bn"}
    assert all(abs(r - 1.0) < 1e-12 and m > 0 for m, r in diffs.values())
    # the float32 step against float64, tensor by tensor: rounding, no more
    errs = gt.step_errors(gt.state_buffers(a), exact, start, spec)
    assert {"g_m[0]", "g_v[0]", "g_p[0]", "d_p[5]", "bn[3]"} <= set(errs)
    assert not any(k.startswith(("g_m[1]", "g_p[5]")) for k in errs)    # gauge leaves
    assert max(errs.values()) <= 1e-3, errs
    # a step that moved the parameters at half the learning rate is off by half
    slow = gt.state_buffers(a)
    slow = slow._replace(g=(start.g + 0.5 * (slow.g - start.g)))
    assert 0.4 < gt.step_errors(slow, exact, start, spec)["g_p[0]"] < 0.6
