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
- the second G passes (cycle, stability) and the noise streams (instance
  noise, augmentation): against the eager step from the same seeds, against
  the JAX XLA step on the JAX prologue's own streams (narrow widths), against
  the Pallas kernel in interpret mode (one case at the baseline widths),
  the float64 plain version against float64 autograd to 1e-10, and each
  deliberate fault of the plain version seen by the comparison;
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
from pigan_thz_tpu.train.steps import make_multi_epoch_fn as j_make_multi_epoch_fn
from pigan_thz_tpu.train.steps import make_pigan_step as j_make_pigan_step

torch.set_num_threads(1)

N, B, E = 128, 32, 2
SPE = N // B
ROWS_RTOL, PARAM_ATOL, STATS_ATOL = 1e-3, 8e-4, 8e-3
PALLAS_ROWS_RTOL, PALLAS_PARAM_ATOL = 5e-3, 1.2e-3
# bfloat16 operands.  Where the two implementations' float32 upstreams differ
# by an ulp, the rounding of an operand can land on the other bfloat16
# neighbour (a step of 2^-8 relative), and G's BatchNorms spread that over
# the batch.  How much that contributes is measured by the port's own plain
# version accumulating in float32 and in float64 from the same rounded
# operands: over one epoch of 4 steps up to 7.8e-3 relative in the rows (the
# LC loss, a difference of nearly equal terms), and, relative to what the
# epoch changed, 1.4e-3 in D's parameters, 5.7e-3 in D's first moments,
# 2.6e-3 in the BatchNorm stats and 0.35-0.52 in G's parameters and moments
# (Adam's first steps are lr x sign(g), and a flip moves a sign).  The JAX
# kernel lies as far from the port as that.  BF16_* hold the epoch to twice
# to four times those; G is held at its first step (below).
BF16_ROWS_RTOL = 2e-2
BF16_PART_RTOL = {"d": 5e-3, "d_m": 2e-2, "d_v": 1e-2, "bn": 1e-2, "g": 1.0, "g_m": 1.0,
                  "g_v": 1.0}

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
    # the second G passes and the noise streams: the eager step draws its
    # noise from the step's seed, build_streams the same draws
    "cycle_through_f": dict(detach_forward=False, cycle_w=1.0, adv_w=0.0, d_update_every=2),
    "cycle_detached": dict(detach_forward=True, cycle_w=1.0),
    "stability": dict(detach_forward=False, stability_w=1.0),
    "second_passes_mix": dict(detach_forward=False, stability_w=1.0, cycle_w=0.5,
                              sigmoid_squash=True, constraint_w=3.0, window_w=2.0),
    "instance_noise": dict(detach_forward=True, instance_noise=0.05),
    "augmentation": dict(detach_forward=False, augment_noise=0.05, augment_shift=0.02,
                         augment_scale=0.1),
    "all_four": dict(detach_forward=False, cycle_w=1.0, stability_w=1.0, instance_noise=0.05,
                     augment_noise=0.05, augment_shift=0.02, augment_scale=0.1,
                     d_update_every=2, ema_decay=0.9),
    # WGAN-GP: the critic loss, the penalty and its second-order backward; with
    # D every 2nd step the eps draw moves the stability noise on alternate steps
    "wgan_gp_through_f": dict(detach_forward=False, gan_loss="wgan_gp"),
    "wgan_gp_d_every_2_noise": dict(detach_forward=True, gan_loss="wgan_gp", d_update_every=2,
                                    stability_w=1.0, instance_noise=0.05, gp_weight=5.0),
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


@pytest.mark.parametrize("knobs", [dict(gan_loss="wgan_gp")], ids=lambda k: next(iter(k)))
def test_kernel_refuses_what_it_does_not_take_yet(knobs, tcfg):
    """WGAN-GP is the kernel's own path now: inside the envelope, its spec
    flag, gp_weight and eps stream set; the kernel refuses no setting that
    the TPU kernel computes in its body."""
    settings = StepSettings.from_config(tcfg, gp_weight=7.0, **knobs)
    assert gt.supports_gan_kernel(tcfg, settings) is None
    spec = gt.gan_train_spec(tcfg, settings)
    assert spec.wgan and spec.gp_weight == 7.0 and not spec.bf16
    grew = dict(gt.workspace_layout(spec, 64))
    assert grew["gvec"] == grew["gt"] == 64 * 254 and grew["du_g"] == 64 * 512
    assert "gvec" not in dict(gt.workspace_layout(gt.gan_train_spec(
        tcfg, StepSettings.from_config(tcfg)), 64))
    assert gt.make_gan_epoch_fn(tcfg, settings) is not None


def test_bf16_is_refused(tcfg):
    """bfloat16 operands are the kernel's own path; bfloat16 Adam moments
    are refused, as the JAX package's kernels refuse them (the eager step
    runs them)."""
    cfg = tcfg.replace(train=dataclasses.replace(tcfg.train, compute_dtype="bfloat16"))
    settings = StepSettings.from_config(cfg)
    assert gt.supports_gan_kernel(cfg, settings) is None and gt.gan_train_spec(cfg, settings).bf16
    moments = cfg.replace(train=dataclasses.replace(cfg.train, adam_state_dtype="bfloat16"))
    assert "adam_state_dtype" in gt.supports_gan_kernel(moments, settings)
    with pytest.raises(ValueError, match="adam_state_dtype"):
        gt.make_gan_epoch_fn(moments, settings)


@pytest.mark.parametrize("knobs", [dict(stability_w=0.1), dict(cycle_w=0.1),
                                   dict(instance_noise=0.05), dict(augment_noise=0.05),
                                   dict(augment_shift=0.02), dict(augment_scale=0.1)],
                         ids=lambda k: next(iter(k)))
def test_kernel_takes_the_second_passes_and_the_noise_streams(knobs, tcfg, datasets):
    """Each knob is inside the envelope, sets its field of the spec and its
    stream, and only then takes scratch."""
    _, tds = datasets
    settings = StepSettings.from_config(tcfg, **knobs)
    assert gt.supports_gan_kernel(tcfg, settings) is None
    spec, base = gt.gan_train_spec(tcfg, settings), gt.gan_train_spec(
        tcfg, StepSettings.from_config(tcfg))
    assert (spec.cycle_w, spec.stability_w, spec.use_inoise) == (
        settings.cycle_w, settings.stability_w, settings.instance_noise > 0)
    idx, seeds = gt.resolve_draws(torch.Generator().manual_seed(4), N, B, 1)
    args = (tds, idx, torch.ones(1), 0, 0, 0, 1, cosine_schedule(2e-4, 2, SPE, 0.01),
            step_schedule(2e-4, 2, SPE, 0.5, 0.25))
    if spec.use_inoise or spec.stability_w or settings.augments:
        with pytest.raises(ValueError, match="seeds"):
            gt.build_streams(*args, settings=settings)
    streams = gt.build_streams(*args, settings=settings, seeds=seeds)
    clean = gt.build_streams(*args)
    assert (streams.inoise is not None) == spec.use_inoise
    assert (streams.stab is not None) == (spec.stability_w > 0)
    assert torch.equal(streams.spectra, clean.spectra) != settings.augments
    if settings.augments:
        assert float(streams.spectra.max()) <= 0.0
    if spec.use_inoise:
        assert tuple(streams.inoise.shape) == (SPE, 2 * B, 250)
        assert abs(float(streams.inoise.std()) - 0.05) < 5e-3
    if spec.stability_w:
        noise = streams.stab - streams.spectra
        assert abs(float(noise.std()) - settings.stability_noise) < 1e-3
    grew = gt.workspace_floats(spec, 64) - gt.workspace_floats(base, 64)
    assert (grew > 0) == bool(spec.cycle_w or spec.stability_w or spec.use_inoise)
    names = [n for n, _ in gt.workspace_layout(spec, 64)]
    assert names[-1] == "norm_partials" and len(set(names)) == len(names)
    # a stream the spec does not expect, or one it misses, is refused
    _, st = _state(tcfg, settings)
    flipped = streams._replace(
        inoise=None if spec.use_inoise else torch.zeros(SPE, 2 * B, 250))
    with pytest.raises(ValueError, match="stream inoise"):
        gt.gan_train(gt.state_buffers(st), flipped, spec)


def test_streams_draw_what_the_eager_step_draws(tcfg, datasets):
    """``build_streams`` and the eager step seed one generator per step and
    draw in one order (augmentation, instance noise, stability noise): the
    streams are bit for bit what the step would compute, and ``draws``
    replace the two noises for both alike."""
    from pigan_thz_torch.ops.augment import augment_spectra

    _, tds = datasets
    settings = StepSettings.from_config(tcfg, instance_noise=0.05, stability_w=1.0,
                                        augment_noise=0.05, augment_shift=0.02,
                                        augment_scale=0.1)
    idx, seeds = gt.resolve_draws(torch.Generator().manual_seed(9), N, B, 1)
    args = (tds, idx, torch.ones(1), 0, 0, 0, 1, cosine_schedule(2e-4, 2, SPE, 0.01),
            step_schedule(2e-4, 2, SPE, 0.5, 0.25))
    streams = gt.build_streams(*args, settings=settings, seeds=seeds)
    for t in range(SPE):
        gen = torch.Generator().manual_seed(int(seeds[t]))
        spectra = augment_spectra(gen, tds.spectra[idx[0, t]], noise_level=0.05,
                                  freq_shift=0.02, amp_scale=0.1)
        inoise = 0.05 * torch.randn((2 * B, 250), generator=gen)
        noisy = spectra + settings.stability_noise * torch.randn((B, 250), generator=gen)
        assert torch.equal(streams.spectra[t], spectra)
        assert torch.equal(streams.inoise[t], inoise)
        assert torch.equal(streams.stab[t], noisy)
    given = [{"instance_noise": torch.full((2 * B, 250), float(t)),
              "stability_noise": torch.full((B, 250), -float(t))} for t in range(SPE)]
    with_draws = gt.build_streams(*args, settings=settings, seeds=seeds, draws=given)
    assert torch.equal(with_draws.spectra, streams.spectra)
    for t in range(SPE):
        assert torch.equal(with_draws.inoise[t], torch.full((2 * B, 250), 0.05 * t))
        assert torch.equal(with_draws.stab[t], streams.spectra[t] - 0.01 * t)
    # per member: member m's streams are what it gets alone
    idx2 = torch.stack([idx, idx.flip(1)])
    seeds2 = torch.stack([seeds, seeds + 1])
    both = gt.build_streams(tds, idx2, *args[2:], settings=settings, seeds=seeds2)
    alone = gt.build_streams(tds, idx2[1], *args[2:], settings=settings, seeds=seeds2[1])
    assert tuple(both.inoise.shape) == (2, SPE, 2 * B, 250)
    for a, b in zip((both.spectra[1], both.inoise[1], both.stab[1]),
                    (alone.spectra, alone.inoise, alone.stab)):
        assert torch.equal(a, b)
    assert torch.equal(both.spectra[0], streams.spectra)


@pytest.mark.parametrize("k_d", [1, 2])
def test_eps_stream_draws_what_the_eager_step_draws(k_d, tcfg, datasets):
    """WGAN-GP's interpolation weights: the eager step draws them only on the
    steps that update D (inside the penalty), after the augmentation and the
    instance noise and before the stability noise; on a skipped step there is
    no draw, so the stability noise after it comes from another place of the
    generator.  ``build_streams`` draws the same, step by step, bit for bit,
    with ``d_update_every`` 2 and a chunk that starts on an odd step."""
    from pigan_thz_torch.ops.augment import augment_spectra

    _, tds = datasets
    settings = StepSettings.from_config(tcfg, gan_loss="wgan_gp", d_update_every=k_d,
                                        instance_noise=0.05, stability_w=1.0,
                                        augment_noise=0.05)
    idx, seeds = gt.resolve_draws(torch.Generator().manual_seed(9), N, B, 1)
    # a chunk that starts at step 1 with both optimisers fresh
    streams = gt.build_streams(tds, idx, torch.ones(1), 1, 0, 0, k_d,
                               cosine_schedule(2e-4, 2, SPE, 0.01),
                               step_schedule(2e-4, 2, SPE, 0.5, 0.25), settings=settings,
                               seeds=seeds)
    assert tuple(streams.eps.shape) == (SPE, B, 1)
    for t in range(SPE):
        gate = (1 + t) % k_d == 0
        assert float(streams.sched[t, 6]) == float(gate)
        gen = torch.Generator().manual_seed(int(seeds[t]))
        spectra = augment_spectra(gen, tds.spectra[idx[0, t]], noise_level=0.05,
                                  freq_shift=0.0, amp_scale=0.0)
        inoise = 0.05 * torch.randn((2 * B, 250), generator=gen)
        eps = torch.rand((B, 1), generator=gen) if gate else torch.zeros((B, 1))
        noisy = spectra + settings.stability_noise * torch.randn((B, 250), generator=gen)
        assert torch.equal(streams.inoise[t], inoise)
        assert torch.equal(streams.eps[t], eps)
        assert torch.equal(streams.stab[t], noisy)
    # the kernel's plain version and the eager step then compute one step
    (gtx, dtx), st = _state(tcfg, settings)
    spec = gt.gan_train_spec(tcfg, settings)
    kern = st.clone()
    eager = make_multi_epoch_fn(make_pigan_step(gtx, dtx, settings, tds.param_lo,
                                                tds.param_hi), B)
    st.step = kern.step = 1
    st, erows = eager(st, tds, torch.ones(1), indices=idx, seeds=seeds)
    rows = gt.gan_train(gt.state_buffers(kern), streams, spec)
    got = gt.epoch_means(rows, 1, False)
    for k in ("d_loss", "g_loss", "adv_loss"):
        torch.testing.assert_close(got[k], erows[k], rtol=ROWS_RTOL, atol=1e-6, msg=k)
    given = [{"gp_eps": torch.full((B, 1), 0.25)} for _ in range(SPE)]
    with_draws = gt.build_streams(tds, idx, torch.ones(1), 1, 0, 0, k_d,
                                  cosine_schedule(2e-4, 2, SPE, 0.01),
                                  step_schedule(2e-4, 2, SPE, 0.5, 0.25), settings=settings,
                                  seeds=seeds, draws=given)
    for t in range(SPE):
        want = 0.25 if (1 + t) % k_d == 0 else 0.0
        assert torch.equal(with_draws.eps[t], torch.full((B, 1), want))


# -- the paths against the JAX package ---------------------------------------
NARROW = dict(g=(48, 24), d=(40, 20), f=(16, 32, 48, 32, 16))
JAX_CASES = {
    "cycle_through_f": dict(detach_forward=False, cycle_w=1.0, adv_w=0.0, d_update_every=2),
    "cycle_detached": dict(detach_forward=True, cycle_w=1.0, sigmoid_squash=True),
    "stability_instance_noise": dict(detach_forward=False, stability_w=0.8,
                                     instance_noise=0.05),
    "augmented_all_four": dict(detach_forward=False, cycle_w=0.5, stability_w=1.0,
                               instance_noise=0.05, augment_noise=0.05, augment_shift=0.02,
                               augment_scale=0.1, constraint_w=1.0),
    # WGAN-GP through F is held against the Pallas kernel (below): there the
    # XLA step lies 1.2e-3 (lc_loss) and 1.5e-2 (BatchNorm stats) from both
    # the kernel and the port after 8 steps at these widths (ROADMAP queue 3)
    "wgan_gp_detached": dict(detach_forward=True, gan_loss="wgan_gp", gp_weight=5.0),
    "wgan_gp_d_every_2_stability": dict(detach_forward=True, gan_loss="wgan_gp",
                                        d_update_every=2, stability_w=1.0, instance_noise=0.05),
}


def _narrow(cfg):
    rep = dataclasses.replace
    return _small(cfg).replace(
        generator=rep(cfg.generator, hidden_dims=NARROW["g"]),
        discriminator=rep(cfg.discriminator, hidden_dims=NARROW["d"]),
        forward_model=rep(cfg.forward_model, hidden_dims=NARROW["f"]))


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _carry_over(jst, tst):
    ga, da = jst.g_opt[1][0], jst.d_opt[1][0]
    load_pigan_state_(tst, {
        "g": {"params": _np32(jst.g.params),
              "batch_stats": _np32(jst.g.extra["batch_stats"])},
        "d": {"params": _np32(jst.d.params)}, "f": {"params": _np32(jst.f.params)},
        "g_mu": _np32(ga.mu), "g_nu": _np32(ga.nu), "g_count": 0,
        "d_mu": _np32(da.mu), "d_nu": _np32(da.nu), "d_count": 0, "step": 0})


def _jax_streams(jc, jset, jst, jds, key, scales, spec):
    """The JAX prologue's streams of this chunk (the XLA step's own key
    chain), cut to their true widths, as the port's ``GanStreams``."""
    out = jmk._build_streams(
        jc, jset, jset.d_update_every,
        lambda spe: j_cosine_schedule(jc.train.lr_g, jc.train.num_epochs, spe, 0.01),
        lambda spe: j_step_schedule(jc.train.lr_d, jc.train.num_epochs, spe, 0.5, 0.25),
        jst.rng, jst.step, jst.g_opt[1][0].count, jst.d_opt[1][0].count, jds, key,
        jnp.asarray(scales))
    arr = [torch.from_numpy(np.array(x, np.float32)) for x in out]
    extra = arr[4:-2]
    inoise = extra.pop(0)[:, :, :250].contiguous() if spec.use_inoise else None
    stab = extra.pop(0)[:, :, :250].contiguous() if spec.stability_w else None
    eps = extra.pop(0)[:, :, :1].contiguous() if spec.wgan else None
    return gt.GanStreams(arr[0][:, :, :250].contiguous(), arr[1][:, :, :4].contiguous(),
                         arr[2][:, :, :8].contiguous(), arr[3][:, 0, :8].contiguous(),
                         arr[-2][0, :4].contiguous(), arr[-1][0, :4].contiguous(),
                         inoise, stab, eps)


def _assert_matches_jax(tst, trows, jst, jrows, rows_rtol, param_atol):
    for k in jrows:
        atol = 1.0 / (SPE * B) if k in ("d_accuracy", "violation_rate") else 1e-6
        np.testing.assert_allclose(trows[k].numpy(), np.asarray(jrows[k]), rtol=rows_rtol,
                                   atol=atol, err_msg=k)
    back = pigan_state_to_flax(tst)
    for a, b in zip(jax.tree.leaves(back["d"]["params"]), jax.tree.leaves(_np32(jst.d.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=param_atol)
    for a, b in zip(jax.tree.leaves(back["g"]["batch_stats"]),
                    jax.tree.leaves(_np32(jst.g.extra["batch_stats"]))):
        np.testing.assert_allclose(a, b, rtol=0, atol=STATS_ATOL)
    flat = jax.tree_util.tree_flatten_with_path(_np32(jst.g.params))[0]
    for (path, want), got in zip(flat, jax.tree.leaves(back["g"]["params"])):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name in ("MLPBlock_0/Dense_0/bias", "MLPBlock_1/Dense_0/bias"):
            continue                                            # the gauge leaves
        np.testing.assert_allclose(got, want, rtol=0, atol=param_atol, err_msg=name)


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_plain_kernel_paths_match_the_jax_xla_step(case, datasets):
    """Two epochs (8 steps) of the JAX XLA step and of the port's plain
    version from the same weights on the same streams, which are the JAX
    prologue's own (``megakernel._build_streams``: augmented spectra,
    instance noise, noised stability spectra from the step's key chain), at
    narrow widths.  Rows within ROWS_RTOL, parameters within PARAM_ATOL
    outside the gauge leaves (8 steps of lr 2e-4: Adam turns rounding in a
    near-zero gradient into steps of up to lr; measured 3.7e-4 on 2 of G's
    12000 first-layer weights, 9e-5 elsewhere), BatchNorm stats within
    STATS_ATOL."""
    jds, tds = datasets
    jc, tc = _narrow(j_default_config()), _narrow(t_default_config())
    knobs = JAX_CASES[case]
    jset, settings = JSettings.from_config(jc, **knobs), StepSettings.from_config(tc, **knobs)
    g, d, f = j_build_trio(jc)
    g_tx, d_tx, _ = j_make_optimizers(jc, SPE)
    jst = j_init_pigan_state(g, d, f, g_tx, d_tx, jax.random.PRNGKey(1))
    tg, td, tf = t_build_trio(tc, device="cpu")
    gtx, dtx, _ = make_optimizers(tc, SPE)
    tst = init_pigan_state(tg, td, tf, gtx, dtx, 0, device="cpu")
    _carry_over(jst, tst)
    spec = dataclasses.replace(
        gt.gan_train_spec(_small(t_default_config()), settings), g_hidden=NARROW["g"],
        d_hidden=NARROW["d"], f_hidden=NARROW["f"])
    key = jax.random.PRNGKey(11)
    scales = np.array([1.0, 0.5], np.float32)
    streams = _jax_streams(jc, jset, jst, jds, key, scales, spec)
    if settings.augments:
        assert not torch.equal(streams.spectra, tds.spectra[
            torch.from_numpy(np.stack([np.asarray(j_epoch_indices(k, N, B))
                                       for k in jax.random.split(key, E)])).reshape(-1, B)])
    jstep = j_make_pigan_step(g, d, f, g_tx, d_tx, jset, jds.param_lo, jds.param_hi)
    jst, jrows = j_make_multi_epoch_fn(jstep, B, with_scale=True, unroll=1)(
        jst, jds, key, jnp.asarray(scales))
    rows = gt.gan_train(gt.state_buffers(tst), streams, spec)
    trows = gt.epoch_means(rows, E, bool(settings.constraint_w))
    assert set(trows) == set(jrows)
    _assert_matches_jax(tst, trows, jst, jrows, ROWS_RTOL, PARAM_ATOL)


def test_plain_kernel_paths_match_the_pallas_kernel_in_interpret_mode(tcfg, datasets):
    """One epoch (4 steps) with cycle, stability and instance noise on through
    the JAX package's kernel in interpret mode (as tests/test_megakernel.py:
    1292, :1304 and :1413 run it) and through the port's plain version, from
    the same state on the kernel's own streams.  The tolerances of the
    test above for today's settings."""
    jds, tds = datasets
    jc = _small(j_default_config())
    knobs = dict(detach_forward=False, cycle_w=1.0, stability_w=0.8, instance_noise=0.05)
    jset, settings = JSettings.from_config(jc, **knobs), StepSettings.from_config(tcfg, **knobs)
    g, d, f = j_build_trio(jc)
    g_tx, d_tx, _ = j_make_optimizers(jc, SPE)
    jst = j_init_pigan_state(g, d, f, g_tx, d_tx, jax.random.PRNGKey(1))
    _, tst = _state(tcfg, settings)
    _carry_over(jst, tst)
    spec = gt.gan_train_spec(tcfg, settings)
    key = jax.random.PRNGKey(7)
    streams = _jax_streams(jc, jset, jst, jds, key, np.ones(1, np.float32), spec)
    jst, jrows = jmk.make_pallas_multi_epoch_fn(jc, jset, interpret=True)(
        jst, jds, key, jnp.ones((1,), jnp.float32))
    rows = gt.gan_train(gt.state_buffers(tst), streams, spec)
    _assert_matches_jax(tst, gt.epoch_means(rows, 1, False), jst, jrows, PALLAS_ROWS_RTOL,
                        PALLAS_PARAM_ATOL)


# -- WGAN-GP and bfloat16 operands against the Pallas kernel in interpret mode --
PALLAS_NEW_CASES = {
    "wgan_gp": (dict(detach_forward=False, gan_loss="wgan_gp", d_update_every=2,
                     stability_w=1.0), "float32"),
    "bf16": (dict(detach_forward=False), "bfloat16"),
    "bf16_wgan_gp_detached": (dict(detach_forward=True, gan_loss="wgan_gp"), "bfloat16"),
}


def _pallas_new_case(case, tcfg, datasets, faults=()):
    """One epoch (4 steps) of a PALLAS_NEW_CASES case through the JAX
    package's kernel in interpret mode and through the port's plain version
    from the same state on the kernel's own streams: (port rows, port
    state, JAX rows, JAX state)."""
    jds, tds = datasets
    knobs, dtype = PALLAS_NEW_CASES[case]
    jc = _small(j_default_config())
    jc = jc.replace(train=dataclasses.replace(jc.train, compute_dtype=dtype))
    tc = tcfg.replace(train=dataclasses.replace(tcfg.train, compute_dtype=dtype))
    jset, settings = JSettings.from_config(jc, **knobs), StepSettings.from_config(tc, **knobs)
    g, d, f = j_build_trio(jc)
    g_tx, d_tx, _ = j_make_optimizers(jc, SPE)
    jst = j_init_pigan_state(g, d, f, g_tx, d_tx, jax.random.PRNGKey(1))
    _, tst = _state(tc, settings)
    _carry_over(jst, tst)
    spec = gt.gan_train_spec(tc, settings)
    assert spec.bf16 == (dtype == "bfloat16") and spec.wgan == (settings.gan_loss == "wgan_gp")
    key = jax.random.PRNGKey(7)
    streams = _jax_streams(jc, jset, jst, jds, key, np.ones(1, np.float32), spec)
    jst, jrows = jmk.make_pallas_multi_epoch_fn(jc, jset, interpret=True)(
        jst, jds, key, jnp.ones((1,), jnp.float32))
    start = gt.state_buffers(tst.clone())
    rows = gt.gan_train_plain(gt.state_buffers(tst), streams, spec, faults=faults)
    return gt.epoch_means(rows, 1, False), tst, jrows, jst, start


def tst_cfg(tcfg, dtype):
    return tcfg.replace(train=dataclasses.replace(tcfg.train, compute_dtype=dtype))


def _jax_buffers(jst, like):
    """A JAX ``PiGanState`` after a run as the port's ``GanBuffers`` (the
    shapes of ``like``)."""
    import copy

    from pigan_thz_torch.train.state import PiGanState

    del like
    ga, da = jst.g_opt[1][0], jst.d_opt[1][0]
    tc = _small(t_default_config())
    g, d, f = t_build_trio(tc, device="cpu")
    gtx, dtx, _ = make_optimizers(tc, SPE)
    st = init_pigan_state(g, d, f, gtx, dtx, 0, device="cpu")
    assert isinstance(st, PiGanState)
    load_pigan_state_(st, {
        "g": {"params": _np32(jst.g.params), "batch_stats": _np32(jst.g.extra["batch_stats"])},
        "d": {"params": _np32(jst.d.params)}, "f": {"params": _np32(jst.f.params)},
        "g_mu": _np32(ga.mu), "g_nu": _np32(ga.nu), "g_count": int(ga.count),
        "d_mu": _np32(da.mu), "d_nu": _np32(da.nu), "d_count": int(da.count),
        "step": int(ga.count)})
    return copy.copy(gt.state_buffers(st))


BF16_STEP_RTOL = {"lc_loss": 5e-3, "recon_metrics_loss": 1e-3, "maxwell_loss": 1e-3}
BF16_STEP_FLOOR = 2e-4


def _bf16_first_step(case):
    """One bfloat16 step (a 32-sample set, one step an epoch) from carried-over
    weights through the JAX package's kernel in interpret mode: (the port's
    state before the step, its streams, spec, the JAX rows, the JAX state
    after the step as the port's ``GanBuffers``)."""
    knobs, dtype = PALLAS_NEW_CASES[case]

    def small(cfg):
        return cfg.replace(data=dataclasses.replace(cfg.data, num_samples=B),
                           train=dataclasses.replace(cfg.train, batch_size=B, num_epochs=2,
                                                     compute_dtype=dtype))

    tc, jc = small(t_default_config()), small(j_default_config())
    raw = synthetic_dataset(tc.data, device="cpu")
    jds = j_build_dataset(raw.spectra.numpy(), raw.params.numpy(), raw.metrics.numpy(), jc.data)
    jset, settings = JSettings.from_config(jc, **knobs), StepSettings.from_config(tc, **knobs)
    g, d, f = j_build_trio(jc)
    g_tx, d_tx, _ = j_make_optimizers(jc, 1)
    jst = j_init_pigan_state(g, d, f, g_tx, d_tx, jax.random.PRNGKey(1))
    tg, td, tf = t_build_trio(tc, device="cpu")
    gtx, dtx, _ = make_optimizers(tc, 1)
    tst = init_pigan_state(tg, td, tf, gtx, dtx, 0, device="cpu")
    _carry_over(jst, tst)
    spec = gt.gan_train_spec(tc, settings)
    key = jax.random.PRNGKey(7)
    streams = _jax_streams(jc, jset, jst, jds, key, np.ones(1, np.float32), spec)
    jst, jrows = jmk.make_pallas_multi_epoch_fn(jc, jset, interpret=True)(
        jst, jds, key, jnp.ones((1,), jnp.float32))
    return tst, streams, spec, jrows, _jax_buffers(jst, None)


@pytest.mark.parametrize("case", ["bf16", "bf16_wgan_gp_detached"])
def test_bf16_first_step_matches_the_pallas_kernel_and_sees_each_fault(case):
    """The first bfloat16 step through the JAX package's kernel in interpret
    mode and the port's plain version: every row within BF16_STEP_FLOOR
    relative (measured 4.3e-5 at most, in param_range_loss), the three that
    a flipped rounding in F moves most within BF16_STEP_RTOL (measured 1.3e-3
    in lc_loss, where the port's own float64 accumulation is 1.1e-3 from the
    kernel too).  Each bfloat16 fault of the forward lies beyond: G's head
    product rounded moves param_range_loss by 1.7e-3, D's first layer left
    in float32 moves adv_loss by 5.8e-3 to 9.3e-3."""
    tst, streams, spec, jrows, _ = _bf16_first_step(case)

    def worst(faults=()):
        rows = gt.gan_train_plain(gt.state_buffers(tst.clone()), streams, spec, faults=faults)
        out = {}
        for j, k in enumerate(gt.METRIC_KEYS):
            if k in ("d_accuracy", "violation_rate"):
                continue
            want = float(np.asarray(jrows[k])[0])
            err = abs(float(rows[0, j]) - want) / max(abs(want), 1e-6)
            out[k] = err / BF16_STEP_RTOL.get(k, BF16_STEP_FLOOR)
        return out

    right = worst()
    assert max(right.values()) <= 1.0, right
    for fault in ("bf16_head_rounded", "bf16_hidden_fp32"):
        assert max(worst([fault]).values()) > 2.0, fault


# D's tensors after the first bfloat16 step, port against the JAX kernel,
# relative to what the step changed (``gan_train.step_errors``): measured
# 1.6e-5 at most (d_v[0]).  D's backward product dp2 . W2 left in float32
# moves D's first-layer moments by 1.7e-3 to 2.2e-3 and its first-layer
# updates by 3.8e-2 to 8.6e-2.
BF16_D_STEP_RTOL = 1e-4


def test_bf16_backward_fault_is_seen_in_the_first_step_state():
    """The rows of a first step are the losses before the update, so a fault
    of the backward shows only in the state: D's tensors after one bfloat16
    step of the port's plain version within BF16_D_STEP_RTOL of the JAX
    package's kernel in interpret mode, and with D's backward product in
    float32 (``bf16_backward_fp32``) beyond it."""
    tst, streams, spec, _, jax_after = _bf16_first_step("bf16")
    start = gt.state_buffers(tst)

    def d_errors(faults=()):
        bufs = gt.state_buffers(tst.clone())
        gt.gan_train_plain(bufs, streams, spec, faults=faults)
        return {k: e for k, e in gt.step_errors(bufs, gt.to_double(jax_after), start,
                                                spec).items() if k.startswith("d_")}

    right, wrong = d_errors(), d_errors(["bf16_backward_fp32"])
    print("D after one bf16 step, port vs JAX kernel:", {k: f"{e:.2e}" for k, e in right.items()},
          "with the fault:", {k: f"{e:.2e}" for k, e in wrong.items()})
    assert max(right.values()) <= BF16_D_STEP_RTOL, right
    assert max(wrong.values()) > 2.0 * BF16_D_STEP_RTOL, wrong


@pytest.mark.parametrize("case", list(PALLAS_NEW_CASES))
def test_plain_kernel_wgan_and_bf16_match_the_pallas_kernel_in_interpret_mode(
        case, tcfg, datasets):
    """WGAN-GP (with D every 2nd step and stability on) and the bfloat16
    operands, one epoch against the JAX package's kernel in interpret mode,
    to the tolerances of today's settings."""
    trows, tst, jrows, jst, start = _pallas_new_case(case, tcfg, datasets)
    if PALLAS_NEW_CASES[case][1] == "float32":
        _assert_matches_jax(tst, trows, jst, jrows, PALLAS_ROWS_RTOL, PALLAS_PARAM_ATOL)
        return
    for k in gt.METRIC_KEYS:
        atol = 1.0 / (SPE * B) if k in ("d_accuracy", "violation_rate") else 1e-6
        np.testing.assert_allclose(trows[k].numpy(), np.asarray(jrows[k]), rtol=BF16_ROWS_RTOL,
                                   atol=atol, err_msg=k)
    spec = gt.gan_train_spec(tst_cfg(tcfg, "bfloat16"), StepSettings.from_config(
        tst_cfg(tcfg, "bfloat16"), **PALLAS_NEW_CASES[case][0]))
    diffs = gt.state_diffs(gt.state_buffers(tst), _jax_buffers(jst, start), start, spec)
    for part, limit in BF16_PART_RTOL.items():
        assert diffs[part][1] <= limit, (part, diffs[part])


# -- the float64 plain version against float64 autograd ------------------------
F64_CASES = {
    "cycle_through_f": dict(detach_forward=False, cycle_w=1.0),
    "cycle_detached": dict(detach_forward=True, cycle_w=1.0),
    "stability": dict(detach_forward=False, stability_w=1.0),
    "both_squashed_constrained": dict(detach_forward=False, cycle_w=0.5, stability_w=1.0,
                                      sigmoid_squash=True, constraint_w=3.0),
    "instance_noise": dict(detach_forward=False, instance_noise=1.0),
    "augmentation": dict(detach_forward=False, augment_noise=0.05, augment_shift=0.02,
                         augment_scale=0.1),
    "wgan_gp": dict(detach_forward=False, gan_loss="wgan_gp"),
    "wgan_gp_noise_stability": dict(detach_forward=True, gan_loss="wgan_gp", instance_noise=0.5,
                                    stability_w=1.0, gp_weight=3.0),
}


def _double_state(st):
    """A copy of a PiGanState in float64, with its optimisers."""
    import copy

    from pigan_thz_torch.train.state import PiGanState
    from pigan_thz_torch.train.schedules import AdamState

    def dbl(module, flat):
        module = copy.deepcopy(module).double()
        flat = flat.double().clone()
        pos = 0
        for p in module.parameters():
            p.data = flat[pos: pos + p.numel()].view(p.shape)
            pos += p.numel()
        return module, flat

    (g, gp), (d, dp), (f, fp) = (dbl(st.g, st.g_params), dbl(st.d, st.d_params),
                                 dbl(st.f, st.f_params))
    gen = torch.Generator()
    gen.set_state(st.generator.get_state())
    zero = lambda p: AdamState(torch.zeros_like(p), torch.zeros_like(p), 0)  # noqa: E731
    return PiGanState(0, g, d, f.eval(), gp, dp, fp, zero(gp), zero(dp), gen)


@pytest.mark.parametrize("case", list(F64_CASES))
def test_float64_plain_version_matches_float64_autograd(case, tcfg, datasets):
    """One step in float64 through the plain version's hand-derived backward
    and through autograd (the eager step on a float64 copy of the state, the
    same noise).  Adam's first moments are (1 - b1) x the clipped gradient,
    whatever the learning rate: D's, with ``d_loss``, from a step that
    updates D; G's, with every row, from a step whose D update is gated off
    (``d_update_every`` 2 at step 1), so that both sides' G phases see one
    D (the two Adams round their bias corrections differently, 1e-8).  Each
    tensor agrees to 1e-10 of its norm, the rows to 1e-10: rounding cannot
    hide a wrong adjoint here."""
    from pigan_thz_torch.data.dataset import gather_batch

    _, tds = datasets
    # labels that float32 holds exactly: the eager step builds them in float32
    settings = StepSettings.from_config(tcfg, label_real=0.875, label_fake=0.125,
                                        d_update_every=2, **F64_CASES[case])
    (gtx, dtx), st = _state(tcfg, settings)
    spec = gt.gan_train_spec(tcfg, settings)
    idx, seeds = gt.resolve_draws(torch.Generator().manual_seed(4), N, B, 1)
    ds64 = ThzDataset(*(t.double() for t in tds))
    step = make_pigan_step(gtx, dtx, settings, ds64.param_lo, ds64.param_hi)

    def close(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp(min=1e-30))

    for step0 in (0, 1):
        streams = gt.build_streams(ds64, idx[:, :1], torch.ones(1), step0, 0, 0, 2,
                                   cosine_schedule(2e-4, 2, SPE, 0.01),
                                   step_schedule(2e-4, 2, SPE, 0.5, 0.25), settings=settings,
                                   seeds=seeds[:1])
        assert float(streams.sched[0, 6]) == 1.0 - step0
        exact = gt.to_double(gt.state_buffers(st.clone()))
        rows = gt.gan_train_plain(exact, gt.to_double(streams), spec)
        auto = _double_state(st)
        auto.step = step0
        _, m = step(auto, gather_batch(ds64, idx[0, 0]), 1.0, int(seeds[0]))
        keys = gt.METRIC_KEYS if step0 else ("d_loss", "d_accuracy")
        for k in keys:
            got = float(rows[0, gt.METRIC_KEYS.index(k)])
            assert abs(got - float(m[k])) <= 1e-10 * max(1.0, abs(float(m[k]))), (step0, k)
        if step0 == 0:
            pairs = zip(spec.d_views(exact.d_m), spec.d_views(auto.d_opt.m))
            assert max(close(a, b) for a, b in pairs) <= 1e-10
        else:
            assert torch.equal(exact.d, st.d_params.double())        # D gated off
            for j, (a, b) in enumerate(zip(spec.g_views(exact.g_m),
                                           spec.g_views(auto.g_opt.m))):
                if j not in (1, 5):                                  # the gauge leaves
                    assert close(a, b) <= 1e-10, (j, close(a, b))


FAULT_CASES = [("cycle_through_f", "cycle_seed_dropped"),
               ("cycle_through_f", "second_pass_moves_running_stats"),
               ("cycle_detached", "drecon_c_when_detached"),
               ("stability", "stability_seed_dropped"),
               ("stability", "second_pass_moves_running_stats"),
               ("instance_noise", "noised_fake_rows"),
               ("wgan_gp", "wgan_gp_w1_second_term_dropped"),
               ("wgan_gp", "wgan_gp_seed_sign")]


@pytest.mark.parametrize("case,fault", FAULT_CASES)
def test_a_faulty_plain_version_is_seen(case, fault, tcfg, datasets):
    """Each deliberate fault moves the float64 first step by far more than
    the 1e-10 the test above allows: the comparison has the power to see a
    kernel that made that mistake."""
    _, tds = datasets
    settings = StepSettings.from_config(tcfg, **F64_CASES[case])
    _, st = _state(tcfg, settings)
    spec = gt.gan_train_spec(tcfg, settings)
    idx, seeds = gt.resolve_draws(torch.Generator().manual_seed(4), N, B, 1)
    streams = gt.to_double(gt.build_streams(
        tds, idx[:, :1], torch.ones(1), 0, 0, 0, 1, cosine_schedule(2e-4, 2, SPE, 0.01),
        step_schedule(2e-4, 2, SPE, 0.5, 0.25), settings=settings, seeds=seeds[:1]))
    start = gt.state_buffers(st)
    right = gt.to_double(gt.state_buffers(st.clone()))
    wrong = gt.to_double(gt.state_buffers(st.clone()))
    gt.gan_train_plain(right, streams, spec)
    gt.gan_train_plain(wrong, streams, spec, faults=[fault])
    assert max(gt.step_errors(wrong, right, start, spec).values()) > 1e-4
    with pytest.raises(ValueError, match="unknown faults"):
        gt.gan_train_plain(wrong, streams, spec, faults=["no_such_fault"])


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


def test_workspace_layout_names_the_scratch(tcfg):
    spec = gt.gan_train_spec(tcfg, StepSettings.from_config(tcfg))
    layout = gt.workspace_layout(spec, 64)
    names = [n for n, _ in layout]
    assert len(set(names)) == len(names)
    assert names[:5] == ["uc0", "xh0", "y0", "a0", "iv0"] and names[-1] == "norm_partials"
    assert dict(layout)["pred"] == 64 * 258 and dict(layout)["grad_g"] == spec.num_g
    assert gt.workspace_floats(spec, 64) == sum(n for _, n in layout) == 1772613
    work = torch.arange(gt.workspace_floats(spec, 8), dtype=torch.float32)
    views = gt.workspace_views(work, spec, 8)
    assert list(views) == [n for n, _ in gt.workspace_layout(spec, 8)]
    assert views["tn"].numel() == 32 and views["tn"].data_ptr() == work[
        int(views["tn"][0]):].data_ptr()
    assert int(views["norm_partials"][-1]) == work.numel() - 1
