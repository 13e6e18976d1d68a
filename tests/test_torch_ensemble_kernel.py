"""The member-packed GAN-training path on the CPU: ``ops/gan_train.py``
(``gan_ensemble_train``, ``make_gan_ensemble_fn``) over the stacked state of
``parallel/state_utils.py``.

On CPU tensors the wrapper runs the member-packed kernel's plain version, a
loop of the one-member plain version over the members' rows.  Held here, at
the baseline widths the kernel needs (128 samples, batch 32, 2 epochs = 8
steps, a freshly initialised shared F):

- member m of a packed call is BIT-EQUAL (``torch.equal``: rows and whole
  state) to ``make_gan_epoch_fn`` on that member alone with the same
  shuffles, M = 3 and M = 1; the members differ from each other;
- the refusals, each with its message;
- the port against the JAX package's member-packed Pallas kernel itself in
  interpret mode (M = 2, one epoch, JAX's initial states and shuffles carried
  across with ``load_ensemble_states_``): rows within PALLAS_ROWS_RTOL,
  parameters within PALLAS_PARAM_ATOL outside the gauge leaves, BatchNorm
  stats within STATS_ATOL: the tolerances of tests/test_torch_gan_train.py
  for the one-member Pallas case, and for its reasons."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.data.dataset import ThzDataset
from pigan_thz_torch.interop import ensemble_states_to_flax, load_ensemble_states_
from pigan_thz_torch.models import build_trio as t_build_trio
from pigan_thz_torch.ops import gan_train as gt
from pigan_thz_torch.parallel.ensemble import init_ensemble_states, member_generator
from pigan_thz_torch.parallel.state_utils import EnsembleState, tree_stack, tree_unstack
from pigan_thz_torch.train.schedules import cosine_schedule, step_schedule
from pigan_thz_torch.train.state import init_pigan_state, make_optimizers
from pigan_thz_torch.train.steps import StepSettings
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.data.dataset import build_dataset as j_build_dataset
from pigan_thz_tpu.data.dataset import epoch_indices as j_epoch_indices
from pigan_thz_tpu.models import build_trio as j_build_trio
from pigan_thz_tpu.ops import megakernel as jmk
from pigan_thz_tpu.train.state import init_pigan_state as j_init_pigan_state
from pigan_thz_tpu.train.state import make_optimizers as j_make_optimizers
from pigan_thz_tpu.train.steps import StepSettings as JSettings

torch.set_num_threads(1)

N, B, E = 128, 32, 2
SPE = N // B
PALLAS_ROWS_RTOL, PALLAS_PARAM_ATOL, PARAM_ATOL, STATS_ATOL = 5e-3, 1.2e-3, 8e-4, 8e-3

CASES = {
    "through_f": dict(detach_forward=False),
    "detached": dict(detach_forward=True),
    "d_every_2_constraint": dict(detach_forward=False, d_update_every=2, constraint_w=0.7),
    # the second G passes and the noise streams, each member's from its own seeds
    "second_passes_and_noise": dict(detach_forward=False, cycle_w=1.0, stability_w=1.0,
                                    instance_noise=0.05),
    "augmented_cycle_detached": dict(detach_forward=True, cycle_w=1.0, augment_noise=0.05,
                                     augment_shift=0.02, augment_scale=0.1,
                                     sigmoid_squash=True),
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


def _members(tcfg, count, seed=0, ema=False, shared=True):
    """``count`` members as an ``EnsembleState`` and, from the same
    generators' seeds, the same members as solo states."""
    g, d, f = t_build_trio(tcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    gtx, dtx, _ = make_optimizers(tcfg, SPE)
    gens = [member_generator(seed, i) for i in range(count)]
    ens = init_ensemble_states(g, d, f, gtx, dtx, gens, device="cpu", ema=ema,
                               fresh_forward=not shared)
    solo = [init_pigan_state(g, d, f, gtx, dtx, member_generator(seed, i), device="cpu",
                             ema=ema, fresh_forward=not shared) for i in range(count)]
    return ens, solo


def _state_tensors(st):
    bufs = gt.state_buffers(st)
    return [*bufs[:6], *bufs.bn]


def _assert_member_equal(a, b):
    for x, y in zip(_state_tensors(a), _state_tensors(b)):
        assert torch.equal(x, y)
    assert (a.step, a.g_opt.count, a.d_opt.count) == (b.step, b.g_opt.count, b.d_opt.count)
    for m, n in zip(a.batch_norms(), b.batch_norms()):
        assert int(m.num_batches_tracked) == int(n.num_batches_tracked)


@pytest.mark.parametrize("members", [3, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_packed_member_is_bit_equal_to_the_member_alone(case, members, tcfg, datasets):
    _, tds = datasets
    settings = StepSettings.from_config(tcfg, **CASES[case])
    ens, solo = _members(tcfg, members)
    idx = torch.stack([gt.resolve_draws(torch.Generator().manual_seed(40 + m), N, B, E)[0]
                       for m in range(members)])
    scales = torch.tensor([1.0, 0.25])
    before = dict(gt.LAUNCHES)
    ens, rows = gt.make_gan_ensemble_fn(tcfg, settings, members)(ens, tds, scales, indices=idx)
    assert gt.LAUNCHES == before          # CPU tensors: the plain version
    assert isinstance(ens, EnsembleState) and len(rows) == members
    one = gt.make_gan_epoch_fn(tcfg, settings)
    for m, st in enumerate(solo):
        st, want = one(st, tds, scales, indices=idx[m])
        assert set(rows[m]) == set(want)
        assert ("constraint_loss" in want) == bool(settings.constraint_w)
        for k in want:
            assert want[k].shape == (E,) and torch.equal(rows[m][k], want[k]), (m, k)
        _assert_member_equal(ens[m], st)
        assert ens[m].step == E * SPE
        assert ens[m].d_opt.count == len(range(0, E * SPE, settings.d_update_every))
    if members > 1:
        assert not torch.equal(ens.g_params[0], ens.g_params[1])
        assert not torch.equal(rows[0]["g_loss"], rows[1]["g_loss"])
        assert ens.shared_f and ens[1].f is ens[0].f


def test_each_member_draws_its_own_shuffles_as_it_would_alone(tcfg, datasets):
    """Without ``indices`` member m's batches come from member m's generator,
    drawn as the one-member function draws them; a list of states is stacked
    on the way and a second chunk continues where the first ended."""
    _, tds = datasets
    settings = StepSettings.from_config(tcfg, detach_forward=True)
    ens, solo = _members(tcfg, 2, seed=5)
    fn = gt.make_gan_ensemble_fn(tcfg, settings, 2)
    one = gt.make_gan_epoch_fn(tcfg, settings)
    states = tree_unstack(ens)                       # a plain list of members
    for chunk in (torch.ones(1), torch.ones(2)):
        states, rows = fn(states, tds, chunk)
        for m in range(2):
            solo[m], want = one(solo[m], tds, chunk)
            assert all(torch.equal(rows[m][k], want[k]) for k in want)
            _assert_member_equal(states[m], solo[m])
    assert isinstance(states, EnsembleState) and states[0].step == 3 * SPE


def test_stacked_state_views_and_clone(tcfg, datasets):
    """Member m's modules, moments and stats are row m of the stack: training
    a member alone (the one-member path) updates the stack in place; a clone
    owns buffers of its own."""
    _, tds = datasets
    ens, _ = _members(tcfg, 2, ema=True)
    assert ens.g_params.shape == (2, ens[0].g_params.numel()) and ens.g_ema.shape[0] == 2
    for m, st in enumerate(ens):
        assert st.g_params.data_ptr() == ens.g_params[m].data_ptr()
        assert next(st.g.parameters()).data_ptr() == ens.g_params[m].data_ptr()
        assert st.d_opt.v.data_ptr() == ens.d_v[m].data_ptr()
        assert st.batch_norms()[1].running_var.data_ptr() == ens.bn[3][m].data_ptr()
    copy = ens.clone()
    assert copy.g_params.data_ptr() != ens.g_params.data_ptr()
    assert torch.equal(copy.g_params, ens.g_params) and copy.shared_f
    assert copy[1].g_params.data_ptr() == copy.g_params[1].data_ptr()
    settings = StepSettings.from_config(tcfg, ema_decay=0.9)
    gt.make_gan_epoch_fn(tcfg, settings)(ens[1], tds, torch.ones(1))
    assert torch.equal(ens.g_params[0], copy.g_params[0])
    assert not torch.equal(ens.g_params[1], copy.g_params[1])
    assert not torch.equal(ens.bn[0][1], copy.bn[0][1])
    assert not torch.equal(ens.g_ema[1], copy.g_ema[1])
    with pytest.raises(ValueError, match="EMA"):
        tree_stack([ens[0], _members(tcfg, 1)[0][0]])
    with pytest.raises(ValueError, match="no states"):
        tree_stack([])


def test_refusals(tcfg, datasets):
    _, tds = datasets
    settings = StepSettings.from_config(tcfg)
    with pytest.raises(ValueError, match="num_members must be >= 1"):
        gt.make_gan_ensemble_fn(tcfg, settings, 0)
    with pytest.raises(ValueError, match="ema_decay > 0 unsupported"):
        gt.make_gan_ensemble_fn(tcfg, dataclasses.replace(settings, ema_decay=0.9), 2)
    moments = tcfg.replace(train=dataclasses.replace(tcfg.train, adam_state_dtype="bfloat16"))
    with pytest.raises(ValueError, match="adam_state_dtype"):
        gt.make_gan_ensemble_fn(moments, settings, 2)
    with pytest.raises(ValueError, match="unsupported"):
        gt.make_gan_ensemble_fn(tcfg, dataclasses.replace(settings, gan_loss="hinge"), 2)
    fn = gt.make_gan_ensemble_fn(tcfg, settings, 2)
    ens, _ = _members(tcfg, 3)
    with pytest.raises(ValueError, match="expected 2 states, got 3"):
        fn(ens, tds, torch.ones(1))
    ens, _ = _members(tcfg, 2)
    for field in ("step", "g_count", "d_count"):
        moved = tree_unstack(ens.clone())
        if field == "step":
            moved[1].step = 4
        else:
            getattr(moved[1], f"{field[0]}_opt").count = 4
        with pytest.raises(ValueError, match="member 1 step/opt counts differ"):
            fn(moved, tds, torch.ones(1))
    apart, _ = _members(tcfg, 2, shared=False)       # each member drew its own F
    assert not apart.shared_f
    with pytest.raises(ValueError, match="member 1's frozen F differs"):
        fn(apart, tds, torch.ones(1))
    with pytest.raises(ValueError, match="indices"):
        fn(ens, tds, torch.ones(1), indices=torch.zeros((2, 1, SPE, B - 1), dtype=torch.int64))


def test_wrapper_checks_its_arguments(tcfg, datasets):
    _, tds = datasets
    settings = StepSettings.from_config(tcfg)
    spec = gt.gan_train_spec(tcfg, settings)
    ens, _ = _members(tcfg, 2)
    idx = torch.arange(N).reshape(1, 1, SPE, B).expand(2, 1, SPE, B)
    streams = gt.build_streams(tds, idx, torch.ones(1), 0, 0, 0, 1,
                               cosine_schedule(2e-4, 2, SPE, 0.01),
                               step_schedule(2e-4, 2, SPE, 0.5, 0.25))
    assert streams.spectra.shape == (2, SPE, B, 250) and streams.sched.shape == (SPE, 8)
    bufs = gt.ensemble_buffers(ens)
    with pytest.raises(ValueError, match="leading member axis"):
        gt.gan_ensemble_train(gt.state_buffers(ens[0]), streams, spec)
    with pytest.raises(ValueError, match="axes"):
        gt.gan_ensemble_train(bufs, gt._member(bufs, streams, 0)[1], spec)
    with pytest.raises(ValueError, match="d_m"):
        gt.gan_ensemble_train(bufs._replace(d_m=bufs.d_m[:1]), streams, spec)
    with pytest.raises(ValueError, match="bn2_var"):
        gt.gan_ensemble_train(bufs._replace(bn=(*bufs.bn[:3], bufs.bn[3][0])), streams, spec)
    with pytest.raises(ValueError, match="ema_decay"):
        gt.gan_ensemble_train(bufs, streams, dataclasses.replace(spec, ema_decay=0.5))
    empty = streams._replace(spectra=streams.spectra[:, :0], params=streams.params[:, :0],
                             metrics_norm=streams.metrics_norm[:, :0],
                             sched=streams.sched[:0])
    before = ens.g_params.clone()
    rows = gt.gan_ensemble_train(bufs, gt.GanStreams(
        *(None if t is None else t.contiguous() for t in empty)), spec)
    assert rows.shape == (2, 0, gt.ROW_WIDTH) and torch.equal(ens.g_params, before)


def test_plain_version_matches_the_pallas_ensemble_kernel_in_interpret_mode(tcfg, datasets):
    """M = 2, one epoch (4 steps) through ``make_pallas_ensemble_fn`` in
    interpret mode, as tests/test_member_packed.py runs it, and through the
    port from the same two members on the same batches: member m's shuffle
    key is ``fold_in(key, m)`` there, and its indices are given here."""
    jds, tds = datasets
    jc = _small(j_default_config())
    jset = JSettings.from_config(jc, detach_forward=False)
    g, d, f = j_build_trio(jc)
    g_tx, d_tx, _ = j_make_optimizers(jc, SPE)
    k_init, key = jax.random.split(jax.random.PRNGKey(11))
    shared_f = f.init({"params": k_init, "dropout": k_init}, jnp.zeros((2, 4)), train=False)
    jstates = [j_init_pigan_state(g, d, f, g_tx, d_tx, jax.random.fold_in(k_init, m),
                                  forward_variables=shared_f) for m in range(2)]
    np32 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float32), tree)  # noqa: E731

    def trees_of(jst):
        ga, da = jst.g_opt[1][0], jst.d_opt[1][0]
        return {"g": {"params": np32(jst.g.params),
                      "batch_stats": np32(jst.g.extra["batch_stats"])},
                "d": {"params": np32(jst.d.params)}, "f": {"params": np32(jst.f.params)},
                "g_mu": np32(ga.mu), "g_nu": np32(ga.nu), "g_count": int(ga.count),
                "d_mu": np32(da.mu), "d_nu": np32(da.nu), "d_count": int(da.count),
                "step": int(jst.step)}

    stacked = jax.tree.map(lambda *xs: np.stack(xs), *[trees_of(s) for s in jstates])
    settings = StepSettings.from_config(tcfg, detach_forward=False)
    ens, _ = _members(tcfg, 2)
    load_ensemble_states_(ens, stacked)
    assert torch.equal(ens[0].f_params, ens[1].f_params)
    back = ensemble_states_to_flax(ens)
    for a, b in zip(jax.tree.leaves(back["g"]), jax.tree.leaves(stacked["g"])):
        np.testing.assert_array_equal(a, b)

    idx = np.stack([np.stack([np.asarray(j_epoch_indices(k, N, B)) for k in
                              jax.random.split(jax.random.fold_in(key, m), 1)])
                    for m in range(2)])
    pallas = jmk.make_pallas_ensemble_fn(jc, jset, 2, interpret=True)
    jout, jrows = pallas(jstates, jds, key, jnp.ones((1,), jnp.float32))
    ens, trows = gt.make_gan_ensemble_fn(tcfg, settings, 2)(
        ens, tds, torch.ones(1), indices=torch.from_numpy(idx))
    back = ensemble_states_to_flax(ens)
    for m in range(2):
        for k in gt.METRIC_KEYS:
            atol = 1.0 / (SPE * B) if k in ("d_accuracy", "violation_rate") else 1e-6
            np.testing.assert_allclose(trows[m][k].numpy(), np.asarray(jrows[m][k]),
                                       rtol=PALLAS_ROWS_RTOL, atol=atol, err_msg=f"{m} {k}")
        want = trees_of(jout[m])
        for a, b in zip(jax.tree.leaves(back["d"]["params"]),
                        jax.tree.leaves(want["d"]["params"])):
            np.testing.assert_allclose(a[m], b, rtol=0, atol=PARAM_ATOL)
        for a, b in zip(jax.tree.leaves(back["g"]["batch_stats"]),
                        jax.tree.leaves(want["g"]["batch_stats"])):
            np.testing.assert_allclose(a[m], b, rtol=0, atol=STATS_ATOL)
        flat = jax.tree_util.tree_flatten_with_path(want["g"]["params"])[0]
        for (path, leaf), got in zip(flat, jax.tree.leaves(back["g"]["params"])):
            name = "/".join(str(getattr(k, "key", k)) for k in path)
            if name in ("MLPBlock_0/Dense_0/bias", "MLPBlock_1/Dense_0/bias"):
                continue                                        # the gauge leaves
            np.testing.assert_allclose(got[m], leaf, rtol=0, atol=PALLAS_PARAM_ATOL,
                                       err_msg=f"{m} {name}")
        assert back["g_count"][m] == want["g_count"] == SPE
        assert back["step"][m] == SPE
