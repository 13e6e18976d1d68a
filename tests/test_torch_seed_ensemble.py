"""``parallel/ensemble_megakernel.py`` on the CPU (the kernels' plain
versions): the seed-ensemble training functions and the state carry-over.

At the baseline widths the kernels need: 128 samples, batch 32 (4 steps an
epoch), 3 epochs in chunks of 2 (one full chunk and a remainder chunk), a
freshly initialised shared F.  Equalities are exact (``torch.equal`` /
``array_equal``): packed, unpacked and solo training run the same plain-version
arithmetic on the same member."""

import dataclasses

import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.interop import ensemble_states_to_flax, load_ensemble_states_
from pigan_thz_torch.models import build_trio
from pigan_thz_torch.ops import gan_train as gt
from pigan_thz_torch.parallel.ensemble import member_generator
from pigan_thz_torch.parallel.ensemble_megakernel import (
    _chunk_sizes,
    train_seed_ensemble,
    train_settings_sweep,
)
from pigan_thz_torch.parallel.state_utils import EnsembleState
from pigan_thz_torch.train.state import init_pigan_state, make_optimizers
from pigan_thz_torch.train.steps import StepSettings

torch.set_num_threads(1)

N, B, EPOCHS, PER_CALL = 128, 32, 3, 2
SPE = N // B
CPU = ["cpu"]


@pytest.fixture(scope="module")
def cfg():
    c = default_config()
    return c.replace(data=dataclasses.replace(c.data, num_samples=N),
                     train=dataclasses.replace(c.train, batch_size=B, num_epochs=EPOCHS))


@pytest.fixture(scope="module")
def ds(cfg):
    return synthetic_dataset(cfg.data, device="cpu")


@pytest.fixture(scope="module")
def shared_f(cfg):
    return build_trio(cfg, device="cpu", generator=torch.Generator().manual_seed(9))[2]


def _tensors(states):
    bufs = gt.ensemble_buffers(states)
    return [*bufs[:6], *bufs.bn]


@pytest.fixture(scope="module")
def packed_run(cfg, ds, shared_f):
    settings = StepSettings.from_config(cfg, detach_forward=False)
    return settings, train_seed_ensemble(
        cfg, ds, 2, settings=settings, epochs=EPOCHS, seed=7, devices=CPU,
        epochs_per_call=PER_CALL, forward_model=shared_f, packed=True)


def test_chunk_sizes():
    assert _chunk_sizes(3, 2) == [2, 1] and _chunk_sizes(4, 2) == [2, 2]
    assert _chunk_sizes(1, 25) == [1] and _chunk_sizes(50, 25) == [25, 25]


def test_metrics_have_one_row_per_member_and_epoch(packed_run):
    _, (states, metrics) = packed_run
    assert isinstance(states, EnsembleState) and len(states) == 2
    assert set(metrics) == set(gt.METRIC_KEYS)
    for k, v in metrics.items():
        assert isinstance(v, np.ndarray) and v.shape == (2, EPOCHS), k
        assert np.isfinite(v).all(), k
    assert not np.array_equal(metrics["g_loss"][0], metrics["g_loss"][1])
    assert [(st.step, st.g_opt.count, st.d_opt.count) for st in states] == [
        (EPOCHS * SPE,) * 3] * 2
    assert all(int(bn.num_batches_tracked) == EPOCHS * SPE
               for st in states for bn in st.batch_norms())
    assert states.shared_f and states[1].f is states[0].f


def test_packed_equals_unpacked_bit_for_bit(packed_run, cfg, ds, shared_f):
    settings, (packed, pm) = packed_run
    unpacked, um = train_seed_ensemble(
        cfg, ds, 2, settings=settings, epochs=EPOCHS, seed=7, devices=CPU,
        epochs_per_call=PER_CALL, forward_model=shared_f)
    assert set(pm) == set(um)
    for k in pm:
        np.testing.assert_array_equal(pm[k], um[k], err_msg=k)
    for a, b in zip(_tensors(packed), _tensors(unpacked)):
        assert torch.equal(a, b)
    assert unpacked.shared_f


@pytest.mark.parametrize("member", [0, 1])
def test_member_equals_a_solo_run_from_the_same_seed_and_index(member, packed_run, cfg, ds,
                                                               shared_f):
    """Member i's weights and shuffles come from (seed, i) alone: the same
    member trained by itself, in the same chunks, is bit-equal."""
    settings, (packed, pm) = packed_run
    g, d, _ = build_trio(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(cfg.train.seed))
    gtx, dtx, _ = make_optimizers(cfg, SPE)
    st = init_pigan_state(g, d, shared_f, gtx, dtx, member_generator(7, member), device="cpu")
    fn = gt.make_gan_epoch_fn(cfg, settings)
    curves = []
    for chunk in (2, 1):
        st, rows = fn(st, ds, torch.ones(chunk))
        curves.append(rows["g_loss"])
    np.testing.assert_array_equal(torch.cat(curves).numpy(), pm["g_loss"][member])
    assert torch.equal(st.g_params, packed.g_params[member])
    assert torch.equal(st.d_opt.v, packed.d_v[member])
    assert torch.equal(st.batch_norms()[0].running_var, packed.bn[1][member])
    # and it is another member than its neighbour or the same index of another seed
    other = member_generator(7, 1 - member).initial_seed()
    assert other != member_generator(7, member).initial_seed() != member_generator(
        8, member).initial_seed()


def test_three_members_on_two_device_groups(cfg, ds, shared_f):
    """Members round-robin over the device list: two groups (sizes 2 and 1)
    of a packed run are the same members as one group of 3."""
    settings = StepSettings.from_config(cfg, detach_forward=True, d_update_every=2)
    kw = dict(settings=settings, epochs=2, seed=1, epochs_per_call=PER_CALL,
              forward_model=shared_f, packed=True)
    one, m1 = train_seed_ensemble(cfg, ds, 3, devices=CPU, **kw)
    two, m2 = train_seed_ensemble(cfg, ds, 3, devices=["cpu", "cpu:0"], **kw)
    for k in m1:
        np.testing.assert_array_equal(m1[k], m2[k], err_msg=k)
    for a, b in zip(_tensors(one), _tensors(two)):
        assert torch.equal(a, b)
    assert [st.d_opt.count for st in two] == [SPE] * 3


def test_settings_sweep_shares_init_and_batches(cfg, ds, shared_f):
    base = StepSettings.from_config(cfg, detach_forward=True)
    arms = [base, base, dataclasses.replace(base, constraint_w=0.7, d_update_every=2)]
    states, metrics = train_settings_sweep(
        cfg, ds, arms, epochs=EPOCHS, seed=3, devices=CPU, epochs_per_call=PER_CALL,
        forward_model=shared_f, scales=torch.tensor([1.0, 0.5, 0.25]))
    assert isinstance(states, EnsembleState) and len(states) == len(metrics) == 3
    assert "constraint_loss" in metrics[2] and "constraint_loss" not in metrics[0]
    assert all(v.shape == (EPOCHS,) for m in metrics for v in m.values())
    # equal settings from the shared init on the shared batches: equal arms
    for k in metrics[0]:
        np.testing.assert_array_equal(metrics[0][k], metrics[1][k], err_msg=k)
    assert torch.equal(states.g_params[0], states.g_params[1])
    # other settings: another result, from the same first batch
    assert not torch.equal(states.g_params[0], states.g_params[2])
    assert not np.array_equal(metrics[0]["g_loss"], metrics[2]["g_loss"])
    assert states[2].d_opt.count < states[0].d_opt.count == EPOCHS * SPE
    # the arms own their buffers: rows of one stack, no aliasing
    assert states[0].g_params.data_ptr() != states[1].g_params.data_ptr()


def test_refusals(cfg, ds, shared_f):
    kw = dict(devices=CPU, forward_model=shared_f)
    with pytest.raises(ValueError, match="epochs must be >= 1"):
        train_seed_ensemble(cfg, ds, 2, epochs=0, **kw)
    with pytest.raises(ValueError, match="num_members must be >= 1"):
        train_seed_ensemble(cfg, ds, 0, epochs=1, **kw)
    with pytest.raises(ValueError, match="packed=True needs a shared forward_model"):
        train_seed_ensemble(cfg, ds, 2, epochs=1, devices=CPU, packed=True)
    with pytest.raises(ValueError, match="packed=True: ema_decay > 0 unsupported"):
        train_seed_ensemble(cfg, ds, 2, epochs=1, packed=True,
                            settings=StepSettings.from_config(cfg, ema_decay=0.9), **kw)
    with pytest.raises(ValueError, match=r"scales must have shape \(2,\)"):
        train_seed_ensemble(cfg, ds, 2, epochs=2, scales=torch.ones(3), **kw)
    with pytest.raises(ValueError, match="pass devices"):
        train_seed_ensemble(cfg, ds, 2, epochs=1, forward_model=shared_f)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2"):
        train_seed_ensemble(cfg, ds, 2, epochs=1,
                            settings=StepSettings.from_config(cfg, cycle_w=0.1), **kw)
    base = StepSettings.from_config(cfg)
    with pytest.raises(ValueError, match="agree on ema_decay"):
        train_settings_sweep(cfg, ds, [base, dataclasses.replace(base, ema_decay=0.9)],
                             epochs=1, **kw)
    with pytest.raises(ValueError, match="non-empty"):
        train_settings_sweep(cfg, ds, [], epochs=1, **kw)
    with pytest.raises(ValueError, match="epochs must be >= 1"):
        train_settings_sweep(cfg, ds, [base], epochs=0, **kw)


def test_unpacked_members_may_carry_an_ema_and_a_fresh_f(cfg, ds):
    settings = StepSettings.from_config(cfg, ema_decay=0.9)
    states, metrics = train_seed_ensemble(cfg, ds, 2, settings=settings, epochs=1,
                                          devices=CPU)
    assert states.g_ema is not None and states.g_ema.shape == states.g_params.shape
    assert not torch.equal(states.g_ema, states.g_params)
    assert not states.shared_f          # each member drew its own F
    assert metrics["d_loss"].shape == (2, 1)


def test_non_finite_chunk_raises(cfg, ds, shared_f):
    bad = type(ds)(*(t.clone() for t in ds))
    bad.spectra[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite"):
        train_seed_ensemble(cfg, bad, 2, epochs=1, devices=CPU, forward_model=shared_f,
                            packed=True)


def test_carry_over_round_trip(packed_run):
    """``ensemble_states_to_flax(load_ensemble_states_(x)) == x`` on the
    trained members: every leaf stacked on a leading member axis."""
    _, (states, _) = packed_run
    trees = ensemble_states_to_flax(states)
    assert trees["g"]["params"]["Dense_0"]["kernel"].shape == (2, 256, 4)
    assert trees["g"]["batch_stats"]["MLPBlock_0"]["NormAct_0"]["BatchNorm_0"]["mean"].shape \
        == (2, 512)
    assert trees["d_nu"]["Dense_0"]["kernel"].shape == (2, 254, 512)
    assert trees["g_count"].tolist() == [EPOCHS * SPE] * 2 and trees["step"].shape == (2,)
    fresh = states.clone()
    with torch.no_grad():
        for t in _tensors(fresh):
            t.zero_()
    for st in fresh:
        st.step = st.g_opt.count = st.d_opt.count = 0
    load_ensemble_states_(fresh, trees)
    for a, b in zip(_tensors(fresh), _tensors(states)):
        assert torch.equal(a, b)
    assert fresh[1].g_params.data_ptr() == fresh.g_params[1].data_ptr()   # views stay bound
    assert [(st.step, st.g_opt.count) for st in fresh] == [(EPOCHS * SPE,) * 2] * 2
    back = ensemble_states_to_flax(fresh)

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        return [np.asarray(tree)]

    for a, b in zip(leaves(back), leaves(trees)):
        np.testing.assert_array_equal(a, b)
