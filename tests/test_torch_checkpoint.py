"""Full-state checkpoints and resume of the port (``train/checkpoint.py``:
``CheckpointManager``; ``Trainer.resume_from``; the states' ``state_dict``)
on the CPU, against the uninterrupted run and against the JAX package's
Orbax manager.

A run killed after a chunk and resumed in a fresh trainer ends bit for bit
where the uninterrupted run ends: forward and PI-GAN, on the eager step and
on the kernels' plain versions, with the EMA on and off, and with a plateau
controller (tests/test_checkpoint_resume.py:28-73, tests/test_trainer.py:
341-380).  The manager keeps the epochs Orbax keeps on the same save
sequences, and its meta's config is the JAX package's snapshot."""

import dataclasses
import json
import os

import jax.numpy as jnp
import pytest
import torch

from pigan_thz_torch import default_config
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.train import checkpoint as ckpt
from pigan_thz_torch.train.schedules import ReduceLROnPlateau
from pigan_thz_torch.train.state import init_forward_state, make_optimizers
from pigan_thz_torch.train.steps import StepSettings
from pigan_thz_torch.train.trainer import Trainer
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.config import _to_dict as j_to_dict
from pigan_thz_tpu.train import checkpoint as j_ckpt

torch.set_num_threads(1)

N, B = 128, 32


@pytest.fixture(scope="module")
def cfg():
    c = default_config()
    return c.replace(data=dataclasses.replace(c.data, num_samples=N),
                     train=dataclasses.replace(c.train, batch_size=B, num_epochs=4,
                                               fwd_pretrain_epochs=4))


@pytest.fixture(scope="module")
def ds(cfg):
    return synthetic_dataset(cfg.data, device="cpu")


def _trainer(cfg, ds, engine="eager", **kw):
    return Trainer(cfg, ds=ds, engine=engine, device="cpu", epochs_per_call=2, **kw)


def _assert_payloads_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k].cpu(), b[k].cpu()), k
        else:
            assert a[k] == b[k], k


def _stages(cfg, ds, engine, ema, mgr_dir=None):
    """forward 2 + 2 epochs, then PI-GAN 2 + 2 through F, as two calls per
    stage with the pipeline's seeding; with ``mgr_dir`` the run saves after
    each stage's first call and a fresh trainer resumes from it."""
    settings = StepSettings.from_config(cfg, detach_forward=False,
                                        ema_decay=0.9 if ema else 0.0)
    t = _trainer(cfg, ds, engine)
    t.pretrain_forward(epochs=2, seed=0, log_every=10**9)
    if mgr_dir:
        fwd = ckpt.CheckpointManager(os.path.join(mgr_dir, "fwd"), save_interval=1)
        fwd.save(2, t.forward_state, history=t.train_history, config=cfg)
        t = _trainer(cfg, ds, engine)
        assert t.resume_from(fwd, "forward") == 2
    t.pretrain_forward(epochs=2, seed=2, log_every=10**9)
    forward = {k: v.clone() if isinstance(v, torch.Tensor) else v
               for k, v in t.forward_state.state_dict().items()}
    t.init_pigan()
    t.train_pigan(epochs=2, settings=settings, seed=0, log_every=10**9)
    if mgr_dir:
        gan = ckpt.CheckpointManager(os.path.join(mgr_dir, "gan"), save_interval=1)
        gan.save(2, t.pigan_state, history=t.train_history, config=cfg)
        t = _trainer(cfg, ds, engine)
        assert t.resume_from(gan, "pigan") == 2
        assert len(t.train_history["pigan/g_loss"]) == 2
    t.train_pigan(epochs=2, settings=settings, seed=2, log_every=10**9)
    return forward, t


@pytest.mark.parametrize("ema", [False, True], ids=["plain", "ema"])
@pytest.mark.parametrize("engine", ["eager", "kernel"])
def test_kill_and_resume_is_bit_for_bit(engine, ema, cfg, ds, tmp_path):
    ref_forward, ref = _stages(cfg, ds, engine, ema)
    got_forward, got = _stages(cfg, ds, engine, ema, mgr_dir=str(tmp_path))
    assert got.train_history == ref.train_history
    _assert_payloads_equal(got_forward, ref_forward)
    _assert_payloads_equal(got.pigan_state.state_dict(), ref.pigan_state.state_dict())
    assert (got.pigan_state.g_ema is not None) == ema
    # the modules still read the restored buffers: their parameters are views
    p = next(got.pigan_state.g.parameters())
    assert p.data_ptr() == got.pigan_state.g_params.data_ptr()


def test_plateau_controller_resumes_bit_for_bit(cfg, ds, tmp_path):
    """A pristine controller paired with the manager resumes the saved
    reductions (tests/test_trainer.py:341-380), and the run ends where the
    uninterrupted one ends."""
    def controller():
        return ReduceLROnPlateau(factor=0.5, patience=0, threshold=10.0, threshold_mode="abs")

    kw = dict(lr=1e-3, schedule="constant", log_every=10**9)
    ref, ctl = _trainer(cfg, ds), controller()
    ref.pretrain_forward(epochs=4, plateau=ctl, **kw)
    ref.pretrain_forward(epochs=2, plateau=ctl, **kw)
    assert ctl.scale < 1.0

    t1, ctl1 = _trainer(cfg, ds), controller()
    mgr = ckpt.CheckpointManager(str(tmp_path), save_interval=2)
    t1.pretrain_forward(epochs=4, plateau=ctl1, checkpoint_manager=mgr, **kw)
    assert mgr.all_epochs() == [2, 4]
    _, _, meta = mgr.restore_with_meta(None)
    assert meta["extra"]["plateau"] == ctl1.state_dict()

    t2, ctl2 = _trainer(cfg, ds), controller()
    t2.pretrain_forward(epochs=0, lr=1e-3, schedule="constant")   # the state only
    assert t2.resume_from(ckpt.CheckpointManager(str(tmp_path), save_interval=2),
                          "forward") == 4
    t2.pretrain_forward(epochs=2, plateau=ctl2, checkpoint_manager=mgr, **kw)
    assert ctl2.state_dict() == ctl.state_dict()
    assert t2.train_history == ref.train_history
    _assert_payloads_equal(t2.forward_state.state_dict(), ref.forward_state.state_dict())


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------


def _tiny_state():
    model = torch.nn.Sequential(torch.nn.Linear(3, 2))
    _, _, f_tx = make_optimizers(default_config(), 1)
    return init_forward_state(model, f_tx, 0, device="cpu")


def _kept(directory):
    root = os.path.join(directory, "train_state")
    return sorted(int(n) for n in os.listdir(root) if n.isdigit())


SEQUENCES = {
    "chunks_cross_the_interval": [("maybe", e) for e in (25, 50, 75, 100, 125)],
    "saves_and_maybe_saves": [("maybe", 25), ("maybe", 50), ("save", 10), ("maybe", 75),
                              ("save", 200), ("maybe", 210), ("maybe", 239),
                              ("maybe", 240), ("save", 150)],
    "repeated_calls": [("maybe", e) for e in (4, 8, 8, 12, 13, 16)],
    "reopened": [("maybe", 50), ("maybe", 75), ("reopen", None), ("maybe", 5),
                 ("maybe", 80), ("maybe", 90), ("save", 30)],
}


@pytest.mark.parametrize("interval, keep", [(30, 2), (4, 3), (30, None)],
                         ids=["i30_k2", "i4_k3", "i30_all"])
@pytest.mark.parametrize("name", list(SEQUENCES))
def test_manager_keeps_the_epochs_orbax_keeps(name, interval, keep, tmp_path):
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_mgr = j_ckpt.CheckpointManager(j_dir, max_to_keep=keep, save_interval=interval)
    t_mgr = ckpt.CheckpointManager(t_dir, max_to_keep=keep, save_interval=interval)
    tree, state = {"a": jnp.ones(3)}, _tiny_state()
    for op, epoch in SEQUENCES[name]:
        if op == "reopen":
            j_mgr.close()
            j_mgr = j_ckpt.CheckpointManager(j_dir, max_to_keep=keep, save_interval=interval)
            t_mgr = ckpt.CheckpointManager(t_dir, max_to_keep=keep, save_interval=interval)
            got = want = None
        elif op == "maybe":
            want = j_mgr.maybe_save(epoch, tree)
            got = t_mgr.maybe_save(epoch, state)
        else:
            want = j_mgr.save(epoch, tree)
            got = t_mgr.save(epoch, state)
        j_mgr._mgr.wait_until_finished()
        assert got == want, (op, epoch)
        assert _kept(t_dir) == _kept(j_dir) == t_mgr.all_epochs(), (op, epoch)
        assert t_mgr.latest_epoch() == j_mgr.latest_epoch(), (op, epoch)
    j_mgr.close()
    t_mgr.close()


def test_meta_config_is_the_jax_snapshot(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), save_interval=1)
    mgr.save(7, _tiny_state(), history={"forward/loss": [1.5]}, config=default_config(),
             extra={"plateau": {"scale": 0.5}})
    epoch, _, meta = mgr.restore_with_meta(None)
    want = json.loads(json.dumps(j_to_dict(j_default_config())))
    assert epoch == 7 and meta["epoch"] == 7
    assert meta["config"].keys() == want.keys()
    for section in want:
        assert meta["config"][section] == want[section], section
    assert meta["history"] == {"forward/loss": [1.5]}
    assert meta["extra"] == {"plateau": {"scale": 0.5}}


def test_crossing_rule_through_the_trainer(cfg, ds, tmp_path):
    """25-epoch chunks at interval 30 save at 50 and 75
    (tests/test_review_fixes.py:63-71)."""
    small = cfg.replace(data=dataclasses.replace(cfg.data, num_samples=B))
    t = Trainer(small, ds=synthetic_dataset(small.data, device="cpu"), engine="eager",
                device="cpu", epochs_per_call=25)
    mgr = ckpt.CheckpointManager(str(tmp_path), save_interval=30)
    t.init_pigan()
    t.train_pigan(epochs=75, log_every=10**9, checkpoint_manager=mgr)
    assert mgr.all_epochs() == [50, 75] and mgr.latest_epoch() == 75


def test_steps_stay_monotonic_across_calls(cfg, ds, tmp_path):
    """Repeated calls with one manager keep saving at the history's epoch
    count (tests/test_checkpoint_resume.py:133-148)."""
    t = _trainer(cfg, ds)
    t.init_pigan()
    mgr = ckpt.CheckpointManager(str(tmp_path), save_interval=4)
    t.train_pigan(epochs=4, log_every=10**9, checkpoint_manager=mgr)
    assert mgr.latest_epoch() == 4
    t.train_pigan(epochs=4, log_every=10**9, seed=4, checkpoint_manager=mgr)
    assert mgr.all_epochs() == [4, 8]
    _, _, meta = mgr.restore_with_meta(None)
    assert len(meta["history"]["pigan/d_loss"]) == 8


def test_a_half_written_save_is_ignored_and_cleaned(tmp_path):
    root = tmp_path / "train_state"
    mgr = ckpt.CheckpointManager(str(tmp_path), save_interval=1)
    state = _tiny_state()
    mgr.save(3, state)
    (root / "9.partial").mkdir()
    (root / "9.partial" / "state.pt").write_bytes(b"torn")
    again = ckpt.CheckpointManager(str(tmp_path), save_interval=1)
    assert again.latest_epoch() == 3 and again.all_epochs() == [3]
    assert again.restore(_tiny_state())[0] == 3
    again.save(4, state)
    assert sorted(os.listdir(root)) == ["3", "4"]


def test_a_save_of_an_existing_epoch_replaces_it(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), max_to_keep=2, save_interval=1)
    state = _tiny_state()
    mgr.save(1, state)
    mgr.save(2, state)
    state.params.add_(1.0)
    mgr.save(1, state, history={"x": [1.0]})
    assert mgr.all_epochs() == [1, 2] and mgr.latest_epoch() == 1
    fresh = _tiny_state()
    _, _, meta = mgr.restore_with_meta(fresh, 1)
    assert torch.equal(fresh.params, state.params) and meta["history"] == {"x": [1.0]}
    assert sorted(os.listdir(tmp_path / "train_state")) == ["1", "2"]


def test_architecture_mismatch_raises_with_shapes(cfg, ds, tmp_path):
    narrow = cfg.replace(forward_model=dataclasses.replace(cfg.forward_model,
                                                           hidden_dims=(32, 16)))
    t = Trainer(narrow, ds=ds, engine="eager", device="cpu")
    t.pretrain_forward(epochs=0)
    mgr = ckpt.CheckpointManager(str(tmp_path), save_interval=1)
    mgr.save(1, t.forward_state)
    t2 = _trainer(cfg, ds)
    with pytest.raises(ValueError, match="loaded:.*\n.*expected:") as err:
        t2.resume_from(mgr, "forward")
    assert "ForwardState" in str(err.value)
    t2.init_pigan()
    with pytest.raises(ValueError, match="PiGanState"):
        mgr.restore(t2.pigan_state)              # a forward payload is not a GAN state


@pytest.mark.parametrize("saved_ema", [True, False])
def test_ema_and_plain_checkpoints_cross(saved_ema, cfg, ds, tmp_path):
    t = _trainer(cfg, ds)
    t.init_pigan()
    t.train_pigan(epochs=1, log_every=10**9, settings=StepSettings.from_config(
        cfg, ema_decay=0.9 if saved_ema else 0.0))
    mgr = ckpt.CheckpointManager(str(tmp_path), save_interval=1)
    mgr.save(1, t.pigan_state, history=t.train_history)
    other = _trainer(cfg, ds)
    other.init_pigan()
    if not saved_ema:
        other.pigan_state.g_ema = other.pigan_state.g_params.clone()
    assert other.resume_from(mgr, "pigan") == 1
    assert (other.pigan_state.g_ema is not None) == saved_ema
    _assert_payloads_equal(other.pigan_state.state_dict(), t.pigan_state.state_dict())


def test_every_payload_loads_with_weights_only(cfg, ds, tmp_path):
    t = _trainer(cfg, ds)
    t.pretrain_forward(epochs=1, log_every=10**9)
    t.init_pigan()
    t.train_pigan(epochs=1, log_every=10**9,
                  settings=StepSettings.from_config(cfg, ema_decay=0.5))
    for which, state in (("fwd", t.forward_state), ("gan", t.pigan_state)):
        mgr = ckpt.CheckpointManager(str(tmp_path / which), save_interval=1)
        mgr.save(1, state)
        payload = torch.load(str(tmp_path / which / "train_state" / "1" / "state.pt"),
                             weights_only=True)
        assert all(isinstance(v, (torch.Tensor, int)) for v in payload.values())
        assert payload["generator"].dtype == torch.uint8
        _assert_payloads_equal(payload, state.state_dict())
    assert any(k.startswith("g.") and k.endswith("running_mean") for k in payload)


def test_resume_logs_a_changed_model_section(cfg, ds, tmp_path, capsys):
    t = _trainer(cfg, ds)
    t.pretrain_forward(epochs=1, log_every=10**9)
    mgr = ckpt.CheckpointManager(str(tmp_path), save_interval=1)
    mgr.save(1, t.forward_state, config=cfg)
    other = cfg.replace(forward_model=dataclasses.replace(cfg.forward_model,
                                                          dropout_rate=0.0))
    t2 = Trainer(other, ds=ds, engine="eager", device="cpu")
    assert t2.resume_from(mgr, "forward") == 1
    assert "forward_model config differs" in capsys.readouterr().err
    assert _trainer(cfg, ds).resume_from(ckpt.CheckpointManager(str(tmp_path / "e")),
                                         "pigan") is None

