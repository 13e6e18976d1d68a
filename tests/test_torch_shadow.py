"""The Trainer's shadow replay on the CPU (``engine="kernel"``: the training
kernels' plain versions stand in for the kernels).

The replay runs a due chunk's first epoch on the eager step from the
pre-chunk state with the chunk's own draws and holds the kernel's
first-epoch metric row to it.  Held here: the cadence against the JAX
package's ``_shadow_due``; a clean run records ``ok`` far inside the
tolerance; a kernel function whose first-epoch row is 10x off (the class the
JAX package's net was built after) raises ``RuntimeError`` and the run does
not continue; the trainer's generator ends where it ends without replays;
the eager engine replays nothing."""

import dataclasses

import pytest
import torch

from pigan_thz_torch import default_config
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.train import trainer as trainer_mod
from pigan_thz_torch.train.steps import StepSettings
from pigan_thz_torch.train.trainer import Trainer
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.config import DataConfig as JDataConfig
from pigan_thz_tpu.data import synthetic_dataset as j_synthetic_dataset
from pigan_thz_tpu.train.trainer import Trainer as JTrainer

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


def _trainer(cfg, ds, engine="kernel", **kw):
    return Trainer(cfg, ds=ds, engine=engine, device="cpu", epochs_per_call=2, **kw)


CHUNKS = ["forward"] * 5 + ["pigan"] * 3 + ["forward", "pigan"] * 4 + ["pigan"] * 5


@pytest.mark.parametrize("cadence", ["first", "all", "every:3", "every:1", "off"])
def test_cadence_is_the_jax_packages(cadence, cfg, ds):
    jcfg = j_default_config().replace(data=JDataConfig(num_samples=64))
    jt = JTrainer(jcfg, ds=j_synthetic_dataset(jcfg.data), shadow_parity=cadence)
    t = _trainer(cfg, ds, shadow_parity=cadence)
    got, want = [], []
    for what in CHUNKS:
        for tr, out in ((jt, want), (t, got)):
            due = tr._shadow_due(what)
            if due:                       # what a replay records
                tr._shadow_done.add(what)
            out.append(due)
    assert got == want
    assert any(got) == (cadence != "off")


def test_shadow_parity_is_validated(cfg, ds):
    for bad in ("every:0", "sometimes"):
        with pytest.raises(ValueError, match="shadow_parity"):
            _trainer(cfg, ds, shadow_parity=bad)


def _run(cfg, ds, **kw):
    t = _trainer(cfg, ds, **kw)
    t.pretrain_forward(epochs=4, log_every=10**9)
    t.init_pigan()
    t.train_pigan(epochs=4, log_every=10**9,
                  settings=StepSettings.from_config(cfg, detach_forward=False))
    return t


def test_clean_run_records_ok(cfg, ds):
    t = _run(cfg, ds, shadow_parity="all")
    assert [(c["what"], c["at"]) for c in t.shadow_checks] == [
        ("forward", 0), ("forward", 2), ("pigan", 0), ("pigan", 2)]
    for check in t.shadow_checks:
        assert check["ok"] and check["worst_rel"] < 1e-3, check
    assert t.shadow_checks[0]["rtol"] == 0.5         # dropout 0.2 in F
    assert t.shadow_checks[2]["rtol"] == 0.25
    # the default cadence replays chunk 0 of each kind
    assert [c["at"] for c in _run(cfg, ds).shadow_checks] == [0, 0]


def test_replays_leave_the_run_as_it_is(cfg, ds):
    """With replays on and off: the same history, the same state, and the
    trainer's generator at the same place."""
    on, off = _run(cfg, ds, shadow_parity="all"), _run(cfg, ds, shadow_parity="off")
    assert off.shadow_checks == [] and len(on.shadow_checks) == 4
    assert on.train_history == off.train_history
    for a, b in ((on.forward_state, off.forward_state), (on.pigan_state, off.pigan_state)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert (torch.equal(sa[k], sb[k]) if isinstance(sa[k], torch.Tensor)
                    else sa[k] == sb[k]), k


def test_eager_engine_replays_nothing(cfg, ds):
    assert _run(cfg, ds, engine="eager", shadow_parity="all").shadow_checks == []


def _faulty(make, keys):
    """``make`` (a kernel-function factory) whose functions return a first
    epoch 10x off in ``keys``."""
    def factory(*a, **kw):
        fn = make(*a, **kw)

        def multi_epoch(*args, **kwargs):
            state, ms = fn(*args, **kwargs)
            ms = dict(ms)
            for k in keys:
                ms[k] = ms[k].clone()
                ms[k][0] *= 10.0
            return state, ms
        return multi_epoch
    return factory


@pytest.mark.parametrize("what", ["forward", "pigan"])
def test_a_planted_first_epoch_fault_raises(what, cfg, ds, monkeypatch):
    t = _trainer(cfg, ds, shadow_parity="every:20")
    settings = StepSettings.from_config(cfg, detach_forward=False)
    if what == "pigan":
        t.pretrain_forward(epochs=2, log_every=10**9)
        t.init_pigan()
        monkeypatch.setattr(trainer_mod, "make_gan_epoch_fn",
                            _faulty(trainer_mod.make_gan_epoch_fn, ["g_loss"]))
    else:
        monkeypatch.setattr(trainer_mod, "make_forward_epoch_fn",
                            _faulty(trainer_mod.make_forward_epoch_fn, ["loss"]))
    history = {k: list(v) for k, v in t.train_history.items()}
    with pytest.raises(RuntimeError, match="disagrees with the eager step's replay"):
        if what == "pigan":
            t.train_pigan(epochs=4, settings=settings, log_every=10**9)
        else:
            t.pretrain_forward(epochs=4, log_every=10**9)
    check = t.shadow_checks[-1]
    assert check["what"] == what and not check["ok"] and check["at"] == 0
    assert check["worst_key"] == ("g_loss" if what == "pigan" else "loss")
    assert check["worst_rel"] > 0.8
    # the run stopped at the faulty chunk: nothing of it was recorded
    assert t.train_history == history
