"""The port's Trainer and the ``pretrain-forward`` command on the CPU.

Both engines run the same draws from one seed (shuffles, then dropout
seeds, from the state's generator) and the same dropout masks, so their
histories agree to rounding (rtol 1e-4 over 3 epochs of 2 steps).  The
control flow (plateau, early stop, keep_best, the nan guard) is checked on
a scripted loss curve.  The command's saved F, carried to flax with
``interop.to_flax``, gives the JAX package's ``ForwardMLP`` the port's
outputs (rtol 1e-5: fp32 products in another order)."""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.interop import to_flax
from pigan_thz_torch.models import build_forward_model
from pigan_thz_torch.ops import forward_train as ft
from pigan_thz_torch.train import checkpoint as ckpt
from pigan_thz_torch.train.schedules import ReduceLROnPlateau
from pigan_thz_torch.train.trainer import Trainer
from pigan_thz_tpu.config import default_config as j_default_config
from pigan_thz_tpu.models import build_forward_model as j_build_forward_model
from pigan_thz_tpu.train import checkpoint as j_ckpt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small():
    cfg = default_config()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_samples=128))
    return cfg, synthetic_dataset(cfg.data, device="cpu")


def test_engines_agree_with_plateau(small):
    """3 epochs, one per chunk; the plateau controller (every epoch is a
    plateau at threshold 0.99) halves the lr scale for the last chunk;
    early stop and keep_best are on and, with a falling loss, change
    nothing."""
    cfg, ds = small
    hist = {}
    for engine in ("eager", "kernel"):
        t = Trainer(cfg, ds=ds, epochs_per_call=1, engine=engine, device="cpu")
        before = dict(ft.LAUNCHES)
        plateau = ReduceLROnPlateau(patience=0, threshold=0.99)
        hist[engine] = t.pretrain_forward(epochs=3, plateau=plateau,
                                          early_stop_patience=1, keep_best=True)
        assert ft.LAUNCHES == before           # the CPU runs the plain version
        assert hist[engine]["forward/lr_scale"] == [1.0, 1.0, 0.5]
        assert t.forward_state.step == t.forward_state.opt.count == 6
        assert t.forward_state.f.model[0].weight.data_ptr() == t.forward_state.params.data_ptr()
    for k in ("forward/loss", "forward/spectrum_loss", "forward/metrics_loss"):
        np.testing.assert_allclose(hist["kernel"][k], hist["eager"][k], rtol=1e-4)
    assert hist["eager"]["forward/loss"][-1] < hist["eager"]["forward/loss"][0]


def _scripted(trainer, losses):
    """Make the trainer's multi-epoch fn return ``losses`` in turn, adding 1
    to every parameter per call, so the restored state tells its chunk."""
    it = iter(losses)

    def fn(state, ds, scales):
        state.params.add_(1.0)
        vals = torch.tensor([next(it) for _ in range(len(scales))])
        return state, {"loss": vals, "spectrum_loss": vals, "metrics_loss": vals * 0}

    trainer._forward_epoch_fn = lambda *a: (fn, "scripted")


def test_early_stop_and_keep_best(small):
    cfg, ds = small
    t = Trainer(cfg, ds=ds, epochs_per_call=2, engine="eager", device="cpu")
    t.pretrain_forward(epochs=0)                 # initialise only
    start = t.forward_state.params.clone()
    _scripted(t, [5.0, 4.0, 4.5, 4.75, 4.875, 3.0])   # exact in float32
    hist = t.pretrain_forward(epochs=6, early_stop_patience=2, keep_best=True)
    assert hist["forward/loss"] == [5.0, 4.0, 4.5, 4.75]     # stopped at epoch 4
    # the state after the first chunk (the last that improved), not the last
    assert torch.equal(t.forward_state.params, start + 1.0)


@pytest.mark.parametrize("bad", ["metric", "state"])
def test_nan_guard_raises(bad, small):
    cfg, ds = small
    t = Trainer(cfg, ds=ds, engine="eager", device="cpu")
    t.pretrain_forward(epochs=0)

    def fn(state, ds, scales):
        vals = torch.ones(len(scales))
        if bad == "metric":
            vals[-1] = float("nan")
        else:
            state.opt.v[3] = float("inf")
        return state, {"loss": vals, "spectrum_loss": vals, "metrics_loss": vals}

    t._forward_epoch_fn = lambda *a: (fn, "scripted")
    with pytest.raises(FloatingPointError, match="non-finite"):
        t.pretrain_forward(epochs=2)


def test_engine_choice(small, capsys):
    cfg, ds = small
    with pytest.raises(ValueError, match="engine"):
        Trainer(cfg, ds=ds, engine="off", device="cpu")
    Trainer(cfg, ds=ds, device="cpu").pretrain_forward(epochs=0)
    assert "eager step (no kernel on cpu)" in capsys.readouterr().err
    odd = cfg.replace(forward_model=dataclasses.replace(cfg.forward_model,
                                                        hidden_dims=(64, 64)))
    with pytest.raises(ValueError, match="engine='kernel'"):
        Trainer(odd, ds=ds, engine="kernel", device="cpu").pretrain_forward(epochs=1)
    with pytest.raises(ValueError, match="schedule"):
        Trainer(cfg, ds=ds, device="cpu").pretrain_forward(epochs=1, schedule="constant")


def test_lr_override_restarts_the_optimiser(small):
    cfg, ds = small
    t = Trainer(cfg, ds=ds, engine="kernel", device="cpu")
    t.pretrain_forward(epochs=1)
    assert t.forward_state.opt.count == 2
    hist = t.pretrain_forward(epochs=1, lr=1e-4, schedule="constant")
    assert t.forward_state.opt.count == 2 and t.forward_state.step == 4
    assert len(hist["forward/loss"]) == 2


def test_pretrain_forward_command_saves_a_flax_compatible_f(tmp_path):
    out = tmp_path / "saved"
    proc = subprocess.run(
        [sys.executable, "-m", "pigan_thz_torch", "pretrain-forward", "--device", "cpu",
         "--epochs", "2", "--set", "data.num_samples=128", "--workdir", str(tmp_path),
         "--out", str(out), "--no-tensorboard"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert "kernel launches: " in proc.stdout and "epoch 2/2" in proc.stdout
    with open(out / ckpt.MODEL_CONFIG) as fh:
        saved = json.load(fh)
    want_dir = tmp_path / "jax"
    j_ckpt.save_model_config(str(want_dir), j_default_config())
    with open(want_dir / ckpt.MODEL_CONFIG) as fh:
        assert saved == json.load(fh)

    cfg = default_config()
    f = ckpt.load_model(str(out), ckpt.FORWARD_MODEL_PRETRAINED,
                        build_forward_model(cfg.forward_model, device="cpu")).eval()
    variables = to_flax(f.state_dict(), "forward_model")
    jf = j_build_forward_model(j_default_config().forward_model)
    x = np.random.default_rng(0).uniform(-1, 1, (16, 4)).astype(np.float32)
    js, jm = jf.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        ts_, tm = f(torch.from_numpy(x))
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-5)
    # trained: not the seed's initial weights
    init = build_forward_model(cfg.forward_model, generator=torch.Generator().manual_seed(42), device="cpu")
    assert not torch.equal(init.model[0].weight, f.model[0].weight)
