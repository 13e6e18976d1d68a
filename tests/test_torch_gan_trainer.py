"""The Trainer's PI-GAN phase, the final artifacts and the ``train`` command
of the port, on the CPU at a small size (128 samples, batch 32, baseline
widths: the kernel path needs them)."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config
from pigan_thz_torch.cli import main as cli_main
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.interop import to_flax
from pigan_thz_torch.models import build_trio
from pigan_thz_torch.ops import gan_train as gt
from pigan_thz_torch.train import checkpoint as ckpt
from pigan_thz_torch.train.steps import StepSettings
from pigan_thz_torch.train.trainer import Trainer
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.models import build_generator as j_build_generator

torch.set_num_threads(1)

N, B = 128, 32
SPE = N // B
PIGAN_KEYS = {f"pigan/{k}" for k in gt.METRIC_KEYS}


@pytest.fixture(scope="module")
def cfg():
    c = default_config()
    return c.replace(data=dataclasses.replace(c.data, num_samples=N),
                     train=dataclasses.replace(c.train, batch_size=B, num_epochs=4,
                                               fwd_pretrain_epochs=2))


@pytest.fixture(scope="module")
def ds(cfg):
    return synthetic_dataset(cfg.data, device="cpu")


def _trainer(cfg, ds, engine="auto", **kw):
    return Trainer(cfg, ds=ds, engine=engine, device="cpu", **kw)


@pytest.mark.parametrize("engine", ["auto", "eager", "kernel"])
def test_train_full_runs_both_phases(engine, cfg, ds, capsys):
    tr = _trainer(cfg, ds, engine, epochs_per_call=1)
    before = dict(gt.LAUNCHES)
    hist = tr.train(mode="full", forward_epochs=2, gan_epochs=2)
    assert gt.LAUNCHES == before                       # the CPU launches nothing
    assert PIGAN_KEYS <= set(hist) and "forward/loss" in hist
    assert all(len(hist[k]) == 2 for k in PIGAN_KEYS)
    assert all(np.isfinite(v).all() for v in hist.values())
    st = tr.pigan_state
    assert (st.step, st.g_opt.count, st.d_opt.count) == (2 * SPE,) * 3
    assert st.is_finite() and st.g_ema is None
    # the frozen F is the pretrained one, a copy
    assert torch.equal(st.f_params, tr.forward_state.params)
    assert st.f_params.data_ptr() != tr.forward_state.params.data_ptr()
    said = capsys.readouterr().err
    want = "GAN-training kernel (its plain version)" if engine == "kernel" else (
        "PI-GAN training on the eager step")
    assert want in said


def test_engines_agree_on_the_cpu(cfg, ds):
    """engine='kernel' (the plain version) and engine='eager' from one seed:
    the same shuffles, rows within 1e-3 relative over 2 epochs."""
    runs = {}
    for engine in ("eager", "kernel"):
        tr = _trainer(cfg, ds, engine)
        tr.pretrain_forward(epochs=1)
        tr.init_pigan()
        runs[engine] = tr.train_pigan(epochs=2, settings=StepSettings.from_config(
            cfg, detach_forward=False))
    for k in PIGAN_KEYS - {"pigan/d_accuracy", "pigan/violation_rate"}:
        np.testing.assert_allclose(runs["kernel"][k], runs["eager"][k], rtol=1e-3, err_msg=k)


def test_modes_and_unknown_mode(cfg, ds):
    tr = _trainer(cfg, ds)
    tr.train(mode="forward_only", epochs=1)
    assert tr.pigan_state is None and len(tr.train_history["forward/loss"]) == 1
    tr.train(mode="pigan_only", epochs=1)
    assert tr.pigan_state.step == SPE
    with pytest.raises(ValueError, match="unknown mode"):
        tr.train(mode="everything")


def test_init_pigan_refreshes_only_the_forward_model(cfg, ds):
    tr = _trainer(cfg, ds)
    first = tr.init_pigan()                        # no pretrained F: a fresh one
    g0, f0 = first.g_params.clone(), first.f_params.clone()
    tr.pretrain_forward(epochs=1)
    again = tr.init_pigan()
    assert again is first and torch.equal(again.g_params, g0)
    assert not torch.equal(again.f_params, f0)
    assert torch.equal(again.f_params, tr.forward_state.params)
    fresh = tr.init_pigan(seed=1, fresh_gd=True)
    assert fresh is not first and not torch.equal(fresh.g_params, g0)


def test_snapshot_restore_early_stop_and_constraint_schedule(cfg, ds):
    tr = _trainer(cfg, ds, epochs_per_call=1)
    seen = []

    def schedule(epoch):
        seen.append(epoch)
        return 1.0 / (1 + epoch)

    settings = StepSettings.from_config(cfg, constraint_w=0.5)
    # "max" on a loss that falls: the best epoch is the first, so the state
    # restored at the end is the one after chunk 1
    hist = tr.train_pigan(epochs=3, settings=settings, constraint_schedule=schedule,
                          snapshot_metric="recon_spec_loss", snapshot_mode="max")
    assert seen == [0, 1, 2] and len(hist["pigan/constraint_loss"]) == 3
    recon = hist["pigan/recon_spec_loss"]
    best = int(np.argmax(recon))
    assert tr.pigan_state.step == (best + 1) * SPE
    stop_at = []
    tr2 = _trainer(cfg, ds, epochs_per_call=2)
    tr2.train_pigan(epochs=4, early_stop=lambda m: stop_at.append(m["g_loss"]) or True)
    assert len(stop_at) == 1 and len(tr2.train_history["pigan/g_loss"]) == 1
    assert tr2.pigan_state.step == 2 * SPE           # the chunk ran to its end


def test_overrides_start_the_moments_afresh(cfg, ds):
    tr = _trainer(cfg, ds, "kernel")
    tr.train_pigan(epochs=1)
    st = tr.pigan_state
    assert st.g_opt.count == SPE and float(st.g_opt.v.abs().max()) > 0
    d_v = st.d_opt.v.clone()
    tr.train_pigan(epochs=0, lr_g=1e-3, schedule_g="linear")
    assert st.g_opt.count == 0 and float(st.g_opt.v.abs().max()) == 0.0
    assert st.d_opt.count == SPE and torch.equal(st.d_opt.v, d_v)      # D untouched
    tr.train_pigan(epochs=1, lr_d=5e-4)
    assert (st.g_opt.count, st.d_opt.count, st.step) == (SPE, SPE, 2 * SPE)


def test_ema_track_starts_at_the_current_generator(cfg, ds):
    tr = _trainer(cfg, ds, "kernel")
    tr.train_pigan(epochs=1)
    assert tr.pigan_state.g_ema is None
    tr.train_pigan(epochs=1, settings=StepSettings.from_config(cfg, ema_decay=0.5))
    st = tr.pigan_state
    assert st.g_ema is not None and not torch.equal(st.g_ema, st.g_params)
    assert float((st.g_ema - st.g_params).abs().max()) < 5e-3


@pytest.mark.parametrize("knobs", [dict(gan_loss="wgan_gp"), dict(cycle_w=1.0),
                                   dict(stability_w=0.5), dict(instance_noise=0.05)],
                         ids=lambda k: next(iter(k)))
def test_kernel_engine_raises_outside_the_kernel_s_reach(knobs, cfg, ds, capsys):
    """wgan_gp, the second G passes and instance noise are inside the
    kernel's reach: engine='kernel' trains them through the plain version,
    and from one seed as engine='auto' (the eager step) does, rows within
    1e-3 relative.  bfloat16 Adam moments are outside it (an XLA-path
    optimiser in the JAX package, refused by its kernels too) and raise,
    naming the eager engine."""
    settings = StepSettings.from_config(cfg, **knobs)
    moments = cfg.replace(train=dataclasses.replace(cfg.train, adam_state_dtype="bfloat16"))
    with pytest.raises(ValueError, match="adam_state_dtype") as err:
        _trainer(moments, ds, "kernel").train_pigan(epochs=1, settings=settings)
    assert "engine='eager'" in str(err.value)
    kern = _trainer(cfg, ds, "kernel")
    kern.train_pigan(epochs=1, settings=settings)
    assert "GAN-training kernel (its plain version)" in capsys.readouterr().err
    # on the CPU, where there is no kernel, auto says so and takes the eager step
    tr = _trainer(cfg, ds, "auto")
    tr.train_pigan(epochs=1, settings=settings)
    assert len(tr.train_history["pigan/g_loss"]) == 1
    assert "eager step" in capsys.readouterr().err
    for k in PIGAN_KEYS - {"pigan/d_accuracy", "pigan/violation_rate"}:
        np.testing.assert_allclose(kern.train_history[k], tr.train_history[k], rtol=1e-3,
                                   err_msg=k)


@pytest.mark.parametrize("knobs", [dict(gan_loss="wgan_gp"), dict(cycle_w=1.0),
                                   dict(augment_noise=0.05), dict(), "adam_bf16"],
                         ids=["wgan_gp", "cycle_w", "augment_noise", "narrow_generator",
                              "adam_bf16"])
def test_auto_on_the_card_is_the_kernel_or_an_error(knobs, cfg, ds, capsys):
    """The engine rule as a CUDA device sees it (the rule reads only the
    device's type, so a trainer built on the CPU can be asked): what the
    kernel does not take (a generator of other widths, bfloat16 Adam
    moments) raises under "auto", naming it and the eager engine, and only
    engine="eager" takes the eager step; WGAN-GP, cycle and the augmentation
    are the kernel's own paths."""
    base = cfg
    if not knobs:
        cfg = cfg.replace(generator=dataclasses.replace(cfg.generator, hidden_dims=(64, 32)))
    what = "generator"
    if knobs == "adam_bf16":
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, adam_state_dtype="bfloat16"))
        knobs, what = {}, "adam_state_dtype"
    settings = StepSettings.from_config(cfg, **knobs)
    tr = _trainer(cfg, ds, "auto")
    tr.device = torch.device("cuda", 0)
    if knobs:
        # WGAN-GP, cycle and the augmentation are the kernel's own paths: auto takes it
        assert tr._gan_epoch_fn(settings, tr.g_tx, tr.d_tx, {}, 1)[1] == "kernel"
        assert "GAN-training kernel (the CUDA kernel)" in capsys.readouterr().err
        return
    with pytest.raises(ValueError, match=what) as err:
        tr._gan_epoch_fn(settings, tr.g_tx, tr.d_tx, {}, 1)
    assert "engine='eager'" in str(err.value)
    tr.engine = "eager"
    assert tr._gan_epoch_fn(settings, tr.g_tx, tr.d_tx, {}, 1)[1] == "eager"
    assert "eager step (engine='eager')" in capsys.readouterr().err
    # inside the kernel's reach auto is the kernel
    tr.engine, tr.cfg = "auto", base
    assert tr._gan_epoch_fn(StepSettings.from_config(base), tr.g_tx, tr.d_tx, {}, 1)[1] == (
        "kernel")
    assert "GAN-training kernel (the CUDA kernel)" in capsys.readouterr().err


def test_auto_on_the_card_refuses_a_forward_model_the_kernel_lacks(cfg, ds):
    odd = cfg.replace(forward_model=dataclasses.replace(cfg.forward_model,
                                                        hidden_dims=(64, 64)))
    tr = _trainer(odd, ds, "auto")
    tr.device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="engine='auto' but: forward model"):
        tr._forward_epoch_fn(None, tr.f_tx, None, 1, "cosine")


def test_kernel_engine_raises_outside_the_envelope(cfg, ds):
    narrow = cfg.replace(generator=dataclasses.replace(cfg.generator, hidden_dims=(64, 32)))
    with pytest.raises(ValueError, match="generator"):
        _trainer(narrow, ds, "kernel").train_pigan(epochs=1)


def test_non_finite_chunk_raises(cfg, ds):
    tr = _trainer(cfg, ds, "kernel")
    tr.init_pigan()
    tr.pigan_state.d_params[0] = float("nan")
    with pytest.raises(FloatingPointError):
        tr.train_pigan(epochs=1)


def test_artifacts_round_trip(cfg, ds, tmp_path):
    tr = _trainer(cfg, ds)
    with pytest.raises(ValueError, match="init_pigan"):
        tr.save_final(str(tmp_path))
    tr.train(mode="full", forward_epochs=1, gan_epochs=1)
    tr.train_pigan(epochs=1, settings=StepSettings.from_config(cfg, ema_decay=0.9))
    out = str(tmp_path / "saved")
    tr.save_final(out, backup_tag="unit")
    names = {"generator_final", "discriminator_final", "forward_model_final",
             "forward_model_pretrained", "generator_ema", "generator_unit",
             "discriminator_unit", "forward_model_unit"}
    assert {f[:-4] for f in os.listdir(out) if f.endswith(".pth")} == names
    assert ckpt.load_train_history(out) == tr.train_history
    assert ckpt.load_model_config(out)["discriminator"]["hidden_dims"] == [512, 256]
    with pytest.raises(ValueError, match="collides"):
        tr.save_final(out, backup_tag="ema")

    g, d, f = ckpt.load_final_trio(out, *build_trio(cfg, device="cpu"))
    st = tr.pigan_state
    for module, want in ((g, st.g), (d, st.d), (f, st.f)):
        for (ka, va), (kb, vb) in zip(module.state_dict().items(), want.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)

    other = _trainer(cfg, ds)
    other.load_final(out)
    ot = other.pigan_state
    assert torch.equal(ot.g_params, st.g_params) and torch.equal(ot.d_params, st.d_params)
    assert torch.equal(ot.f_params, st.f_params) and torch.equal(ot.g_ema, st.g_ema)
    assert ot.g.main[0].weight.data_ptr() == ot.g_params.data_ptr()
    assert other.train_history == tr.train_history
    for a, b in zip(ot.batch_norms(), st.batch_norms()):
        assert torch.equal(a.running_var, b.running_var)

    # generator_ema.pth is a generator: the JAX package's flax module takes it
    ema = torch.load(os.path.join(out, "generator_ema.pth"), weights_only=True)
    variables = to_flax(ema, "generator")
    x = np.random.default_rng(0).normal(size=(8, 250)).astype(np.float32)
    jg = j_build_generator(j_default_config().generator)
    want = np.asarray(jg.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = ckpt.ema_generator(st).eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _train_args(tmp_path, *extra):
    return ["train", "--device", "cpu", "--set", f"data.num_samples={N}",
            "--set", f"train.batch_size={B}", "--workdir", str(tmp_path),
            "--no-tensorboard", *extra]


def test_train_command_full(tmp_path, capsys):
    rc = cli_main(_train_args(tmp_path, "--mode", "full", "--epochs", "2",
                              "--forward-epochs", "1", "--fixed-physics",
                              "--ema-decay", "0.9", "--backup-tag", "unit"))
    assert rc == 0
    out = tmp_path / "saved_models"
    for name in ("generator_final", "discriminator_final", "forward_model_final",
                 "forward_model_pretrained", "generator_ema", "generator_unit"):
        assert (out / f"{name}.pth").is_file(), name
    hist = json.loads((out / "training_history.json").read_text())
    assert len(hist["pigan/g_loss"]) == 2 and len(hist["forward/loss"]) == 1
    said = capsys.readouterr().out
    assert "kernel launches" in said and "saved final models" in said


def test_train_command_takes_an_engine(tmp_path, capsys):
    assert cli_main(_train_args(tmp_path, "--epochs", "1", "--forward-epochs", "1",
                                "--engine", "kernel")) == 0
    said = capsys.readouterr().out
    assert "forward-training kernel (its plain version)" in said
    assert "GAN-training kernel (its plain version)" in said
    assert cli_main(_train_args(tmp_path, "--mode", "pigan_only", "--epochs", "1",
                                "--engine", "eager")) == 0
    assert "PI-GAN training on the eager step (engine='eager')" in capsys.readouterr().out


def test_train_command_pigan_only_takes_a_pretrained_f(tmp_path):
    fwd = tmp_path / "fwd"
    assert cli_main(_train_args(tmp_path, "--mode", "forward_only", "--epochs", "1",
                                "--out", str(fwd))) == 0
    assert (fwd / "forward_model_pretrained.pth").is_file()
    assert not (fwd / "generator_final.pth").exists()
    out = tmp_path / "gan"
    assert cli_main(_train_args(tmp_path, "--mode", "pigan_only", "--epochs", "1",
                                "--forward-model", str(fwd / "forward_model_pretrained"),
                                "--out", str(out))) == 0
    a = torch.load(fwd / "forward_model_pretrained.pth", weights_only=True)
    b = torch.load(out / "forward_model_final.pth", weights_only=True)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_train_command_ties_the_horizon_to_epochs(tmp_path, monkeypatch):
    seen = {}
    real = Trainer.train_pigan

    def spy(self, *a, **kw):
        seen["num_epochs"] = self.cfg.train.num_epochs
        seen["fwd"] = self.cfg.train.fwd_pretrain_epochs
        seen["detach"] = kw["settings"].detach_forward
        return real(self, *a, **kw)

    monkeypatch.setattr(Trainer, "train_pigan", spy)
    cli_main(_train_args(tmp_path, "--epochs", "3", "--forward-epochs", "1"))
    assert seen == {"num_epochs": 3, "fwd": 1, "detach": True}


@pytest.mark.parametrize("flag, waits_for", [
    (["--preset", "optimized"], "residual")])
def test_train_command_guards_what_is_not_ported(flag, waits_for, tmp_path):
    with pytest.raises(NotImplementedError, match=waits_for) as err:
        cli_main(_train_args(tmp_path, *flag))
    assert "ROADMAP.md" in str(err.value)


def test_train_command_refuses_colliding_tag_and_missing_card(tmp_path):
    with pytest.raises(SystemExit, match="collides"):
        cli_main(_train_args(tmp_path, "--backup-tag", "final"))
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli_main(["train", "--workdir", str(tmp_path), "--epochs", "1"])


def test_load_model_takes_wrapped_checkpoints_and_the_fallback_file(cfg, tmp_path):
    """The loader's rules of the reference's artifacts: a bare state_dict, a
    training checkpoint that wraps it (by the model's own key, then
    ``model_state_dict``, then ``state_dict``), ``forward_model_pretrained``
    where ``forward_model_final`` is absent, missing files named, another
    architecture's shapes shown."""
    g, d, f = build_trio(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    out = str(tmp_path)
    torch.save({"epoch": 7, "generator_state_dict": g.state_dict(),
                "discriminator_state_dict": d.state_dict(), "note": "wrapped"},
               os.path.join(out, "generator_final.pth"))
    torch.save({"model_state_dict": d.state_dict(), "epoch": 7},
               os.path.join(out, "discriminator_final.pth"))
    ckpt.save_model(out, ckpt.FORWARD_MODEL_PRETRAINED, f)
    g2, d2, f2 = build_trio(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    assert not torch.equal(g2.main[0].weight, g.main[0].weight)
    ckpt.load_final_trio(out, g2, d2, f2)
    for a, b in ((g2, g), (d2, d), (f2, f)):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)
    torch.save({"state_dict": g.state_dict()}, os.path.join(out, "generator_other.pth"))
    ckpt.load_model(out, "generator_other", g2)
    assert ckpt.extract_state_dict(g.state_dict(), "generator") is not None
    with pytest.raises(KeyError, match="no state_dict for 'generator'"):
        ckpt.extract_state_dict({"epoch": 5, "discriminator_state_dict": {}}, "generator")
    with pytest.raises(KeyError, match="no state_dict"):
        ckpt.extract_state_dict({}, "generator")
    with pytest.raises(TypeError, match="unsupported .pth payload"):
        ckpt.extract_state_dict([1, 2], "generator")
    with pytest.raises(FileNotFoundError, match="generator_missing.pth"):
        ckpt.load_model(out, "generator_missing", g2)
    os.remove(os.path.join(out, "forward_model_pretrained.pth"))
    with pytest.raises(FileNotFoundError, match="forward_model_pretrained.pth"):
        ckpt.load_model(out, ckpt.FORWARD_MODEL_FINAL, f2)
    narrow = build_trio(cfg.replace(generator=dataclasses.replace(
        cfg.generator, hidden_dims=(64, 32))), device="cpu")[0]
    with pytest.raises(ValueError, match="does not match the MLPGenerator") as err:
        ckpt.load_model(out, "generator_final", narrow)
    assert "(512, 250)" in str(err.value) and "(64, 250)" in str(err.value)


def test_load_final_takes_a_wrapped_trio_and_keeps_its_own_history(cfg, ds, tmp_path):
    tr = _trainer(cfg, ds)
    tr.train(mode="full", forward_epochs=1, gan_epochs=1)
    out = str(tmp_path / "saved")
    tr.save_final(out)
    # the generator as a wrapped training checkpoint, as the reference writes them
    sd = torch.load(os.path.join(out, "generator_final.pth"), weights_only=True)
    torch.save({"epoch": 1, "generator_state_dict": sd},
               os.path.join(out, "generator_final.pth"))
    fresh = _trainer(cfg, ds)
    fresh.load_final(out)
    assert torch.equal(fresh.pigan_state.g_params, tr.pigan_state.g_params)
    assert fresh.train_history == tr.train_history          # it had none: the saved one
    busy = _trainer(cfg, ds)
    busy.train_pigan(epochs=2)
    own = {k: list(v) for k, v in busy.train_history.items()}
    busy.load_final(out)
    assert busy.train_history == own and len(own["pigan/g_loss"]) == 2
    assert torch.equal(busy.pigan_state.g_params, tr.pigan_state.g_params)


def test_trainer_evaluate_reads_the_trained_state(cfg, ds):
    tr = _trainer(cfg, ds)
    with pytest.raises(ValueError, match="init_pigan"):
        tr.evaluate()
    tr.init_pigan()
    before = tr.evaluate()
    assert before["total_samples"] == N
    assert before["pigan_evaluation"]["parameter_prediction"]["r2"] < 0.7    # a fresh G
    tr.train(mode="full", forward_epochs=2, gan_epochs=2)
    after = tr.evaluate()
    assert after["forward_network_evaluation"]["spectrum_prediction"]["mse"] < before[
        "forward_network_evaluation"]["spectrum_prediction"]["mse"]
    boxed = tr.evaluate(violation_window=(-1.0, 1.0))
    assert boxed["structural_prediction_evaluation"]["param_range_violation_rate"] == 0.0
    assert after == tr.evaluate()                            # the default noise is seeded
