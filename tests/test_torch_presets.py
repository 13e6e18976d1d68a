"""``pigan_thz_torch/config_presets.py`` against the JAX package's module,
field by field, and the ``train --preset`` command on the CPU."""

import dataclasses
import json

import pytest
import torch

from pigan_thz_torch import config_presets as tp
from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.cli import main as cli_main
from pigan_thz_torch.ops import gan_train as gt
from pigan_thz_torch.train.trainer import Trainer
from pigan_thz_tpu import config_presets as jp
from pigan_thz_tpu import default_config as j_default_config

torch.set_num_threads(1)

SECTIONS = ["FORWARD_MODEL_OPTIMIZATION", "GENERATOR_OPTIMIZATION",
            "DISCRIMINATOR_OPTIMIZATION", "CONSTRAINT_OPTIMIZATION", "TRAINING_OPTIMIZATION",
            "LOSS_WEIGHTS", "MODEL_ARCHITECTURE", "OPTIMIZER_CONFIG", "EVALUATION_TARGETS",
            "MONITORING_CONFIG", "SCALED_BATCH_RECIPE"]


@pytest.mark.parametrize("name", SECTIONS)
def test_overlay_sections_equal_the_jax_module_s(name):
    assert getattr(tp, name) == getattr(jp, name)


def test_get_optimization_config_has_the_ten_sections():
    t, j = tp.get_optimization_config(), jp.get_optimization_config()
    assert list(t) == list(j) and len(t) == 10
    assert t == j
    assert tp.SCALED_BATCH_SCHEDULE == jp.SCALED_BATCH_SCHEDULE == "warmup_cosine"


@pytest.mark.parametrize("apply", ["apply_optimization_config", "apply_scaled_batch_config"])
def test_translated_configs_equal_field_by_field(apply):
    t = getattr(tp, apply)(t_default_config())
    j = getattr(jp, apply)(j_default_config())
    tj, jj = dataclasses.asdict(t), dataclasses.asdict(j)
    for section in jj:
        if not isinstance(jj[section], dict):
            assert tj[section] == jj[section], section
            continue
        for field, want in jj[section].items():
            if field in tj[section]:          # the port leaves out what is TPU-only
                assert tj[section][field] == want, (section, field)
    assert t != t_default_config()


def test_apply_takes_a_modified_overlay():
    opt = json.loads(json.dumps(tp.get_optimization_config()))
    opt["loss_weights"]["stability_loss"] = 0.25
    opt["discriminator"]["label_smoothing"] = 0.2
    t = tp.apply_optimization_config(t_default_config(), opt)
    j = jp.apply_optimization_config(j_default_config(), opt)
    assert t.loss.stability == j.loss.stability == 0.25
    assert (t.train.label_smooth_real, t.train.label_smooth_fake) == (
        j.train.label_smooth_real, j.train.label_smooth_fake) == (0.8, 0.2)


@pytest.mark.parametrize("which", ["static", "from_config", "from_config_after_set"])
def test_step_settings_equal_field_by_field(which):
    if which == "static":
        t, j = tp.step_settings_from_optimization(), jp.step_settings_from_optimization()
    else:
        tc = tp.apply_optimization_config(t_default_config())
        jc = jp.apply_optimization_config(j_default_config())
        if which == "from_config_after_set":
            from pigan_thz_torch.config import apply_overrides as t_over
            from pigan_thz_tpu.config import apply_overrides as j_over

            sets = ["loss.stability=0.3", "loss.constraint=1.5", "train.detach_forward=true"]
            tc, jc = t_over(tc, sets), j_over(jc, sets)
        t = tp.step_settings_from_optimized_config(tc)
        j = jp.step_settings_from_optimized_config(jc)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    if which != "from_config_after_set":
        assert dataclasses.asdict(t) == dataclasses.asdict(tp.step_settings_from_optimization())
        assert (t.stability_w, t.constraint_w, t.window_w, t.detach_forward) == (
            1.0, 3.0, 2.0, False)


def test_optimized_loss_mix_is_inside_the_kernel_s_envelope():
    """With the baseline trio named, the overlay's GAN phase (stability,
    constraint, window, through F) is what the GAN-training kernel takes."""
    from pigan_thz_torch.config import apply_overrides

    cfg = apply_overrides(tp.apply_optimization_config(t_default_config()),
                          ["generator.name=mlp", "discriminator.name=mlp"])
    settings = tp.step_settings_from_optimized_config(cfg)
    assert gt.supports_gan_kernel(cfg, settings) is None
    spec = gt.gan_train_spec(cfg, settings)
    assert spec.stability_w == 1.0 and spec.cycle_w == 0.0 and not spec.use_inoise
    # as the overlay stands it names models that the registry does not build yet
    with pytest.raises(NotImplementedError, match="residual"):
        Trainer(tp.apply_optimization_config(t_default_config()), device="cpu")


def _args(tmp_path, *extra):
    return ["train", "--device", "cpu", "--set", "data.num_samples=128", "--workdir",
            str(tmp_path), "--no-tensorboard", "--epochs", "1", "--forward-epochs", "1",
            *extra]


def test_train_command_preset_optimized_trains_the_baseline_trio(tmp_path, monkeypatch, capsys):
    seen = {}
    real = Trainer.train_pigan

    def spy(self, *a, **kw):
        seen["settings"], seen["cfg"] = kw["settings"], self.cfg
        return real(self, *a, **kw)

    monkeypatch.setattr(Trainer, "train_pigan", spy)
    rc = cli_main(_args(tmp_path, "--preset", "optimized", "--engine", "kernel",
                        "--set", "generator.name=mlp", "--set", "discriminator.name=mlp",
                        "--set", "train.batch_size=32", "--ema-decay", "0.9"))
    assert rc == 0
    s = seen["settings"]
    assert (s.stability_w, s.constraint_w, s.window_w, s.detach_forward, s.ema_decay) == (
        1.0, 3.0, 2.0, False, 0.9)
    assert seen["cfg"].train.lr_d == 1e-4 and seen["cfg"].train.label_smooth_real == 0.9
    assert "GAN-training kernel (its plain version)" in capsys.readouterr().out
    hist = json.loads((tmp_path / "saved_models" / "training_history.json").read_text())
    assert len(hist["pigan/constraint_loss"]) == 1
    # as typed, the overlay's models are refused by name
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 15"):
        cli_main(_args(tmp_path, "--preset", "optimized"))


def test_train_command_preset_scaled(tmp_path, monkeypatch):
    seen = {}
    real = Trainer.train_pigan

    def spy(self, *a, **kw):
        seen.update(kw, cfg=self.cfg)
        return real(self, *a, **kw)

    monkeypatch.setattr(Trainer, "train_pigan", spy)
    # 512 samples: one step an epoch at the recipe's batch, 2 epochs for the warmup
    assert cli_main(["train", "--device", "cpu", "--set", "data.num_samples=512", "--workdir",
                     str(tmp_path), "--no-tensorboard", "--epochs", "40",
                     "--forward-epochs", "1", "--preset", "scaled",
                     "--set", "train.batch_size=256"]) == 0
    assert seen["schedule_g"] == seen["schedule_d"] == "warmup_cosine"
    assert seen["cfg"].train.batch_size == 256          # --set after the preset wins
    assert seen["cfg"].train.lr_g == 4e-4 and seen["settings"].detach_forward is False
    with pytest.raises(SystemExit, match="conflicts with --preset scaled"):
        cli_main(_args(tmp_path, "--preset", "scaled", "--fixed-physics"))
