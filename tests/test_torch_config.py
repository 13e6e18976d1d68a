"""The port's config equals the JAX package's, field for field."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pigan_thz_torch
from pigan_thz_torch import config as tcfg
from pigan_thz_tpu import config as jcfg

torch.set_num_threads(1)


def test_defaults_equal_field_for_field():
    assert tcfg._to_dict(tcfg.default_config()) == jcfg._to_dict(jcfg.default_config())


def test_dataclass_names_and_fields_match():
    for name in ("DataConfig", "GeneratorConfig", "DiscriminatorConfig",
                 "ForwardModelConfig", "LossWeights", "ConstraintConfig",
                 "OptimizerConfig", "TrainConfig", "MeshConfig", "EvalTargets",
                 "PiGanConfig"):
        t_fields = [(f.name, f.type) for f in dataclasses.fields(getattr(tcfg, name))]
        j_fields = [(f.name, f.type) for f in dataclasses.fields(getattr(jcfg, name))]
        assert t_fields == j_fields, name
    assert tcfg.METRIC_NAMES == jcfg.METRIC_NAMES
    assert tcfg.PARAM_NAMES == jcfg.PARAM_NAMES


def test_package_exports():
    assert pigan_thz_torch.default_config is tcfg.default_config
    assert pigan_thz_torch.apply_overrides is tcfg.apply_overrides
    assert pigan_thz_torch.PiGanConfig is tcfg.PiGanConfig


@pytest.mark.parametrize("data", [
    tcfg.DataConfig(),
    tcfg.DataConfig(spectrum_dim=64, freq_min=0.2, freq_max=4.0),
])
def test_frequencies_match_jax(data):
    got = data.frequencies
    want = np.asarray(jcfg.DataConfig(**dataclasses.asdict(data)).frequencies)
    assert got.dtype == torch.float32 and got.shape == (data.spectrum_dim,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert want.dtype == jnp.float32


@pytest.mark.parametrize("overrides", [
    ["train.batch_size=128", "data.noise_level=0.05"],
    ["generator.hidden_dims=1024,512", "train.detach_forward=false"],
    ["forward_model.hidden_dims=", "loss.window=2.5", "workdir=elsewhere"],
])
def test_apply_overrides_matches_jax(overrides):
    got = tcfg.apply_overrides(tcfg.default_config(), overrides)
    want = jcfg.apply_overrides(jcfg.default_config(), overrides)
    assert tcfg._to_dict(got) == jcfg._to_dict(want)


def test_unknown_override_raises():
    with pytest.raises(KeyError):
        tcfg.apply_overrides(tcfg.default_config(), ["train.nope=1"])


def test_yaml_round_trip_across_packages(tmp_path):
    cfg = tcfg.apply_overrides(
        tcfg.default_config(), ["train.num_epochs=7", "generator.norm=layer"]
    )
    path = str(tmp_path / "cfg.yaml")
    tcfg.to_yaml(cfg, path)
    assert tcfg.from_yaml(path) == cfg
    assert jcfg._to_dict(jcfg.from_yaml(path)) == tcfg._to_dict(cfg)
