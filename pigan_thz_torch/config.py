"""Configuration for the PyTorch / CUDA port of PI-GAN-THz.

The same frozen dataclasses as ``pigan_thz_tpu/config.py``, field for field,
so a config (or a saved ``model_config.json`` / YAML file) means the same
run in both packages.  The only framework-specific piece is
``DataConfig.frequencies``, a float32 ``torch.linspace`` here.

Reference parity notes (file:line cite the reference repo):
- dims: SPECTRUM_DIM=250, 4 params, 8 metrics  (config/config.py:37-54)
- loss weights LAMBDA_*                        (config/config.py:79-88)
- optimizer settings                            (config/config.py:57-73)
- param ranges hardcoded (2.2, 2.8) per param  (core/utils/data_loader.py:127-129)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import torch

# ---------------------------------------------------------------------------
# Dimensions and data
# ---------------------------------------------------------------------------

METRIC_NAMES: tuple[str, ...] = ("f1", "f2", "Q1", "FoM1", "S1", "Q2", "FoM2", "S2")
PARAM_NAMES: tuple[str, ...] = ("r1", "r2", "w", "g")


@dataclass(frozen=True)
class DataConfig:
    """Mirrors config/config.py:37-54 and data_loader.py:124-137."""

    spectrum_dim: int = 250
    param_dim: int = 4
    metrics_dim: int = 8
    freq_min: float = 0.5   # THz  (data_loader.py:124)
    freq_max: float = 3.0
    # Hardcoded physical parameter ranges (data_loader.py:127-129), microns.
    param_min: float = 2.2
    param_max: float = 2.8
    # Synthetic-set defaults (the reference dataset has 1000 rows,
    # logs/PIGAN_train_20250711-215844/PIGAN_train.log:6).
    num_samples: int = 1000
    noise_level: float = 0.1
    seed: int = 42

    @property
    def frequencies(self) -> torch.Tensor:
        """(spectrum_dim,) float32 frequency grid in THz, on the CPU."""
        return torch.linspace(
            self.freq_min, self.freq_max, self.spectrum_dim, dtype=torch.float32
        )


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GeneratorConfig:
    """Baseline MLP generator (core/models/generator.py:17-26)."""

    name: str = "mlp"                    # registry key: mlp|conv_attn|residual
    hidden_dims: tuple[int, ...] = (512, 256)
    norm: str = "batch"                  # "batch" (reference) or "layer"
    use_attention: bool = True           # conv_attn variant only
    num_residual_blocks: int = 3         # residual variant only
    dropout_rate: float = 0.2


@dataclass(frozen=True)
class DiscriminatorConfig:
    """Baseline MLP discriminator (core/models/discriminator.py:21-28)."""

    name: str = "mlp"                    # mlp|dual_encoder|conv|multi_scale
    hidden_dims: tuple[int, ...] = (512, 256)
    leaky_slope: float = 0.2
    use_spectral_norm: bool = False      # enhanced_discriminator.py:63-69
    dropout_rate: float = 0.3


@dataclass(frozen=True)
class ForwardModelConfig:
    """Baseline forward surrogate (core/models/forward_model.py:28-60)."""

    name: str = "mlp"                    # mlp|branched|physics|uncertainty
    hidden_dims: tuple[int, ...] = (256, 512, 1024, 512, 256)
    dropout_rate: float = 0.2            # MC-dropout (forward_model.py:33)
    leaky_slope: float = 0.2


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LossWeights:
    """Generator-loss lambdas (config/config.py:79-88).

    Note the reference double-counts the spectrum reconstruction term:
    ``LAMBDA_RECON * recon + LAMBDA_PHYSICS_SPECTRUM * recon``
    (core/train/train_pigan.py:174-177).  We keep both knobs for parity.
    """

    recon: float = 100.0
    physics_spectrum: float = 10.0
    physics_metrics: float = 1.0
    maxwell: float = 1.0
    lc: float = 1.0
    param_range: float = 0.1
    bnn_kl: float = 0.0
    adversarial: float = 1.0
    # Extended weights used by the unified/optimized trainers
    # (config/training_optimization.py:121-137).
    forward_consistency: float = 5.0
    constraint: float = 3.0
    stability: float = 1.0
    cycle: float = 1.0
    # physics WINDOW loss (unified_trainer.py:240-256; the overlay's
    # `physics_constraint_loss`, distinct from the constraint trainer's
    # `physics_constraint_weight`).  0 = off outside the optimized preset.
    window: float = 0.0


@dataclass(frozen=True)
class ConstraintConfig:
    """Constraint-loss knobs (training_optimization.py:78-98 and
    unified_constraint_trainer.py:295-347)."""

    range_penalty_weight: float = 5.0
    boundary_smoothness: float = 0.1
    physics_constraint_weight: float = 3.0
    hard_constraint_weight: float = 10.0
    boundary_penalty_weight: float = 0.1
    smoothness_penalty: float = 0.05


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 2e-4
    b1: float = 0.5
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    schedule: str = "cosine"   # cosine|step|linear|constant|warmup_cosine
    schedule_alpha: float = 0.01   # cosine floor fraction (train_pigan.py:61)
    step_decay_rate: float = 0.5   # StepLR gamma (train_pigan.py:62)
    step_decay_every_frac: float = 0.25  # StepLR step_size = epochs/4


@dataclass(frozen=True)
class TrainConfig:
    """Mirrors config/config.py:57-73 plus trainer-specific knobs."""

    seed: int = 42
    batch_size: int = 64
    num_epochs: int = 500
    fwd_pretrain_epochs: int = 500
    fwd_pretrain_lr: float = 1e-3
    lr_g: float = 2e-4
    lr_d: float = 2e-4
    log_interval: int = 10
    save_interval: int = 50
    label_smooth_real: float = 0.9   # train_pigan.py:127
    label_smooth_fake: float = 0.1   # train_pigan.py:134
    grad_clip: float = 1.0
    # If True, reproduce the reference's `torch.no_grad()` around the frozen
    # forward model in the G step (train_pigan.py:156-157): the physics losses
    # then carry NO gradient into G.  If False, gradients flow *through* the
    # frozen F into G (the behaviour of unified_trainer.py:240-256), which is
    # the recommended mode.
    detach_forward: bool = True
    # The next three fields keep config files interchangeable with the JAX
    # package, which reads them; the port's training path does not exist
    # yet and the port reads none of them.
    # Numerics: parameters are always fp32; "bfloat16" runs matmuls in bf16.
    compute_dtype: str = "float32"
    # Adam moment (m/v) storage dtype.
    adam_state_dtype: str = "float32"
    # One scanned program per epoch (JAX package).
    scan_steps_per_epoch: bool = True


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout (data, model axes); kept for config parity."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = 1
    model_parallel: int = 1


@dataclass(frozen=True)
class EvalTargets:
    """Numeric targets (config/training_optimization.py:194-215)."""

    spectrum_r2: float = 0.9
    metrics_r2: float = 0.9
    parameter_r2: float = 0.85
    discriminator_accuracy: float = 0.85
    violation_rate: float = 0.05
    consistency_score: float = 0.95
    cycle_consistency: float = 0.005
    stability: float = 0.001
    plausibility: float = 0.9


@dataclass(frozen=True)
class PiGanConfig:
    """Top-level config — the single source of truth for a run."""

    data: DataConfig = field(default_factory=DataConfig)
    generator: GeneratorConfig = field(default_factory=GeneratorConfig)
    discriminator: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)
    forward_model: ForwardModelConfig = field(default_factory=ForwardModelConfig)
    loss: LossWeights = field(default_factory=LossWeights)
    constraint: ConstraintConfig = field(default_factory=ConstraintConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    targets: EvalTargets = field(default_factory=EvalTargets)
    # Artifact directories (config/config.py:30-33).
    workdir: str = "runs"

    def replace(self, **kw) -> "PiGanConfig":
        return dataclasses.replace(self, **kw)


def _set_nested(cfg: Any, dotted: str, value: str) -> Any:
    """Return a copy of `cfg` with `a.b.c=value` applied (string coerced)."""
    head, _, rest = dotted.partition(".")
    if not hasattr(cfg, head):
        raise KeyError(f"unknown config field: {head!r} in {type(cfg).__name__}")
    cur = getattr(cfg, head)
    if rest:
        new = _set_nested(cur, rest, value)
    else:
        if isinstance(cur, bool):
            new = value.lower() in ("1", "true", "yes", "on")
        elif isinstance(cur, int):
            new = int(value)
        elif isinstance(cur, float):
            new = float(value)
        elif isinstance(cur, tuple):
            # "" round-trips an EMPTY tuple (dict_to_overrides serializes
            # [] as ",".join([]) == "")
            new = tuple(int(v) for v in value.split(",") if v != "")
        else:
            new = value
    return dataclasses.replace(cfg, **{head: new})


def apply_overrides(cfg: PiGanConfig, overrides: Sequence[str]) -> PiGanConfig:
    """Apply ``key.path=value`` CLI overrides (replaces argparse-per-script)."""
    for item in overrides:
        key, _, value = item.partition("=")
        cfg = _set_nested(cfg, key.strip(), value.strip())
    return cfg


def default_config() -> PiGanConfig:
    return PiGanConfig()


def _to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: _to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, tuple):
        return list(cfg)
    return cfg


def _flatten(d: Mapping[str, Any], prefix: str = ""):
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _flatten(v, key + ".")
        else:
            yield key, v


def to_yaml(cfg: PiGanConfig, path: str) -> None:
    """Write the full config as YAML (the config.yaml the reference README
    promises but never ships, README.md:55)."""
    import yaml

    with open(path, "w") as fh:
        yaml.safe_dump(_to_dict(cfg), fh, sort_keys=False)


def dict_to_overrides(data: Mapping[str, Any]) -> list[str]:
    """Nested dict -> ``a.b.c=value`` override strings (one serialization
    shared by from_yaml and the CLI's saved-model-config overlay)."""
    overrides = []
    for key, value in _flatten(data):
        if isinstance(value, list):
            value = ",".join(str(v) for v in value)
        overrides.append(f"{key}={value}")
    return overrides


def from_yaml(path: str, base: PiGanConfig | None = None) -> PiGanConfig:
    """Load a YAML config (full or partial) over `base`/defaults.  Nested
    keys map to the dataclass tree; unknown keys raise."""
    import yaml

    with open(path) as fh:
        data = yaml.safe_load(fh) or {}
    cfg = base or default_config()
    return apply_overrides(cfg, dict_to_overrides(data))
