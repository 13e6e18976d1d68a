"""Optimization-config overlay: the reference's second config tier.  The
port of ``pigan_thz_tpu/config_presets.py``, value for value.

config/training_optimization.py:1-268 layers a 10-section nested dict over
the base constants (forward-model / generator / discriminator optimization,
constraints, training strategy, loss weights, architecture, optimizers,
evaluation targets, monitoring) exported via ``get_optimization_config()``.

This module reproduces that overlay as data (same sections, same knobs, same
recorded values) and provides translators into the typed config
(``apply_optimization_config``) and the step's settings
(``step_settings_from_optimization``), so OptimizedTrainer-style runs
(optimized_trainer.py:30-550: "driven entirely by get_optimization_config()")
are expressed as: preset dict -> PiGanConfig / StepSettings -> Trainer.

The optimized overlay names the residual generator and the dual-encoder
discriminator, which the port's registry does not build yet; with
``generator.name=mlp`` and ``discriminator.name=mlp`` set after it, the
baseline trio trains under its loss mix (constraint, window and stability
on, gradients through F).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from .config import PiGanConfig

# ---------------------------------------------------------------------------
# The overlay (training_optimization.py:15-226, values preserved)
# ---------------------------------------------------------------------------

FORWARD_MODEL_OPTIMIZATION: Dict[str, Any] = {
    "hidden_dims": [128, 256, 512, 1024, 512, 256],
    "dropout_rate": 0.3,
    "batch_norm": True,
    "activation": "leaky_relu",
    "spectrum_loss_weight": 1.0,
    "metrics_loss_weight": 0.8,
    "smoothness_loss_weight": 0.1,
    "physics_loss_weight": 0.2,
    "learning_rate": 1e-4,
    "epochs": 200,
    "early_stopping_patience": 20,
    "lr_scheduler": "cosine",
}

GENERATOR_OPTIMIZATION: Dict[str, Any] = {
    "hidden_dims": [512, 1024, 2048, 1024, 512, 256],
    "residual_blocks": 3,
    "attention_layers": 2,
    "dropout_rate": 0.2,
    "adversarial_loss_weight": 1.0,
    "reconstruction_loss_weight": 10.0,
    "perceptual_loss_weight": 5.0,
    "constraint_loss_weight": 2.0,
    "learning_rate": 2e-4,
    "beta1": 0.5,
    "beta2": 0.999,
    "gradient_clip": 1.0,
}

DISCRIMINATOR_OPTIMIZATION: Dict[str, Any] = {
    "hidden_dims": [256, 512, 1024, 512, 256, 128],
    "spectral_norm": True,
    "dropout_rate": 0.3,
    "leaky_relu_slope": 0.2,
    "learning_rate": 1e-4,
    "label_smoothing": 0.1,
    "instance_noise": 0.05,
    "loss_type": "wgan_gp",
    "gradient_penalty_weight": 10.0,
}

CONSTRAINT_OPTIMIZATION: Dict[str, Any] = {
    "parameter_clipping": True,
    "parameter_ranges": {
        "r1": (2.2, 2.8), "r2": (2.2, 2.8), "w": (2.2, 2.8), "g": (2.2, 2.8),
    },
    "range_penalty_weight": 5.0,
    "boundary_smoothness": 0.1,
    "constraint_activation": "sigmoid",
    "physics_constraint_weight": 3.0,
    "resonance_constraint": True,
    "causality_constraint": True,
}

TRAINING_OPTIMIZATION: Dict[str, Any] = {
    "data_augmentation": {
        "noise_level": 0.05,
        "frequency_shift": 0.02,
        "amplitude_scale": 0.1,
    },
    "progressive_training": True,
    "curriculum_learning": True,
    "mixed_precision": True,
    "evaluation_frequency": 10,
    "save_best_model": True,
    "validation_split": 0.2,
    "warmup_epochs": 10,
    "cosine_annealing": True,
    "weight_decay": 1e-4,
}

LOSS_WEIGHTS: Dict[str, float] = {
    "adversarial_loss": 1.0,
    "reconstruction_loss": 10.0,
    "forward_consistency_loss": 5.0,
    "parameter_constraint_loss": 3.0,
    "physics_constraint_loss": 2.0,
    "smoothness_loss": 1.0,
    "diversity_loss": 0.5,
    "sparsity_loss": 0.1,
    "stability_loss": 1.0,
}

MODEL_ARCHITECTURE: Dict[str, Any] = {
    "generator": {
        "base_channels": 64,
        "max_channels": 512,
        "num_residual_blocks": 6,
        "use_attention": True,
        "attention_heads": 8,
        "use_self_attention": True,
    },
    "discriminator": {
        "base_channels": 32,
        "max_channels": 256,
        "num_layers": 6,
        "use_spectral_norm": True,
        "use_gradient_penalty": True,
    },
    "forward_model": {
        "hidden_layers": [128, 256, 512, 1024, 512, 256, 128],
        "use_residual": True,
        "use_batch_norm": True,
        "use_dropout": True,
    },
}

OPTIMIZER_CONFIG: Dict[str, Any] = {
    "generator": {"type": "adam", "lr": 2e-4, "betas": (0.5, 0.999),
                  "weight_decay": 1e-4, "eps": 1e-8},
    "discriminator": {"type": "adam", "lr": 1e-4, "betas": (0.5, 0.999),
                      "weight_decay": 1e-4, "eps": 1e-8},
    "forward_model": {"type": "adam", "lr": 1e-4, "betas": (0.9, 0.999),
                      "weight_decay": 1e-4, "eps": 1e-8},
}

EVALUATION_TARGETS: Dict[str, Any] = {
    "forward_network": {"spectrum_r2_target": 0.9, "metrics_r2_target": 0.9},
    "pigan": {"parameter_r2_target": 0.85, "discriminator_accuracy_target": 0.85},
    "structural_prediction": {"violation_rate_target": 0.05,
                              "consistency_score_target": 0.95},
    "model_validation": {"cycle_consistency_target": 0.005,
                         "stability_target": 0.001,
                         "plausibility_target": 0.9},
}

MONITORING_CONFIG: Dict[str, Any] = {
    "tensorboard_logging": True,
    "wandb_logging": False,
    "checkpoint_frequency": 20,
    "plot_frequency": 50,
    "evaluation_frequency": 10,
    "early_stopping_patience": 30,
    "save_best_only": True,
}


def get_optimization_config() -> Dict[str, Any]:
    """Same shape as training_optimization.get_optimization_config (:232-245)."""
    return {
        "forward_model": FORWARD_MODEL_OPTIMIZATION,
        "generator": GENERATOR_OPTIMIZATION,
        "discriminator": DISCRIMINATOR_OPTIMIZATION,
        "constraints": CONSTRAINT_OPTIMIZATION,
        "training": TRAINING_OPTIMIZATION,
        "loss_weights": LOSS_WEIGHTS,
        "model_architecture": MODEL_ARCHITECTURE,
        "optimizer": OPTIMIZER_CONFIG,
        "evaluation_targets": EVALUATION_TARGETS,
        "monitoring": MONITORING_CONFIG,
    }


# ---------------------------------------------------------------------------
# Translators into the typed config / step settings
# ---------------------------------------------------------------------------


def apply_optimization_config(
    cfg: PiGanConfig, opt: Dict[str, Any] | None = None
) -> PiGanConfig:
    """Fold the overlay into the typed config (the OptimizedTrainer pattern:
    optimized_trainer.py consumes exactly these knobs)."""
    opt = opt or get_optimization_config()
    lw = opt["loss_weights"]
    cons = opt["constraints"]
    loss = dataclasses.replace(
        cfg.loss,
        adversarial=lw["adversarial_loss"],
        recon=lw["reconstruction_loss"],
        forward_consistency=lw["forward_consistency_loss"],
        constraint=lw["parameter_constraint_loss"],
        maxwell=lw["smoothness_loss"],
        stability=lw["stability_loss"],
        window=lw["physics_constraint_loss"],
    )
    constraint = dataclasses.replace(
        cfg.constraint,
        range_penalty_weight=cons["range_penalty_weight"],
        boundary_smoothness=cons["boundary_smoothness"],
        physics_constraint_weight=cons["physics_constraint_weight"],
    )
    gen = dataclasses.replace(
        cfg.generator,
        name="residual",
        num_residual_blocks=opt["generator"]["residual_blocks"],
        dropout_rate=opt["generator"]["dropout_rate"],
    )
    disc = dataclasses.replace(
        cfg.discriminator,
        name="dual_encoder",
        use_spectral_norm=opt["discriminator"]["spectral_norm"],
        leaky_slope=opt["discriminator"]["leaky_relu_slope"],
        dropout_rate=opt["discriminator"]["dropout_rate"],
    )
    train = dataclasses.replace(
        cfg.train,
        lr_g=opt["optimizer"]["generator"]["lr"],
        lr_d=opt["optimizer"]["discriminator"]["lr"],
        fwd_pretrain_lr=opt["optimizer"]["forward_model"]["lr"],
        fwd_pretrain_epochs=opt["forward_model"]["epochs"],
        grad_clip=opt["generator"]["gradient_clip"],
        label_smooth_real=1.0 - opt["discriminator"]["label_smoothing"],
        label_smooth_fake=opt["discriminator"]["label_smoothing"],
        detach_forward=False,
    )
    return dataclasses.replace(
        cfg, loss=loss, constraint=constraint, generator=gen,
        discriminator=disc, train=train,
    )


def step_settings_from_optimized_config(cfg: PiGanConfig):
    """OptimizedTrainer's GAN-phase loss mix read from a CONFIG that
    `apply_optimization_config` produced - unlike
    `step_settings_from_optimization` (static overlay dict), every knob
    here respects later --set overrides.  Bit-identical to the static
    function on the untouched overlay (tested)."""
    from .train.steps import StepSettings

    return StepSettings(
        adv_w=cfg.loss.adversarial,
        recon_w=cfg.loss.recon,
        physics_spec_w=cfg.loss.forward_consistency,
        constraint_w=cfg.loss.constraint,
        window_w=cfg.loss.window,
        maxwell_w=cfg.loss.maxwell,
        stability_w=cfg.loss.stability,
        detach_forward=cfg.train.detach_forward,
        label_real=cfg.train.label_smooth_real,
        label_fake=cfg.train.label_smooth_fake,
    )


def step_settings_from_optimization(opt: Dict[str, Any] | None = None):
    """StepSettings for an OptimizedTrainer-style GAN phase
    (optimized_trainer.py:134-186: adds constraint/physics/stability losses)."""
    from .train.steps import StepSettings

    opt = opt or get_optimization_config()
    lw = opt["loss_weights"]
    return StepSettings(
        adv_w=lw["adversarial_loss"],
        recon_w=lw["reconstruction_loss"],
        physics_spec_w=lw["forward_consistency_loss"],
        constraint_w=lw["parameter_constraint_loss"],
        window_w=lw["physics_constraint_loss"],
        maxwell_w=lw["smoothness_loss"],
        stability_w=lw["stability_loss"],
        detach_forward=False,
        label_real=1.0 - opt["discriminator"]["label_smoothing"],
        label_fake=opt["discriminator"]["label_smoothing"],
    )


# ---------------------------------------------------------------------------
# Scaled-batch recipe (no reference counterpart)
# ---------------------------------------------------------------------------

# The JAX package's large-batch recipe: batch 512 at lr x2 with a 5% linear
# warmup into the standard cosine/step decay, physics gradients THROUGH the
# frozen F.  Its quality and throughput were measured on that package's
# hardware only; on the H100 they are not measured.
SCALED_BATCH_RECIPE: Dict[str, Any] = {
    "train.batch_size": 512,
    "train.lr_g": 4e-4,            # 2e-4 x (the measured-safe x2)
    "train.lr_d": 4e-4,
    "train.detach_forward": False,  # required: detach caps large batches ~0.7
}
SCALED_BATCH_SCHEDULE = "warmup_cosine"   # both optimizers


def apply_scaled_batch_config(cfg: PiGanConfig) -> PiGanConfig:
    """Overlay the scaled-batch recipe onto a config (CLI `--preset
    scaled`; `--set` overrides applied after still win).  The warmup
    schedule itself is a per-phase optimizer override - the CLI passes
    `schedule_g/d=SCALED_BATCH_SCHEDULE` into train_pigan."""
    from .config import apply_overrides

    return apply_overrides(
        cfg, [f"{k}={v}" for k, v in SCALED_BATCH_RECIPE.items()]
    )
