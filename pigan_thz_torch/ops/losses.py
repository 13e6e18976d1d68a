"""Loss library as pure functions on torch tensors.

The port of ``pigan_thz_tpu/ops/losses.py``, function for function (cites
under the reference repo):
- core/utils/loss.py:8-147 — BCE, MSE, Maxwell smoothness, LC
  approximation, parameter range, the BNN-KL placeholder;
- core/train/unified_trainer.py:219-267 — constraint, physics-window and
  stability losses;
- core/train/unified_constraint_trainer.py:295-347 — the enhanced
  constraint loss with its violation rate, and :869-876 — cycle
  consistency;
- core/train/emergency_trainer.py:131 — the MSE + L1 intensive forward loss.

All functions are stateless and shape-polymorphic, and differentiable with
autograd where the JAX package's are with ``jax.grad`` (the violation rate
and the validity term are detached, as they are stop-gradients there).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# ---------------------------------------------------------------------------
# Core GAN losses
# ---------------------------------------------------------------------------


def bce(pred_prob: torch.Tensor, target: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Binary cross entropy on probabilities (loss.py:8-17)."""
    p = pred_prob.clamp(eps, 1.0 - eps)
    return -torch.mean(target * torch.log(p) + (1.0 - target) * torch.log1p(-p))


def bce_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE on logits; equal to sigmoid + BCE."""
    return torch.mean(
        logits.clamp(min=0.0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
    )


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target).abs())


def gaussian_nll(
    mean: torch.Tensor, var: torch.Tensor, target: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Heteroscedastic Gaussian negative log-likelihood, constant dropped:
    0.5 * mean(log var + (target - mean)^2 / var)."""
    v = var + eps
    return 0.5 * torch.mean(torch.log(v) + (target - mean) ** 2 / v)


# ---------------------------------------------------------------------------
# Physics-informed losses
# ---------------------------------------------------------------------------


def maxwell_smoothness_loss(spectrum: torch.Tensor) -> torch.Tensor:
    """Mean squared second finite difference of the spectrum (loss.py:29-64);
    0 for fewer than 3 points."""
    if spectrum.shape[-1] < 3:
        return spectrum.new_zeros(())
    d1 = spectrum[..., 1:] - spectrum[..., :-1]
    d2 = d1[..., 1:] - d1[..., :-1]
    return torch.mean(d2**2)


def lc_approx_loss(
    f1_pred_norm: torch.Tensor, f2_pred_norm: torch.Tensor, params_norm: torch.Tensor
) -> torch.Tensor:
    """LC-circuit linear surrogate: f1 ≈ 0.4·r1 + 0.6·w, f2 ≈ 0.3·r2 + 0.7·g
    on normalised values (loss.py:67-101)."""
    r1, r2, w, g = (params_norm[:, i] for i in range(4))
    th_f1 = 0.4 * r1 + 0.6 * w
    th_f2 = 0.3 * r2 + 0.7 * g
    return mse(f1_pred_norm.reshape(-1), th_f1) + mse(f2_pred_norm.reshape(-1), th_f2)


def param_range_loss(
    params_norm: torch.Tensor, lo: float = 0.0, hi: float = 1.0
) -> torch.Tensor:
    """Quadratic clamp penalty outside [lo, hi] (loss.py:104-127); the
    reference applies it to the generator's tanh output against [0, 1]."""
    below = (lo - params_norm).clamp(min=0.0) ** 2
    above = (params_norm - hi).clamp(min=0.0) ** 2
    return torch.mean(below + above)


def bnn_kl_loss() -> torch.Tensor:
    """Placeholder: MC-dropout BNN needs no explicit KL (loss.py:129-147)."""
    return torch.zeros(())


# ---------------------------------------------------------------------------
# Trainer-level losses (unified / constraint / emergency trainers)
# ---------------------------------------------------------------------------


def constraint_loss(
    params_norm: torch.Tensor,
    range_penalty_weight: float = 5.0,
    boundary_smoothness: float = 0.1,
) -> torch.Tensor:
    """ReLU range violation + exponential boundary penalty
    (unified_trainer.py:219-238), on [0, 1]-normalised params."""
    violation = torch.sum(torch.relu(params_norm - 1.0) + torch.relu(-params_norm))
    boundary = torch.sum(
        torch.exp(-10.0 * params_norm) + torch.exp(-10.0 * (1.0 - params_norm))
    )
    return range_penalty_weight * violation + boundary_smoothness * boundary


class EnhancedConstraint(NamedTuple):
    loss: torch.Tensor
    violation_rate: torch.Tensor


def enhanced_constraint_loss(
    params_norm: torch.Tensor,
    spectrum_from_forward: torch.Tensor,
    hard_weight: float = 10.0,
    boundary_weight: float = 0.1,
    smooth_weight: float = 0.05,
    physics_weight: float = 3.0,
) -> EnhancedConstraint:
    """Hard range² + exp(-20·boundary distance) + |Δ params| smoothness +
    forward-model NaN/Inf validity (unified_constraint_trainer.py:295-347),
    with the per-batch violation rate (:344-347)."""
    b = params_norm.shape[0]
    out_of_range = torch.clamp(
        torch.maximum(params_norm - 1.0, -params_norm), min=0.0
    )
    hard = torch.sum(out_of_range**2) / b
    boundary_dist = torch.minimum(params_norm, 1.0 - params_norm)
    # the exponent is clamped, as in the JAX package, against overflow far
    # outside [0, 1]
    boundary = torch.sum(torch.exp((-20.0 * boundary_dist).clamp(max=25.0))) / b
    smooth = torch.mean(torch.diff(params_norm, dim=1).abs())
    invalid = torch.isnan(spectrum_from_forward) | torch.isinf(spectrum_from_forward)
    validity = (torch.sum(invalid.to(torch.float32)) / b).detach()
    loss = (
        hard_weight * hard
        + boundary_weight * boundary
        + smooth_weight * smooth
        + physics_weight * validity
    )
    violations = torch.sum((params_norm < 0.0) | (params_norm > 1.0), dim=1)
    rate = torch.mean((violations > 0).to(torch.float32))
    return EnhancedConstraint(loss=loss, violation_rate=rate.detach())


def physics_window_loss(
    recon_spectrum: torch.Tensor,
    real_spectrum: torch.Tensor,
    pred_metrics: torch.Tensor,
    consistency_weight: float = 5.0,
    window_weight: float = 3.0,
    f_lo: float = 0.5,
    f_hi: float = 3.0,
) -> torch.Tensor:
    """Forward-consistency MSE + resonance-frequency window penalty on the
    first predicted metric f1 (unified_trainer.py:240-256)."""
    consistency = mse(recon_spectrum, real_spectrum)
    f1 = pred_metrics[:, 0]
    window = torch.sum(torch.relu(f1 - f_hi) + torch.relu(f_lo - f1))
    return consistency_weight * consistency + window_weight * window


def stability_loss(pred_params: torch.Tensor, pred_params_noisy: torch.Tensor) -> torch.Tensor:
    """Re-prediction drift under input noise (unified_trainer.py:258-267)."""
    return mse(pred_params, pred_params_noisy)


def cycle_consistency_loss(
    params_first: torch.Tensor, params_cycled: torch.Tensor
) -> torch.Tensor:
    """G(F(G(s))) ≈ G(s) (unified_constraint_trainer.py:869-876)."""
    return mse(params_cycled, params_first)


def intensive_forward_loss(
    pred_spectrum: torch.Tensor,
    real_spectrum: torch.Tensor,
    pred_metrics: torch.Tensor,
    real_metrics: torch.Tensor,
    l1_weight: float = 0.5,
) -> torch.Tensor:
    """MSE + 0.5·L1 recovery loss for collapsed forward models
    (emergency_trainer.py:131, :162-260)."""
    return (
        mse(pred_spectrum, real_spectrum)
        + mse(pred_metrics, real_metrics)
        + l1_weight * (mae(pred_spectrum, real_spectrum) + mae(pred_metrics, real_metrics))
    )


def violation_rate(
    params_norm: torch.Tensor, lo: float = 0.0, hi: float = 1.0
) -> torch.Tensor:
    """Fraction of samples with any parameter outside [lo, hi]
    (unified_evaluator.py:380)."""
    bad = torch.any((params_norm < lo) | (params_norm > hi), dim=-1)
    return torch.mean(bad.to(torch.float32))
