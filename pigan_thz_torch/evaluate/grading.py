"""Shared per-suite grading thresholds: the port's own copy of
``pigan_thz_tpu/evaluate/grading.py``, value for value (pure Python).

One source of truth for the EXCELLENT/GOOD/MODERATE/POOR cutoffs used by the
console rubrics (evaluate/rubrics.py), the per-suite figure rating panels
(utils/eval_viz.py), and anything else that grades suite results — so a
threshold tweak can never desynchronize the console output from the figures.

Thresholds are the reference's, copied exactly from its per-suite CLI
wrappers (evaluate_fwd_model.py:74-81, evaluate_pigan.py:76-95,
evaluate_structural_prediction.py:74-106, evaluate_model_validation.py:75-141).
The summary report (evaluate/report.py) intentionally does NOT use these: the
reference's unified_evaluator.py:582-701 report applies its own, different
two-tier rubric, and that difference is preserved for parity.
"""

from __future__ import annotations

GRADES = ("EXCELLENT", "GOOD", "MODERATE", "POOR")

# (excellent, good, moderate) bounds for the scalar validation metrics;
# value < bound for error-like metrics, value > bound with reverse=True
# for score-like ones.
VALIDATION_BOUNDS = {
    "cycle": (0.001, 0.01, 0.05),
    "stability": (0.001, 0.01, 0.05),
    "plausibility": (0.9, 0.8, 0.6),
}


def grade_forward(spectrum_r2: float, metrics_r2: float) -> str:
    if spectrum_r2 > 0.9 and metrics_r2 > 0.9:
        return "EXCELLENT"
    if spectrum_r2 > 0.8 and metrics_r2 > 0.8:
        return "GOOD"
    if spectrum_r2 > 0.6 and metrics_r2 > 0.6:
        return "MODERATE"
    return "POOR"


def grade_pigan(param_r2: float, d_accuracy: float) -> str:
    if param_r2 > 0.8 and d_accuracy > 0.8:
        return "EXCELLENT"
    if param_r2 > 0.6 and d_accuracy > 0.7:
        return "GOOD"
    if param_r2 > 0.4 and d_accuracy > 0.6:
        return "MODERATE"
    return "POOR"


def grade_structural(
    violation_rate: float, consistency: float, recon_error: float
) -> str:
    if violation_rate < 0.05 and consistency > 0.9 and recon_error < 0.01:
        return "EXCELLENT"
    if violation_rate < 0.1 and consistency > 0.8 and recon_error < 0.05:
        return "GOOD"
    if violation_rate < 0.2 and consistency > 0.6 and recon_error < 0.1:
        return "MODERATE"
    return "POOR"


def grade_scalar(value: float, bounds, reverse: bool = False) -> str:
    """Grade one validation metric against (excellent, good, moderate)
    bounds; error-like metrics grade by `value < bound`, score-like ones
    (reverse=True) by `value > bound`."""
    for grade, bound in zip(GRADES, bounds):
        if (value > bound) if reverse else (value < bound):
            return grade
    return "POOR"


def d_equilibrium(param_r2: float, d_accuracy: float) -> bool:
    """The high-R2 + chance-level-D state the reference rubric penalizes but
    its own best runs exhibit ("balance 51%", constraint_optimizer.py:37):
    at GAN equilibrium the discriminator SHOULD sit near 0.5."""
    return param_r2 > 0.8 and 0.45 <= d_accuracy <= 0.6
