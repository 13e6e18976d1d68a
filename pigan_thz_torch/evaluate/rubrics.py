"""Per-suite console rating rubrics: the port's own copy of
``pigan_thz_tpu/evaluate/rubrics.py``, with the same text.

Parity with the reference's four evaluation CLI wrappers, each of which
prints a graded, human-readable assessment after its suite
(evaluate_fwd_model.py:74-81, evaluate_pigan.py:76-95,
evaluate_structural_prediction.py:74-106, evaluate_model_validation.py:75-141).
Thresholds are copied exactly; output is ASCII ([OK]/[!]/[X] in place of the
emoji) so logs stay grep-able.
"""

from __future__ import annotations

from typing import Any, Dict, List

from .grading import (
    VALIDATION_BOUNDS,
    d_equilibrium,
    grade_forward,
    grade_pigan,
    grade_scalar,
    grade_structural,
)

OK, WARN, BAD = "[OK]", "[!]", "[X]"
_MARK = {"EXCELLENT": OK, "GOOD": OK, "MODERATE": WARN, "POOR": BAD}


def _fmt_metrics(d: Dict[str, Any], keys) -> List[str]:
    return [f"  - {k}: {d[k]:.6f}" for k in keys if k in d]


def rubric_forward(results: Dict[str, Any]) -> str:
    """evaluate_fwd_model.py:50-81."""
    spec = results["spectrum_prediction"]
    met = results["metrics_prediction"]
    lines = ["Forward Network Evaluation", "-" * 50]
    lines.append("Spectrum Prediction:")
    lines += _fmt_metrics(spec, ("r2", "mse", "mae", "rmse", "pearson_r"))
    lines.append("Metrics Prediction:")
    lines += _fmt_metrics(met, ("r2", "mse", "mae", "rmse", "pearson_r"))
    lines.append("")
    g = grade_forward(spec["r2"], met["r2"])
    tail = (" and needs improvement." if g == "POOR"
            else "." if g == "MODERATE" else "!")
    lines.append(f"{_MARK[g]} Forward model shows {g} performance{tail}")
    return "\n".join(lines)


def rubric_pigan(results: Dict[str, Any]) -> str:
    """evaluate_pigan.py:55-95."""
    par = results["parameter_prediction"]
    dis = results["discriminator_performance"]
    lines = ["PI-GAN Evaluation", "-" * 50]
    lines.append("Generator - Parameter Prediction:")
    lines += _fmt_metrics(par, ("r2", "mae", "rmse", "pearson_r", "mape"))
    lines.append("Discriminator Performance:")
    lines += _fmt_metrics(
        dis,
        ("real_accuracy", "fake_accuracy", "overall_accuracy",
         "real_score_mean", "fake_score_mean"),
    )
    lines.append("")
    r2, acc = par["r2"], dis["overall_accuracy"]
    g = grade_pigan(r2, acc)
    detail = {
        "EXCELLENT": [f"{OK} PI-GAN shows EXCELLENT performance!",
                      "  - Generator accurately predicts structural parameters",
                      "  - Discriminator effectively distinguishes real vs fake"],
        "GOOD": [f"{OK} PI-GAN shows GOOD performance!",
                 "  - Generator performs well with room for improvement",
                 "  - Discriminator shows decent discrimination capability"],
        "MODERATE": [f"{WARN} PI-GAN shows MODERATE performance.",
                     "  - Generator needs improvement in parameter prediction",
                     "  - Discriminator shows acceptable performance"],
        "POOR": [f"{BAD} PI-GAN shows POOR performance and needs improvement.",
                 "  - Generator fails to accurately predict parameters",
                 "  - Discriminator shows poor discrimination capability"],
    }
    lines += detail[g]
    if d_equilibrium(r2, acc):
        lines += ["", f"{OK} Note: D accuracy near 0.5 with high generator R2 "
                      "indicates a HEALTHY equilibrium (the reference's own "
                      "best checkpoint records D balance 51%)."]
    return "\n".join(lines)


def rubric_structural(results: Dict[str, Any]) -> str:
    """evaluate_structural_prediction.py:60-106."""
    v = results["param_range_violation_rate"]
    c = results["consistency_score_mean"]
    e = results["reconstruction_error_mean"]
    lines = ["Structural Prediction Evaluation", "-" * 50]
    lines.append(f"  - Violation Rate: {v:.4f}")
    lines.append(f"  - Avg Violations/Sample: {results['avg_param_violations']:.4f}")
    lines.append(f"  - Reconstruction Error: {e:.6f} (+/- {results['reconstruction_error_std']:.6f})")
    lines.append(f"  - Consistency Score: {c:.4f} (+/- {results['consistency_score_std']:.4f})")
    lines.append("")
    g = grade_structural(v, c, e)
    tail = (" and needs improvement." if g == "POOR"
            else "." if g == "MODERATE" else "!")
    lines.append(f"{_MARK[g]} Structural prediction shows {g} reliability{tail}")
    issues = []
    if v > 0.1:
        issues.append("reduce parameter-range violations (constraint training)")
    if c < 0.7:
        issues.append("improve prediction consistency (cycle / recon loss)")
    if e > 0.05:
        issues.append("improve reconstruction accuracy (forward-model quality)")
    if issues:
        lines.append("Suggested focus:")
        lines += [f"  - {i}" for i in issues]
    return "\n".join(lines)


def rubric_validation(results: Dict[str, Any]) -> str:
    """evaluate_model_validation.py:70-141."""
    cy = results["cycle_consistency_error_mean"]
    st = results["prediction_stability_mean"]
    pl = results["physical_plausibility_mean"]
    lines = ["Model Validation Evaluation", "-" * 50]
    lines.append(f"  - Cycle Consistency Error: {cy:.6f}")
    lines.append(f"  - Prediction Stability: {st:.6f}")
    lines.append(f"  - Physical Plausibility: {pl:.4f}")
    lines.append("")

    def grade(val, bounds, reverse=False):
        g = grade_scalar(val, bounds, reverse=reverse)
        return g, _MARK[g]

    cycles = grade(cy, VALIDATION_BOUNDS["cycle"])
    stabs = grade(st, VALIDATION_BOUNDS["stability"])
    plaus = grade(pl, VALIDATION_BOUNDS["plausibility"], reverse=True)
    lines.append(f"{cycles[1]} {cycles[0]} cycle consistency")
    lines.append(f"{stabs[1]} {stabs[0]} stability")
    lines.append(f"{plaus[1]} {plaus[0]} physical plausibility")

    excellent = sum(g[0] == "EXCELLENT" for g in (cycles, stabs, plaus))
    good_or_better = sum(g[0] in ("EXCELLENT", "GOOD") for g in (cycles, stabs, plaus))
    lines.append("")
    if excellent == 3:
        lines.append(f"{OK} EXCELLENT - Model passes all validation tests with high scores!")
    elif good_or_better >= 2:
        lines.append(f"{OK} GOOD - Model passes most validation tests!")
    elif good_or_better >= 1:
        lines.append(f"{WARN} MODERATE - Model shows mixed validation results.")
    else:
        lines.append(f"{BAD} POOR - Model fails multiple validation tests.")
    return "\n".join(lines)


SUITE_RUBRICS = {
    "forward": rubric_forward,
    "pigan": rubric_pigan,
    "structural": rubric_structural,
    "validation": rubric_validation,
}
