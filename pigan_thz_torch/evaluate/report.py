"""Text summary report with the reference's rating rubric
(unified_evaluator.py:582-701: per-suite EXCELLENT/GOOD/NEEDS-IMPROVEMENT
thresholds and the >=3-excellent overall rating).  The port's copy of
``pigan_thz_tpu/evaluate/report.py``: the same text, format specifiers
included, with the package's name in the header."""

from __future__ import annotations

import os
import time
from typing import Any, Dict


def generate_summary_report(
    results: Dict[str, Any],
    save_path: str | None = None,
    ceilings: Dict[str, float] | None = None,
    oracle: Dict[str, float] | None = None,
) -> str:
    """`ceilings`/`oracle` (evaluate/ceilings.py) add section 6: every
    reference target line printed as measured / target / achievable ceiling,
    with the clean-oracle scores — the reproducible version of the
    'targets are statistically unreachable' analysis."""
    lines = []
    bar = "=" * 80
    sub = "-" * 40
    lines += [bar, "PI-GAN UNIFIED EVALUATION REPORT (pigan_thz_torch)", bar]
    lines.append(f"Evaluation Date: {time.strftime('%Y-%m-%d %H:%M:%S')}")
    lines.append(f"Total Samples: {results.get('total_samples', '?')}")
    if "evaluation_time" in results:
        lines.append(f"Evaluation Time: {results['evaluation_time']:.2f}s")
    lines.append("")

    fwd = results["forward_network_evaluation"]
    spectrum_r2 = fwd["spectrum_prediction"]["r2"]
    metrics_r2 = fwd["metrics_prediction"]["r2"]
    lines += ["1. FORWARD NETWORK EVALUATION", sub]
    lines.append(f"Spectrum Prediction R2: {spectrum_r2:.4f}")
    lines.append(f"Metrics Prediction R2: {metrics_r2:.4f}")
    if spectrum_r2 > 0.9 and metrics_r2 > 0.9:
        lines.append("[OK] Forward network shows EXCELLENT performance")
    elif spectrum_r2 > 0.8 and metrics_r2 > 0.8:
        lines.append("[OK] Forward network shows GOOD performance")
    else:
        lines.append("[!] Forward network needs improvement")
    lines.append("")

    pig = results["pigan_evaluation"]
    param_r2 = pig["parameter_prediction"]["r2"]
    disc_acc = pig["discriminator_performance"]["overall_accuracy"]
    lines += ["2. PI-GAN EVALUATION", sub]
    lines.append(f"Parameter Prediction R2: {param_r2:.4f}")
    lines.append(f"Discriminator Accuracy: {disc_acc:.4f}")
    if param_r2 > 0.8 and disc_acc > 0.8:
        lines.append("[OK] PI-GAN shows EXCELLENT performance")
    elif param_r2 > 0.6 and disc_acc > 0.7:
        lines.append("[OK] PI-GAN shows GOOD performance")
    else:
        lines.append("[!] PI-GAN needs improvement")
    lines.append("")

    st = results["structural_prediction_evaluation"]
    violation_rate = st["param_range_violation_rate"]
    consistency = st["consistency_score_mean"]
    lines += ["3. STRUCTURAL PREDICTION EVALUATION", sub]
    lines.append(f"Parameter Violation Rate: {violation_rate:.4f}")
    lines.append(f"Consistency Score: {consistency:.4f}")
    if violation_rate < 0.1 and consistency > 0.8:
        lines.append("[OK] Structural prediction is RELIABLE")
    elif violation_rate < 0.2 and consistency > 0.6:
        lines.append("[OK] Structural prediction is ACCEPTABLE")
    else:
        lines.append("[!] Structural prediction needs improvement")
    lines.append("")

    mv = results["model_validation"]
    cycle_error = mv["cycle_consistency_error_mean"]
    stability = mv["prediction_stability_mean"]
    plausibility = mv["physical_plausibility_mean"]
    lines += ["4. MODEL VALIDATION", sub]
    lines.append(f"Cycle Consistency Error: {cycle_error:.6f}")
    lines.append(f"Prediction Stability: {stability:.6f}")
    lines.append(f"Physical Plausibility: {plausibility:.4f}")
    if cycle_error < 0.01 and stability < 0.01 and plausibility > 0.8:
        lines.append("[OK] Model validation is EXCELLENT")
    elif cycle_error < 0.05 and stability < 0.05 and plausibility > 0.6:
        lines.append("[OK] Model validation is GOOD")
    else:
        lines.append("[!] Model validation shows concerns")
    lines.append("")

    verdicts: list = []
    if ceilings or oracle:
        lines += ["5. TARGETS vs ACHIEVABLE CEILINGS", sub]
        lines.append(f"{'metric':<22}{'measured':>10}{'target':>9}{'ceiling':>9}  verdict")

        def target_line(name, measured, target, ceiling=None, mode=">"):
            met = measured > target if mode == ">" else measured < target
            if met:
                verdict = "TARGET MET"
            elif ceiling is not None and mode == ">" and measured >= ceiling - 0.05:
                verdict = "AT CEILING (target statistically unreachable)"
            elif ceiling is not None and mode == "<" and measured <= ceiling * 1.1:
                verdict = "AT FLOOR (target statistically unreachable)"
            else:
                verdict = "below target"
            ceil_s = f"{ceiling:>9.4f}" if ceiling is not None else f"{'-':>9}"
            verdicts.append(verdict)
            lines.append(
                f"{name:<22}{measured:>10.4g}{target:>9.3f}{ceil_s}  {verdict}"
            )

        c = ceilings or {}
        target_line("spectrum R2", spectrum_r2, 0.9,
                    c.get("spectrum_r2_ceiling"))
        target_line("metrics R2", metrics_r2, 0.9,
                    c.get("metrics_r2_ceiling"))
        target_line("parameter R2", param_r2, 0.85)
        target_line("cycle error (noisy)", cycle_error, 0.005,
                    c.get("cycle_error_floor"), mode="<")
        if oracle:
            target_line("cycle error (truth)",
                        oracle["cycle_error_vs_truth"], 0.005, mode="<")
            target_line("surrogate R2 (truth)",
                        oracle["surrogate_spectrum_r2_vs_truth"], 0.9)
        target_line("stability", stability, 0.001, mode="<")
        lines.append("")
        if ceilings:
            lines.append(
                f"Noise-ceiling method: two independent noise draws of the same "
                f"cells at sigma={c.get('noise_level', 0):.3g} correlate at "
                f"c={c.get('draw_to_draw_spectrum_r2', 0):.3f} (spectrum) / "
                f"{c.get('draw_to_draw_metrics_r2', 0):.3f} (metrics); the best "
                f"possible model R2 against a noisy target is (1+c)/2.  The "
                f"cycle-error floor vs noisy targets is sigma^2 = "
                f"{c.get('cycle_error_floor', 0):.4g} for ANY model (additive "
                f"noise is independent of the reconstruction)."
            )
        if oracle:
            lines.append(
                "Clean-oracle method: the synthetic generator is the physics "
                "oracle, so the SAME model is also scored against the "
                "noise-free truth of the same cells."
            )
        lines.append(
            f"D accuracy {disc_acc:.3f} vs 0.85 'target': at GAN equilibrium a "
            "discriminator SHOULD sit near 0.5 — the reference's own best "
            "checkpoint records D balance 51% (constraint_optimizer.py:37); "
            "a 0.85-accurate D would mean the generator is losing."
        )
        lines.append("")

    lines += ["6. OVERALL ASSESSMENT" if (ceilings or oracle)
              else "5. OVERALL ASSESSMENT", sub]
    excellent_count = sum(
        [
            spectrum_r2 > 0.9 and metrics_r2 > 0.9,
            param_r2 > 0.8 and disc_acc > 0.8,
            violation_rate < 0.1 and consistency > 0.8,
            cycle_error < 0.01 and stability < 0.01 and plausibility > 0.8,
        ]
    )
    if excellent_count >= 3:
        lines.append("OVERALL RATING: EXCELLENT")
    elif excellent_count >= 2:
        lines.append("OVERALL RATING: GOOD")
    else:
        lines.append("OVERALL RATING: NEEDS IMPROVEMENT")
    if verdicts:
        # the legacy rubric above grades against the published targets; this
        # line grades against what is STATISTICALLY ACHIEVABLE on this data
        ok = sum(v != "below target" for v in verdicts)
        adj = ("EXCELLENT" if ok == len(verdicts)
               else "GOOD" if ok >= len(verdicts) - 1 else "NEEDS IMPROVEMENT")
        lines.append(
            f"CEILING-ADJUSTED RATING: {adj} "
            f"({ok}/{len(verdicts)} targets met or at the statistical limit)"
        )
    lines.append(bar)

    content = "\n".join(lines)
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        with open(save_path, "w") as fh:
            fh.write(content)
    return content
