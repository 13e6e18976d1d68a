"""EvaluationVisualizer parity: five dedicated multi-panel figure functions.
The port's copy of ``pigan_thz_tpu/utils/eval_viz.py`` (numpy and
matplotlib only); the grades come from the port's ``evaluate/grading.py``.

Reference surface being matched (core/utils/visualization.py):
- plot_forward_network_evaluation   (:49-217)
- plot_pigan_evaluation             (:222-394)
- plot_structural_prediction_evaluation (:399-534)
- plot_model_validation_evaluation  (:539-716)
- plot_comprehensive_summary        (:721-983)

Each function takes the suite's results dict plus the per-sample arrays from
``Evaluator.sample_arrays`` (score distributions, per-sample errors — the
data the reference recomputes inside its visualizer), draws the same panel
families (overview bars, detailed metrics, example overlays, error/score
distributions, rating panels, issue identification), and saves a 300-dpi
PNG.  The comprehensive summary additionally shows achievable noise
ceilings next to each target when provided (evaluate/ceilings.py), so the
target-vs-ceiling story is visible in the figures, not just in prose.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np

from ..evaluate import grading

PARAM_NAMES = ("r1", "r2", "w", "g")

# one lazy-matplotlib bootstrap + save helper for all figure modules
from .viz import _plt, _save  # noqa: E402


def _bars(ax, names, values, title, targets=None, fmt="{:.3f}"):
    x = np.arange(len(names))
    bars = ax.bar(x, values, width=0.55, color="#4878cf")
    if targets is not None:
        ax.bar(x + 0.28, targets, width=0.22, color="#d65f5f", alpha=0.7,
               label="target")
        ax.legend(fontsize=7)
    for b, v in zip(bars, values):
        ax.text(b.get_x() + b.get_width() / 2, b.get_height(),
                fmt.format(v), ha="center", va="bottom", fontsize=7)
    ax.set_xticks(x)
    ax.set_xticklabels(names, rotation=25, fontsize=8)
    ax.set_title(title, fontsize=10)
    ax.grid(alpha=0.3, axis="y")


def _rating_panel(ax, title, lines):
    ax.axis("off")
    ax.set_title(title, fontsize=10)
    ax.text(0.02, 0.95, "\n".join(lines), transform=ax.transAxes,
            fontsize=9, va="top", family="monospace")


# ---------------------------------------------------------------------------
# 1. Forward network (visualization.py:49-217)
# ---------------------------------------------------------------------------


def _radar(fig, pos, names, values, title, color="#4878cf"):
    """Polar radar panel (reference: visualization.py:94-114 — the forward
    figure's detailed-metrics radar; values expected in [0, 1])."""
    ax = fig.add_subplot(*pos, projection="polar")
    angles = np.linspace(0, 2 * np.pi, len(names), endpoint=False).tolist()
    vals = [float(np.clip(v, 0.0, 1.0)) for v in values]
    ax.plot(angles + angles[:1], vals + vals[:1], lw=1.5, color=color)
    ax.fill(angles + angles[:1], vals + vals[:1], alpha=0.25, color=color)
    ax.set_xticks(angles)
    ax.set_xticklabels(names, fontsize=7)
    ax.set_ylim(0, 1)
    ax.set_title(title, fontsize=10)
    return ax


def plot_forward_network_evaluation(
    results: Dict[str, Any], arrays: Mapping[str, np.ndarray], path: str
) -> str:
    plt = _plt()
    spec, met = results["spectrum_prediction"], results["metrics_prediction"]
    fig, axes = plt.subplots(2, 3, figsize=(18, 9))
    fig.suptitle("Forward Network Evaluation", fontsize=14)

    _bars(axes[0, 0], ["spectrum R2", "metrics R2"],
          [spec["r2"], met["r2"]], "Performance overview",
          targets=[0.9, 0.9])
    # detailed-metrics RADAR (visualization.py:94-114): error metrics are
    # inverted into [0, 1] scores (1/(1+err)) so "bigger is better" reads
    # uniformly around the polar axes, R2/pearson clip to [0, 1]
    axes[0, 1].remove()
    _radar(
        fig, (2, 3, 2),
        ["1/(1+MSE)", "1/(1+MAE)", "1/(1+RMSE)", "R2", "pearson"],
        [1.0 / (1.0 + spec["mse"]), 1.0 / (1.0 + spec["mae"]),
         1.0 / (1.0 + spec["rmse"]), spec["r2"], spec["pearson_r"]],
        "Spectrum prediction detailed metrics",
    )
    _bars(axes[0, 2], ["mse", "mae", "rmse", "pearson"],
          [met["mse"], met["mae"], met["rmse"], met["pearson_r"]],
          "Metrics prediction detailed metrics", fmt="{:.4f}")

    ax = axes[1, 0]
    freq = arrays["frequencies"]
    for i in range(min(3, arrays["spectra"].shape[0])):
        ax.plot(freq, arrays["spectra"][i], lw=1.0, alpha=0.8,
                label="real" if i == 0 else None)
        ax.plot(freq, arrays["fwd_pred_spectra"][i], lw=1.0, ls="--",
                alpha=0.8, label="predicted" if i == 0 else None)
    ax.set_title("Spectrum reconstruction examples", fontsize=10)
    ax.set_xlabel("frequency (THz)", fontsize=8)
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)

    ax = axes[1, 1]
    ax.hist(arrays["spectrum_err"], bins=30, color="#4878cf")
    ax.axvline(arrays["spectrum_err"].mean(), color="k", ls="--", lw=1,
               label=f"mean={arrays['spectrum_err'].mean():.4f}")
    ax.set_title("Spectrum prediction error distribution", fontsize=10)
    ax.set_xlabel("per-sample MSE", fontsize=8)
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)

    s, m = spec["r2"], met["r2"]
    rating = grading.grade_forward(s, m)
    _rating_panel(axes[1, 2], "Forward network rating", [
        f"spectrum R2 : {s:.4f}",
        f"metrics  R2 : {m:.4f}",
        "",
        f"RATING: {rating}",
    ])
    return _save(fig, path)


# ---------------------------------------------------------------------------
# 2. PI-GAN (visualization.py:222-394)
# ---------------------------------------------------------------------------


def plot_pigan_evaluation(
    results: Dict[str, Any], arrays: Mapping[str, np.ndarray], path: str,
    history: Optional[Mapping[str, Any]] = None,
) -> str:
    """`history` (optional): train-history mapping with 'pigan/d_loss' /
    'pigan/g_loss' lists — fills the training-loss-curve panel the
    reference embeds in its PI-GAN figure (visualization.py:331-341)."""
    plt = _plt()
    par, dis = results["parameter_prediction"], results["discriminator_performance"]
    fig, axes = plt.subplots(2, 5, figsize=(26, 9))
    fig.suptitle("PI-GAN Evaluation", fontsize=14)

    real, pred = arrays["real_params"], arrays["pred_phys"]
    for i in range(4):
        ax = axes[0, i]
        ax.scatter(real[:, i], pred[:, i], s=4, alpha=0.35, color="#4878cf")
        lims = [real[:, i].min(), real[:, i].max()]
        ax.plot(lims, lims, "k--", lw=1)
        r = np.corrcoef(real[:, i], pred[:, i])[0, 1]
        ax.set_title(f"{PARAM_NAMES[i]}: pred vs true  (R={r:.3f})", fontsize=9)
        ax.grid(alpha=0.3)

    # per-parameter error histograms (reference panel family: per-metric
    # distribution depth, visualization.py:399-538 style)
    ax = axes[0, 4]
    for i in range(4):
        ax.hist(pred[:, i] - real[:, i], bins=25, alpha=0.5,
                label=PARAM_NAMES[i])
    ax.axvline(0.0, color="k", ls="--", lw=1)
    ax.set_title("Per-parameter error distributions", fontsize=10)
    ax.set_xlabel("pred - true", fontsize=8)
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)

    _bars(axes[1, 0], ["R2", "MAE", "RMSE", "pearson"],
          [par["r2"], par["mae"], par["rmse"], par["pearson_r"]],
          "Generator parameter prediction")
    _bars(axes[1, 1],
          ["real acc", "fake acc", "overall", "real score", "fake score"],
          [dis["real_accuracy"], dis["fake_accuracy"], dis["overall_accuracy"],
           dis["real_score_mean"], dis["fake_score_mean"]],
          "Discriminator performance")

    ax = axes[1, 2]
    ax.hist(arrays["real_scores"], bins=30, alpha=0.6, label="real", color="#4878cf")
    ax.hist(arrays["fake_scores"], bins=30, alpha=0.6, label="fake", color="#d65f5f")
    ax.axvline(0.5, color="k", ls="--", lw=1)
    ax.set_title("Discriminator score distributions", fontsize=10)
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)

    # training loss curves (visualization.py:331-341)
    ax = axes[1, 3]
    dl = list(history.get("pigan/d_loss", [])) if history else []
    gl = list(history.get("pigan/g_loss", [])) if history else []
    if dl or gl:
        handles = []
        if dl:
            handles += ax.plot(dl, lw=1.0, label="D loss", color="#d65f5f")
        if gl:
            ax2 = ax.twinx()
            handles += ax2.plot(gl, lw=1.0, label="G loss", color="#4878cf")
            ax2.set_ylabel("G loss", fontsize=8)
        ax.set_xlabel("epoch", fontsize=8)
        ax.set_ylabel("D loss", fontsize=8)
        # one legend for both twinned axes (ax.legend() alone would drop
        # the G curve's handle, which lives on ax2)
        ax.legend(handles=handles, fontsize=7, loc="upper left")
        ax.grid(alpha=0.3)
    else:
        ax.axis("off")
        ax.text(0.5, 0.5, "no training history", ha="center", va="center",
                transform=ax.transAxes, fontsize=9)
    ax.set_title("Training loss curves", fontsize=10)

    r2, acc = par["r2"], dis["overall_accuracy"]
    rating = grading.grade_pigan(r2, acc)
    lines = [f"param R2 : {r2:.4f}", f"D accuracy: {acc:.4f}", "",
             f"RATING: {rating}"]
    if grading.d_equilibrium(r2, acc):
        lines += ["", "note: D ~= 0.5 with high R2", "is a healthy equilibrium",
                  "(reference best: balance 51%)"]
    _rating_panel(axes[1, 4], "PI-GAN comprehensive assessment", lines)
    return _save(fig, path)


# ---------------------------------------------------------------------------
# 3. Structural prediction (visualization.py:399-534)
# ---------------------------------------------------------------------------


def plot_structural_prediction_evaluation(
    results: Dict[str, Any], arrays: Mapping[str, np.ndarray], path: str
) -> str:
    plt = _plt()
    fig, axes = plt.subplots(2, 3, figsize=(18, 9))
    fig.suptitle("Structural Prediction Evaluation", fontsize=14)
    v = results["param_range_violation_rate"]

    ax = axes[0, 0]
    frac_viol = float((arrays["violations"] > 0).mean())
    ax.pie([1 - frac_viol, frac_viol], labels=["within range", "violating"],
           autopct="%1.1f%%", colors=["#6acc65", "#d65f5f"], startangle=90)
    ax.set_title(f"Constraint violation analysis (rate: {v:.2%})", fontsize=10)

    ax = axes[0, 1]
    ax.hist(arrays["consistency"], bins=30, color="#4878cf")
    ax.axvline(results["consistency_score_mean"], color="k", ls="--", lw=1,
               label=f"mean={results['consistency_score_mean']:.3f}")
    ax.set_title("Prediction consistency distribution", fontsize=10)
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)

    ax = axes[1, 0]
    ax.hist(arrays["recon_err"], bins=30, color="#4878cf")
    ax.axvline(results["reconstruction_error_mean"], color="k", ls="--", lw=1,
               label=f"mean={results['reconstruction_error_mean']:.4f}")
    ax.set_title("Reconstruction error analysis", fontsize=10)
    ax.set_xlabel("per-sample MSE", fontsize=8)
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)

    # radar: suite-quality overview
    axes[0, 2].remove()
    c, e = results["consistency_score_mean"], results["reconstruction_error_mean"]
    _radar(
        fig, (2, 3, 3),
        ["1-violation", "consistency", "1/(1+recon)", "low spread"],
        [1.0 - v, c, 1.0 / (1.0 + e),
         1.0 / (1.0 + float(np.std(arrays["consistency"])))],
        "Structural quality radar",
    )

    # performance comparison vs targets (visualization.py:476-497)
    ax = axes[1, 1]
    names = ["violation", "1-consistency", "recon err"]
    vals = [max(v, 1e-8), max(1.0 - c, 1e-8), max(e, 1e-8)]
    targets = [0.05, 0.1, 0.01]
    x = np.arange(3)
    ax.bar(x - 0.2, vals, width=0.4, label="measured", color="#4878cf")
    ax.bar(x + 0.2, targets, width=0.4, label="target", color="#d65f5f",
           alpha=0.7)
    ax.set_yscale("log")
    ax.set_xticks(x)
    ax.set_xticklabels(names, fontsize=8)
    ax.set_title("Structural prediction performance comparison", fontsize=10)
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3, axis="y")

    rating = grading.grade_structural(v, c, e)
    _rating_panel(axes[1, 2], "Structural prediction rating", [
        f"violation rate : {v:.4f}   (target < 0.05)",
        f"consistency    : {c:.4f}   (target > 0.9)",
        f"recon error    : {e:.4f}   (target < 0.01)",
        "",
        f"RATING: {rating}",
    ])
    return _save(fig, path)


# ---------------------------------------------------------------------------
# 4. Model validation (visualization.py:539-716)
# ---------------------------------------------------------------------------


def _grade_bar(ax, value, thresholds, labels, title, reverse=False):
    """Horizontal grade gauge: where `value` sits among graded bands."""
    colors = ["#6acc65", "#b5d66b", "#eec36c", "#d65f5f"]
    bands = list(thresholds)
    for i, lab in enumerate(labels):
        ax.barh(0, 1, left=i, color=colors[min(i, 3)], height=0.5)
        ax.text(i + 0.5, -0.5, lab, ha="center", fontsize=7)
    if reverse:
        pos = sum(value < t for t in bands)
    else:
        pos = sum(value > t for t in bands)
    ax.plot([pos + 0.5], [0.45], marker="v", color="k", ms=10)
    ax.set_xlim(0, len(labels))
    ax.set_ylim(-1, 1)
    ax.axis("off")
    ax.set_title(f"{title}\nvalue: {value:.6f}", fontsize=9)


def plot_model_validation_evaluation(
    results: Dict[str, Any], arrays: Mapping[str, np.ndarray], path: str
) -> str:
    plt = _plt()
    fig, axes = plt.subplots(2, 4, figsize=(22, 8))
    fig.suptitle("Model Validation Evaluation", fontsize=14)
    cy = results["cycle_consistency_error_mean"]
    st = results["prediction_stability_mean"]
    pl = results["physical_plausibility_mean"]

    _grade_bar(axes[0, 0], cy, grading.VALIDATION_BOUNDS["cycle"],
               ["EXC", "GOOD", "MOD", "POOR"], "Cycle consistency grade")
    _grade_bar(axes[0, 1], st, grading.VALIDATION_BOUNDS["stability"],
               ["EXC", "GOOD", "MOD", "POOR"], "Prediction stability grade")
    _grade_bar(axes[0, 2], pl, grading.VALIDATION_BOUNDS["plausibility"],
               ["EXC", "GOOD", "MOD", "POOR"], "Physical plausibility grade",
               reverse=True)

    # per-suite radar
    axes[0, 3].remove()
    _radar(
        fig, (2, 4, 4),
        ["1/(1+cycle)", "1/(1+stability)", "plausibility"],
        [1.0 / (1.0 + cy), 1.0 / (1.0 + st), pl],
        "Validation quality radar",
    )

    ax = axes[1, 0]
    ax.hist(arrays["cycle_err"], bins=30, color="#4878cf")
    ax.axvline(cy, color="k", ls="--", lw=1, label=f"mean={cy:.4f}")
    ax.set_title("Cycle error distribution", fontsize=10)
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)

    ax = axes[1, 1]
    ax.hist(arrays["stability"], bins=30, color="#4878cf")
    ax.axvline(st, color="k", ls="--", lw=1, label=f"mean={st:.6f}")
    ax.set_title("Stability error distribution", fontsize=10)
    ax.set_xlabel("per-sample noisy-repredict MSE", fontsize=8)
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)

    ax = axes[1, 2]
    names = ["cycle err", "stability", "1-plausibility"]
    vals = [max(cy, 1e-8), max(st, 1e-8), max(1 - pl, 1e-8)]
    targets = [0.005, 0.001, 0.1]
    x = np.arange(3)
    ax.bar(x - 0.2, vals, width=0.4, label="measured", color="#4878cf")
    ax.bar(x + 0.2, targets, width=0.4, label="target", color="#d65f5f", alpha=0.7)
    ax.set_yscale("log")
    ax.set_xticks(x)
    ax.set_xticklabels(names, fontsize=8)
    ax.set_title("Validation metrics vs targets (log)", fontsize=10)
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3, axis="y")

    checks = [
        ("cycle < 0.01", cy < 0.01),
        ("stability < 0.01", st < 0.01),
        ("plausibility > 0.8", pl > 0.8),
        ("cycle std finite", np.isfinite(results["cycle_consistency_error_std"])),
    ]
    passed = sum(ok for _, ok in checks)
    _rating_panel(axes[1, 3], f"Validation checks ({passed}/{len(checks)} passed)",
                  [("[OK] " if ok else "[X]  ") + name for name, ok in checks])
    return _save(fig, path)


# ---------------------------------------------------------------------------
# 5. Comprehensive summary (visualization.py:721-983)
# ---------------------------------------------------------------------------


def plot_comprehensive_summary(
    results: Dict[str, Any], path: str,
    ceilings: Optional[Dict[str, float]] = None,
) -> str:
    plt = _plt()
    fwd = results["forward_network_evaluation"]
    pig = results["pigan_evaluation"]
    st = results["structural_prediction_evaluation"]
    mv = results["model_validation"]
    fig, axes = plt.subplots(2, 4, figsize=(25, 10))
    fig.suptitle("Comprehensive Evaluation Summary", fontsize=14)

    # radar
    axes[0, 0].remove()
    scores = {
        "Forward R2": max(0.0, fwd["spectrum_prediction"]["r2"]),
        "Param R2": max(0.0, pig["parameter_prediction"]["r2"]),
        "D accuracy": pig["discriminator_performance"]["overall_accuracy"],
        "Consistency": st["consistency_score_mean"],
        "1-Violation": 1.0 - st["param_range_violation_rate"],
        "Plausibility": mv["physical_plausibility_mean"],
    }
    _radar(fig, (2, 4, 1), list(scores), list(scores.values()),
           "Model quality radar")

    # per-module score bars
    module_scores = {
        "forward": np.clip(0.5 * (fwd["spectrum_prediction"]["r2"]
                                  + fwd["metrics_prediction"]["r2"]), 0, 1),
        "pigan": np.clip(pig["parameter_prediction"]["r2"], 0, 1),
        "structural": st["consistency_score_mean"],
        "validation": mv["physical_plausibility_mean"],
    }
    _bars(axes[0, 1], list(module_scores), list(module_scores.values()),
          "Per-module performance")

    # measured vs target (vs achievable ceiling)
    ax = axes[0, 2]
    names = ["spec R2", "metr R2", "param R2", "D acc"]
    measured = [fwd["spectrum_prediction"]["r2"], fwd["metrics_prediction"]["r2"],
                pig["parameter_prediction"]["r2"],
                pig["discriminator_performance"]["overall_accuracy"]]
    targets = [0.9, 0.9, 0.85, 0.85]
    x = np.arange(len(names))
    ax.bar(x - 0.25, measured, width=0.25, label="measured", color="#4878cf")
    ax.bar(x, targets, width=0.25, label="target", color="#d65f5f", alpha=0.7)
    if ceilings:
        ceil = [ceilings.get("spectrum_r2_ceiling", np.nan),
                ceilings.get("metrics_r2_ceiling", np.nan), np.nan, np.nan]
        ax.bar(x + 0.25, ceil, width=0.25, label="achievable ceiling",
               color="#6acc65", alpha=0.8)
    ax.set_xticks(x)
    ax.set_xticklabels(names, fontsize=8)
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3, axis="y")
    ax.set_title("Measured vs target" + (" vs ceiling" if ceilings else ""),
                 fontsize=10)

    # performance improvement prediction (visualization.py:867-897): where
    # each module could plausibly land — halfway from its current score to
    # its target (or the ceiling where one binds)
    ax = axes[0, 3]
    mod_names = list(module_scores)
    cur = np.clip(list(module_scores.values()), 0.0, 1.0)
    goal = np.array([0.9, 0.85, 0.9, 0.8])
    predicted = np.minimum(1.0, np.maximum(cur, cur + 0.5 * (goal - cur)))
    x = np.arange(len(mod_names))
    ax.bar(x - 0.2, cur, width=0.4, label="current", color="#4878cf")
    ax.bar(x + 0.2, predicted, width=0.4, label="predicted after tuning",
           color="#6acc65", alpha=0.8)
    ax.set_xticks(x)
    ax.set_xticklabels(mod_names, fontsize=8)
    ax.set_ylim(0, 1.05)
    ax.set_title("Performance improvement prediction", fontsize=10)
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3, axis="y")

    # key issues
    issues = []
    # .get like the measured-vs-target panel above: a partial ceilings
    # dict (e.g. cycle floor only) must not KeyError the whole figure
    sc = ceilings.get("spectrum_r2_ceiling") if ceilings else None
    mc = ceilings.get("metrics_r2_ceiling") if ceilings else None
    if fwd["spectrum_prediction"]["r2"] < 0.9:
        line = f"spectrum R2 {fwd['spectrum_prediction']['r2']:.3f} < 0.9 target"
        if sc is not None and fwd["spectrum_prediction"]["r2"] >= sc - 0.05:
            line += f" (AT noise ceiling {sc:.3f})"
        issues.append(line)
    if fwd["metrics_prediction"]["r2"] < 0.9:
        line = f"metrics R2 {fwd['metrics_prediction']['r2']:.3f} < 0.9 target"
        if mc is not None and fwd["metrics_prediction"]["r2"] >= mc - 0.05:
            line += f" (AT noise ceiling {mc:.3f})"
        issues.append(line)
    if pig["parameter_prediction"]["r2"] < 0.85:
        issues.append(f"param R2 {pig['parameter_prediction']['r2']:.3f} < 0.85")
    if st["param_range_violation_rate"] > 0.05:
        issues.append(
            f"violation rate {st['param_range_violation_rate']:.2%} > 5% "
            "(parity [0,1] window on tanh)")
    if mv["cycle_consistency_error_mean"] > 0.005:
        issues.append(
            f"cycle err {mv['cycle_consistency_error_mean']:.4f} > 0.005 "
            "(vs noisy target)")
    _rating_panel(axes[1, 0], "Key issue identification",
                  [f"- {i}" for i in issues] or ["none - all targets met"])

    # recommendations
    recs = []
    if issues:
        if any("noise ceiling" in i for i in issues):
            recs.append("R2 at ceiling: more training cannot help;")
            recs.append("  reduce data noise or average repeats")
        if st["param_range_violation_rate"] > 0.05:
            recs.append("violation: use violation_window=(-1,1) or")
            recs.append("  constraint fine-tune program")
        if mv["cycle_consistency_error_mean"] > 0.005:
            recs.append("cycle: evaluate vs clean oracle truth;")
            recs.append("  train longer with detach_forward=False")
    _rating_panel(axes[1, 1], "Improvement recommendations",
                  recs or ["maintain current configuration"])

    # rating distribution across suites
    def rate(cond_exc, cond_good):
        return "EXCELLENT" if cond_exc else ("GOOD" if cond_good else "NEEDS WORK")

    ratings = [
        rate(fwd["spectrum_prediction"]["r2"] > 0.9
             and fwd["metrics_prediction"]["r2"] > 0.9,
             fwd["spectrum_prediction"]["r2"] > 0.8
             and fwd["metrics_prediction"]["r2"] > 0.8),
        rate(pig["parameter_prediction"]["r2"] > 0.8
             and pig["discriminator_performance"]["overall_accuracy"] > 0.8,
             pig["parameter_prediction"]["r2"] > 0.6),
        rate(st["param_range_violation_rate"] < 0.1
             and st["consistency_score_mean"] > 0.8,
             st["param_range_violation_rate"] < 0.2
             and st["consistency_score_mean"] > 0.6),
        rate(mv["cycle_consistency_error_mean"] < 0.01
             and mv["prediction_stability_mean"] < 0.01
             and mv["physical_plausibility_mean"] > 0.8,
             mv["cycle_consistency_error_mean"] < 0.05),
    ]
    counts = {r: ratings.count(r) for r in ("EXCELLENT", "GOOD", "NEEDS WORK")}
    _bars(axes[1, 2], list(counts), list(counts.values()),
          "Suite rating distribution", fmt="{:.0f}")

    # bottom summary table (visualization.py:928-976 overview panel)
    rows = [
        ("forward", f"spec R2 {fwd['spectrum_prediction']['r2']:.4f}  "
                    f"metr R2 {fwd['metrics_prediction']['r2']:.4f}", ratings[0]),
        ("pigan", f"param R2 {pig['parameter_prediction']['r2']:.4f}  "
                  f"D acc {pig['discriminator_performance']['overall_accuracy']:.3f}",
         ratings[1]),
        ("structural", f"viol {st['param_range_violation_rate']:.3f}  "
                       f"consist {st['consistency_score_mean']:.3f}", ratings[2]),
        ("validation", f"cycle {mv['cycle_consistency_error_mean']:.4f}  "
                       f"plaus {mv['physical_plausibility_mean']:.3f}", ratings[3]),
    ]
    _rating_panel(
        axes[1, 3], "Evaluation summary table",
        [f"{name:<11} {vals}" for name, vals, _ in rows]
        + ["", *(f"{name:<11} -> {r}" for name, _, r in rows)],
    )
    return _save(fig, path)


SUITE_FIGURES = {
    "forward": ("forward_network_evaluation.png", plot_forward_network_evaluation),
    "pigan": ("pigan_evaluation.png", plot_pigan_evaluation),
    "structural": ("structural_prediction_evaluation.png",
                   plot_structural_prediction_evaluation),
    "validation": ("model_validation_evaluation.png",
                   plot_model_validation_evaluation),
}
