"""Visualization: training curves, prediction grids, evaluation figures.
The port of ``pigan_thz_tpu/utils/viz.py``.

Host-side matplotlib, covering the reference's plotting surface:
- plot_training_curves        <- plot_utils.plot_losses (:9-35) and the
                                 trainers' multi-panel curve figures
                                 (unified_trainer.py:457-608)
- plot_forward_predictions    <- plot_utils.plot_fwd_model_predictions (:93-161)
- plot_gan_comparison         <- plot_utils.plot_gan_samples (:37-91)
- plot_evaluation_summary     <- EvaluationVisualizer.plot_comprehensive_summary
                                 (visualization.py:721-983): radar of suite
                                 scores + per-suite bars vs targets
- plot_spectra_grid           <- the spectrum-overlay panels used across
                                 EvaluationVisualizer figures

All figures save as 300-dpi PNGs (visualization.py convention).  matplotlib
is imported lazily (Agg backend), so compute-only installs never need it.
The models are the port's ``nn.Module``s, run in eval mode without
gradients and left in the mode they were in.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from ..data.dataset import denormalize_params
from ..evaluate.evaluator import eval_forward


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=300, bbox_inches="tight")
    import matplotlib.pyplot as plt

    plt.close(fig)
    return path


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def plot_training_curves(history: Mapping[str, Sequence[float]], path: str) -> str:
    """All recorded loss/metric curves, grouped by prefix, log-scale where
    positive."""
    plt = _plt()
    keys = [k for k, v in history.items() if len(v) > 1]
    if not keys:
        keys = list(history.keys())
    n = len(keys)
    cols = min(3, max(1, n))
    rows = math.ceil(n / cols)
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 3.2 * rows), squeeze=False)
    for ax in axes.ravel()[n:]:
        ax.axis("off")
    for ax, k in zip(axes.ravel(), keys):
        v = np.asarray(history[k], dtype=float)
        ax.plot(v, lw=1.2)
        ax.set_title(k, fontsize=9)
        ax.set_xlabel("epoch", fontsize=8)
        if np.all(v > 0) and v.max() / max(v.min(), 1e-12) > 50:
            ax.set_yscale("log")
        ax.grid(alpha=0.3)
    fig.suptitle("Training curves")
    return _save(fig, path)


def plot_spectra_grid(
    frequencies: np.ndarray,
    real: np.ndarray,
    pred: np.ndarray,
    path: str,
    n: int = 6,
    title: str = "Spectrum reconstruction",
) -> str:
    plt = _plt()
    n = min(n, real.shape[0])
    cols = 3
    rows = math.ceil(n / cols)
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 3 * rows), squeeze=False)
    for ax in axes.ravel()[n:]:
        ax.axis("off")
    for i, ax in enumerate(axes.ravel()[:n]):
        ax.plot(frequencies, real[i], label="real", lw=1.2)
        ax.plot(frequencies, pred[i], label="predicted", lw=1.2, ls="--")
        ax.set_xlabel("frequency (THz)", fontsize=8)
        ax.set_ylabel("transmission (dB)", fontsize=8)
        ax.grid(alpha=0.3)
        if i == 0:
            ax.legend(fontsize=8)
    fig.suptitle(title)
    return _save(fig, path)


def plot_forward_predictions(ds, forward_model: torch.nn.Module, path: str,
                             n: int = 6) -> str:
    """Forward surrogate predictions vs ground truth on dataset samples."""
    pred = _np(eval_forward(forward_model, ds.params_norm[:n])[0])
    return plot_spectra_grid(
        _np(ds.frequencies), _np(ds.spectra[:n]), pred, path,
        n=n, title="Forward surrogate: params -> spectrum",
    )


def plot_gan_comparison(ds, generator: torch.nn.Module, forward_model: torch.nn.Module,
                        path: str, n: int = 6) -> str:
    """G(spectrum) -> params -> F -> reconstructed spectrum vs the input, with
    predicted parameter values annotated (plot_utils.py:37-91)."""
    plt = _plt()
    pred_norm = eval_forward(generator, ds.spectra[:n])
    recon = _np(eval_forward(forward_model, pred_norm)[0])
    pred_phys = _np(denormalize_params(pred_norm, ds.param_lo, ds.param_hi))
    real_phys = _np(ds.params[:n])
    freq = _np(ds.frequencies)
    spectra = _np(ds.spectra[:n])

    cols = 3
    rows = math.ceil(n / cols)
    fig, axes = plt.subplots(rows, cols, figsize=(5.5 * cols, 3.4 * rows), squeeze=False)
    for ax in axes.ravel()[n:]:
        ax.axis("off")
    names = ["r1", "r2", "w", "g"]
    for i, ax in enumerate(axes.ravel()[:n]):
        ax.plot(freq, spectra[i], label="input", lw=1.2)
        ax.plot(freq, recon[i], label="F(G(input))", lw=1.2, ls="--")
        truth = ", ".join(f"{nm}={v:.2f}" for nm, v in zip(names, real_phys[i]))
        guess = ", ".join(f"{nm}={v:.2f}" for nm, v in zip(names, pred_phys[i]))
        ax.set_title(f"true: {truth}\npred: {guess}", fontsize=7)
        ax.grid(alpha=0.3)
        if i == 0:
            ax.legend(fontsize=8)
    fig.suptitle("Inverse design: spectrum -> params -> reconstructed spectrum")
    return _save(fig, path)


def plot_evaluation_summary(results: Dict, path: str) -> str:
    """Radar of the four suite scores + bars vs targets
    (visualization.py:721-983 condensed)."""
    plt = _plt()
    fwd = results["forward_network_evaluation"]
    pig = results["pigan_evaluation"]
    st = results["structural_prediction_evaluation"]
    mv = results["model_validation"]

    scores = {
        "Forward R2": max(0.0, fwd["spectrum_prediction"]["r2"]),
        "Param R2": max(0.0, pig["parameter_prediction"]["r2"]),
        "D accuracy": pig["discriminator_performance"]["overall_accuracy"],
        "Consistency": st["consistency_score_mean"],
        "1-Violation": 1.0 - st["param_range_violation_rate"],
        "Plausibility": mv["physical_plausibility_mean"],
    }
    labels = list(scores)
    vals = list(scores.values())
    angles = np.linspace(0, 2 * np.pi, len(labels), endpoint=False).tolist()
    vals_c = vals + vals[:1]
    angles_c = angles + angles[:1]

    fig = plt.figure(figsize=(12, 5))
    ax = fig.add_subplot(121, projection="polar")
    ax.plot(angles_c, vals_c, lw=1.5)
    ax.fill(angles_c, vals_c, alpha=0.25)
    ax.set_xticks(angles)
    ax.set_xticklabels(labels, fontsize=8)
    ax.set_ylim(0, 1)
    ax.set_title("Model quality radar", fontsize=10)

    ax2 = fig.add_subplot(122)
    metric_names = ["spec R2", "metr R2", "param R2", "D acc", "viol rate",
                    "cycle err", "stability"]
    values = [
        fwd["spectrum_prediction"]["r2"],
        fwd["metrics_prediction"]["r2"],
        pig["parameter_prediction"]["r2"],
        pig["discriminator_performance"]["overall_accuracy"],
        st["param_range_violation_rate"],
        mv["cycle_consistency_error_mean"],
        mv["prediction_stability_mean"],
    ]
    targets = [0.9, 0.9, 0.85, 0.85, 0.05, 0.005, 0.001]
    x = np.arange(len(metric_names))
    ax2.bar(x - 0.2, values, width=0.4, label="measured")
    ax2.bar(x + 0.2, targets, width=0.4, label="target", alpha=0.6)
    ax2.set_xticks(x)
    ax2.set_xticklabels(metric_names, rotation=30, fontsize=8)
    ax2.legend(fontsize=8)
    ax2.grid(alpha=0.3, axis="y")
    ax2.set_title("Measured vs targets", fontsize=10)
    return _save(fig, path)


def save_evaluation_summary_json(results: Dict, path: str) -> str:
    """JSON summary writer (visualization.py:985-1155 equivalent)."""
    import json

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(results, fh, indent=2, default=float)
    return path
