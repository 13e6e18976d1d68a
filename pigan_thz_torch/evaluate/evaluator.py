"""Unified evaluator: the reference's four evaluation suites, each one pass
over the whole device-resident evaluation set.  The port of
``pigan_thz_tpu/evaluate/evaluator.py`` (core/evaluate/unified_evaluator.py:
30-533).

Where the reference streams 64-sample minibatches through its modules and
aggregates on the host with sklearn / scipy, each suite here runs the
eval-mode modules once on the full set (1000 x 250 is tiny) with the metric
kit of ``ops/metrics.py``.  There is no kernel here: the JAX evaluator has
none.

Suites and their reference counterparts:
- forward_network        (:186-255)  F(params) -> spectrum / metrics R²
                                      (metrics compared in DEnormalized
                                      physical units via the dataset's metric
                                      ranges, :221);
- pigan                  (:257-343)  G's param R² in denormalized units + D's
                                      real / fake / overall accuracy at 0.5;
- structural_prediction  (:345-413)  violation rate (pred outside [0, 1]),
                                      F∘G recon error, consistency 1/(1+err);
- model_validation       (:415-490)  cycle error, noise stability (σ = 0.01),
                                      plausibility = mean σ(10·p − 5).

Every ``*_std`` is the population standard deviation, as ``jnp.std`` gives.
The stability noise is an explicit argument: a (N, S) array of unit normals,
or a ``torch.Generator`` that draws it on the CPU (one seed gives the same
noise on every device); by default a generator seeded with 0.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..data.dataset import ThzDataset, denormalize_metrics, denormalize_params
from ..ops import metrics as M


def _std(x: torch.Tensor) -> torch.Tensor:
    return torch.std(x, unbiased=False)


class Evaluator:
    """Holds the three trained modules; every suite runs them in eval mode
    without gradients and leaves their training mode as it found it."""

    def __init__(
        self,
        generator: nn.Module,
        discriminator: nn.Module,
        forward_model: nn.Module,
        noise_sigma: float = 0.01,
        violation_window: tuple[float, float] = (0.0, 1.0),
    ):
        """``violation_window``: the range-violation measurement window.

        The default (0, 1) reproduces the reference's quirk of judging the
        generator's tanh output (range [-1, 1]) against a [0, 1] box
        (unified_evaluator.py:380, loss.py:104-127), which is why the
        reference records 87-91 % violation on well-trained models.  Pass
        (-1, 1) for the convention-consistent measurement.
        """
        self.generator = generator
        self.discriminator = discriminator
        self.forward_model = forward_model
        self.noise_sigma = noise_sigma
        self.violation_window = violation_window

    # -- the modules in eval mode ------------------------------------------
    def _eval(self, module: nn.Module, *args):
        was_training = module.training
        module.eval()
        try:
            with torch.no_grad():
                return module(*args)
        finally:
            module.train(was_training)

    def _g(self, spectra):
        return self._eval(self.generator, spectra)

    def _d(self, spectra, params):
        return self._eval(self.discriminator, spectra, params)

    def _f(self, params_norm):
        out = self._eval(self.forward_model, params_norm)
        return out[0], out[1]

    def _noise(self, ds: ThzDataset, noise) -> torch.Tensor:
        if noise is None:
            noise = torch.Generator().manual_seed(0)
        if isinstance(noise, torch.Generator):
            noise = torch.randn(tuple(ds.spectra.shape), generator=noise)
        noise = torch.as_tensor(noise, dtype=torch.float32).to(ds.spectra.device)
        if noise.shape != ds.spectra.shape:
            raise ValueError(f"noise {tuple(noise.shape)}, spectra {tuple(ds.spectra.shape)}")
        return noise

    def _violations(self, pred_norm: torch.Tensor) -> torch.Tensor:
        v_lo, v_hi = self.violation_window
        return torch.sum((pred_norm < v_lo) | (pred_norm > v_hi), dim=1).to(torch.float32)

    # -- suites (the names of unified_evaluator's methods) -----------------
    def forward_network(self, ds: ThzDataset) -> Dict[str, Any]:
        pred_spec, pred_met_norm = self._f(ds.params_norm)
        pred_met = denormalize_metrics(pred_met_norm, ds.metric_lo, ds.metric_hi)
        real_met = denormalize_metrics(ds.metrics_norm, ds.metric_lo, ds.metric_hi)
        return {
            "spectrum_prediction": M.regression_metrics(ds.spectra, pred_spec),
            "metrics_prediction": M.regression_metrics(real_met, pred_met),
        }

    def pigan(self, ds: ThzDataset) -> Dict[str, Any]:
        pred_norm = self._g(ds.spectra)
        pred_phys = denormalize_params(pred_norm, ds.param_lo, ds.param_hi)
        real_scores = torch.sigmoid(self._d(ds.spectra, ds.params))
        fake_scores = torch.sigmoid(self._d(ds.spectra, pred_phys))
        real_acc = torch.mean((real_scores > 0.5).to(torch.float32))
        fake_acc = torch.mean((fake_scores < 0.5).to(torch.float32))
        return {
            "parameter_prediction": M.regression_metrics(ds.params, pred_phys),
            "discriminator_performance": {
                "real_accuracy": real_acc,
                "fake_accuracy": fake_acc,
                "overall_accuracy": (real_acc + fake_acc) / 2.0,
                "real_score_mean": torch.mean(real_scores),
                "fake_score_mean": torch.mean(fake_scores),
            },
        }

    def structural_prediction(self, ds: ThzDataset) -> Dict[str, Any]:
        pred_norm = self._g(ds.spectra)
        violations = self._violations(pred_norm)
        recon_spec, _ = self._f(pred_norm)
        err = torch.mean((ds.spectra - recon_spec) ** 2, dim=1)
        consistency = 1.0 / (1.0 + err)
        return {
            "param_range_violation_rate": torch.mean((violations > 0).to(torch.float32)),
            "avg_param_violations": torch.mean(violations),
            "reconstruction_error_mean": torch.mean(err),
            "reconstruction_error_std": _std(err),
            "consistency_score_mean": torch.mean(consistency),
            "consistency_score_std": _std(consistency),
        }

    def model_validation(self, ds: ThzDataset, noise=None) -> Dict[str, Any]:
        pred_norm = self._g(ds.spectra)
        recon_spec, _ = self._f(pred_norm)
        cycle = torch.mean((ds.spectra - recon_spec) ** 2, dim=1)
        noisy = ds.spectra + self.noise_sigma * self._noise(ds, noise)
        stability = torch.mean((pred_norm - self._g(noisy)) ** 2, dim=1)
        plausibility = torch.mean(torch.sigmoid(pred_norm * 10.0 - 5.0), dim=1)
        return {
            "cycle_consistency_error_mean": torch.mean(cycle),
            "cycle_consistency_error_std": _std(cycle),
            "prediction_stability_mean": torch.mean(stability),
            "prediction_stability_std": _std(stability),
            "physical_plausibility_mean": torch.mean(plausibility),
            "physical_plausibility_std": _std(plausibility),
        }

    def sample_arrays(self, ds: ThzDataset, noise=None) -> Dict[str, np.ndarray]:
        """Per-sample diagnostic arrays (host numpy) for the figures:
        the panels of the reference's EvaluationVisualizer need
        distributions, not just the suites' means."""
        pred_norm = self._g(ds.spectra)
        pred_phys = denormalize_params(pred_norm, ds.param_lo, ds.param_hi)
        real_scores = torch.sigmoid(self._d(ds.spectra, ds.params))[:, 0]
        fake_scores = torch.sigmoid(self._d(ds.spectra, pred_phys))[:, 0]
        fwd_spec, _ = self._f(ds.params_norm)
        spec_err = torch.mean((ds.spectra - fwd_spec) ** 2, dim=1)
        recon_spec, _ = self._f(pred_norm)
        recon_err = torch.mean((ds.spectra - recon_spec) ** 2, dim=1)
        noisy = ds.spectra + self.noise_sigma * self._noise(ds, noise)
        out = {
            "pred_norm": pred_norm,
            "pred_phys": pred_phys,
            "real_params": ds.params,
            "real_scores": real_scores,
            "fake_scores": fake_scores,
            "fwd_pred_spectra": fwd_spec,
            "spectrum_err": spec_err,
            "recon_spectra": recon_spec,
            "recon_err": recon_err,
            "consistency": 1.0 / (1.0 + recon_err),
            "violations": self._violations(pred_norm),
            "cycle_err": recon_err,
            "stability": torch.mean((pred_norm - self._g(noisy)) ** 2, dim=1),
            "plausibility": torch.mean(torch.sigmoid(pred_norm * 10.0 - 5.0), dim=1),
            "frequencies": ds.frequencies,
            "spectra": ds.spectra,
        }
        return {k: v.detach().cpu().numpy() for k, v in out.items()}

    # -- orchestrator (run_comprehensive_evaluation :492-533) --------------
    def run_comprehensive_evaluation(self, ds: ThzDataset, noise=None) -> Dict[str, Any]:
        """All four suites as nested dicts of Python floats."""
        results = {
            "forward_network_evaluation": self.forward_network(ds),
            "pigan_evaluation": self.pigan(ds),
            "structural_prediction_evaluation": self.structural_prediction(ds),
            "model_validation": self.model_validation(ds, noise),
            "total_samples": ds.num_samples,
        }

        def to_float(x):
            if isinstance(x, dict):
                return {k: to_float(v) for k, v in x.items()}
            return float(x) if isinstance(x, torch.Tensor) else x

        return to_float(results)
