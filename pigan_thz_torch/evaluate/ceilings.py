"""Self-verifying quality-target analysis: noise ceilings + clean oracle.
The port of ``pigan_thz_tpu/evaluate/ceilings.py``.

The reference publishes fixed quality targets (spectrum R2 0.9, metrics R2
0.9, cycle < 0.005 — training_optimization.py:194-215) but never asks what
is *achievable* on its noisy data.  Two tools make that reproducible:

- **Noise ceilings.** Draw the same cells twice with independent noise.
  If the draw-to-draw R2 is c = (S-N)/(S+N) (signal variance S, noise
  variance N), the best possible MODEL score against a noisy target is
  S/(S+N) = (1+c)/2.  At the default noise level this puts the spectrum-R2
  ceiling near 0.50 and the metrics-R2 ceiling near 0.78 — BELOW the 0.9
  targets, i.e. the targets are statistically unreachable on this data and
  any score above the ceiling is noise memorization.

- **Clean oracle.** The synthetic generator IS the physics oracle, so the
  same model can be scored against the noise-free truth of the same cells:
  surrogate R2 and F(G(s)) cycle error measured against what the spectrum
  actually is, not against one noisy draw of it.  (Only valid for datasets
  produced by the synthetic oracle.)

The draws come from a CPU generator (seed 0 by default) and move to the
device afterwards, as the evaluator's stability noise does: one seed gives
the same ceilings on every device.  The two draws' metrics are two calls of
``batched_peak_metrics``: on the card two launches of the dip-qualification
kernel's metrics entry, on the CPU its plain versions.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..config import DataConfig
from ..data.dataset import ThzDataset, metric_ranges_from_data, normalize_metrics
from ..data.synthetic import dip_centers, sample_params, synthesize_spectra
from ..ops.metrics import r2_pooled, r2_score
from ..ops.peaks import batched_peak_metrics


def ceiling_draws(
    data_cfg: DataConfig, generator: torch.Generator | None = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(freq, params, spectra_1, spectra_2) on the CPU: ``num_samples``
    cells, then two independent noise draws of them, from ``generator`` (a
    CPU generator; seeded with 0 when None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    freq = data_cfg.frequencies
    params = sample_params(generator, data_cfg.num_samples, data_cfg, device="cpu")
    spectra = [synthesize_spectra(freq, params, generator, data_cfg.noise_level)
               for _ in range(2)]
    return freq, params, spectra[0], spectra[1]


def ceilings_from_draws(
    freq: torch.Tensor,
    params: torch.Tensor,
    spectra_1: torch.Tensor,
    spectra_2: torch.Tensor,
    noise_level: float,
) -> Tuple[Dict[str, float], Tuple[torch.Tensor, torch.Tensor]]:
    """The ceilings from two noise draws of the same cells, computed where
    ``params`` and the spectra lie; returns them with the two draws' (N, 8)
    metrics."""
    c1, c2 = dip_centers(params)
    metrics = tuple(batched_peak_metrics(freq, spec, fallback_f1=c1, fallback_f2=c2)
                    for spec in (spectra_1, spectra_2))
    lo, hi = metric_ranges_from_data(metrics[0])
    c_spec = float(r2_score(spectra_1, spectra_2))
    c_met = float(r2_score(normalize_metrics(metrics[0], lo, hi),
                           normalize_metrics(metrics[1], lo, hi)))
    return {
        "draw_to_draw_spectrum_r2": c_spec,
        "draw_to_draw_metrics_r2": c_met,
        "spectrum_r2_ceiling": (1.0 + c_spec) / 2.0,
        "metrics_r2_ceiling": (1.0 + c_met) / 2.0,
        # E||noisy - recon||^2 >= sigma^2 for ANY model (the additive noise
        # is independent of the reconstruction): the cycle-error target of
        # 0.005 is unreachable against noisy targets whenever sigma^2 > 0.005
        "cycle_error_floor": float(noise_level) ** 2,
        "noise_level": float(noise_level),
    }, metrics


def noise_ceilings(
    data_cfg: DataConfig, generator: torch.Generator | None = None, *,
    device: torch.device | str,
) -> Dict[str, float]:
    """(1+c)/2 achievable-R2 ceilings from two independent noise draws of
    the same cells at the configured noise level, computed on ``device``."""
    draws = ceiling_draws(data_cfg, generator)
    return ceilings_from_draws(*(t.to(device) for t in draws), data_cfg.noise_level)[0]


def oracle_validation(evaluator, ds: ThzDataset) -> Dict[str, Any]:
    """Score the trained models against the NOISE-FREE truth of the same
    cells (valid only for oracle-generated datasets): pooled surrogate R2
    vs clean spectra, and the F∘G cycle error vs clean + vs noisy."""
    clean = synthesize_spectra(ds.frequencies, ds.params, generator=None)
    surrogate_spec, _ = evaluator._f(ds.params_norm)
    recon, _ = evaluator._f(evaluator._g(ds.spectra))
    # POOLED R2 vs truth: clean spectra have near-zero variance in the flat
    # regions, so per-column averaging (the reference evaluator's convention
    # for noisy targets) degenerates to huge negatives on a clean target
    out = {
        "surrogate_spectrum_r2_vs_truth": r2_pooled(clean, surrogate_spec),
        "surrogate_spectrum_r2_vs_noisy": r2_pooled(ds.spectra, surrogate_spec),
        "cycle_error_vs_truth": torch.mean((clean - recon) ** 2),
        "cycle_error_vs_noisy": torch.mean((ds.spectra - recon) ** 2),
    }
    return {k: float(v) for k, v in out.items()}
