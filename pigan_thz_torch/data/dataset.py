"""Device-resident dataset and de/normalization for THz metamaterial data.

The pure functions and ``ThzDataset`` of ``pigan_thz_tpu/data/dataset.py``,
on torch tensors.  Reference behaviour (file:line under the reference repo):
- params normalized to [0,1] via hardcoded ranges then to [-1,1] for the GAN
  (data_loader.py:185-194);
- metrics min-max normalized to [0,1] with per-column ranges computed from the
  *valid* (non-NaN) entries, then NaN -> 0.5 (data_loader.py:198-219);
- denormalize_params maps [-1,1] -> physical (data_loader.py:238-252);
- denormalize_metrics maps [0,1] -> physical with NaN -> 0.0
  (data_loader.py:255-293);
- normalize_spectrum min-max -> [0,1], clamped (data_loader.py:298-329).

The whole dataset (1000 x 250 floats, about 1 MB) lives as tensors on one
device, named explicitly by the caller.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import DataConfig

# ---------------------------------------------------------------------------
# Pure normalization functions
# ---------------------------------------------------------------------------


def normalize_params(
    params: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
) -> torch.Tensor:
    """Physical -> [-1, 1] (data_loader.py:185-194)."""
    span = hi - lo
    ok = span > 1e-6
    unit = torch.where(ok, (params - lo) / torch.where(ok, span, 1.0), 0.5)
    return unit * 2.0 - 1.0


def denormalize_params(
    params_norm: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
) -> torch.Tensor:
    """[-1, 1] -> physical (data_loader.py:238-252)."""
    unit = (params_norm + 1.0) / 2.0
    return unit * (hi - lo) + lo


def metric_ranges_from_data(
    metrics: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-column (min, max) over non-NaN entries; (0, 1) if all-NaN
    (data_loader.py:200-211)."""
    valid = ~torch.isnan(metrics)
    any_valid = valid.any(dim=0)
    lo = torch.where(valid, metrics, torch.inf).amin(dim=0)
    hi = torch.where(valid, metrics, -torch.inf).amax(dim=0)
    lo = torch.where(any_valid, lo, 0.0)
    hi = torch.where(any_valid, hi, 1.0)
    return lo, hi


def normalize_metrics(
    metrics: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
) -> torch.Tensor:
    """Physical -> [0, 1]; zero-span columns -> 0.5; NaN -> 0.5
    (data_loader.py:213-219)."""
    span = hi - lo
    ok = span > 1e-6
    unit = torch.where(ok, (metrics - lo) / torch.where(ok, span, 1.0), 0.5)
    return torch.where(torch.isnan(unit), 0.5, unit)


def denormalize_metrics(
    metrics_norm: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
) -> torch.Tensor:
    """[0, 1] -> physical; zero-span -> lo; NaN -> 0.0 (data_loader.py:255-293)."""
    span = hi - lo
    out = torch.where(span > 1e-6, metrics_norm * span + lo, lo)
    return torch.where(torch.isnan(out), 0.0, out)


def normalize_spectrum(
    spectrum: torch.Tensor,
    global_min: float | torch.Tensor | None = None,
    global_max: float | torch.Tensor | None = None,
) -> torch.Tensor:
    """Min-max -> [0,1] clamped (data_loader.py:298-329)."""
    lo = spectrum.min() if global_min is None else torch.as_tensor(global_min)
    hi = spectrum.max() if global_max is None else torch.as_tensor(global_max)
    lo = lo.to(spectrum.device, spectrum.dtype)
    hi = hi.to(spectrum.device, spectrum.dtype)
    span = hi - lo
    ok = span > 1e-8
    out = torch.where(ok, (spectrum - lo) / torch.where(ok, span, 1.0), 0.5)
    return out.clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# Device-resident dataset
# ---------------------------------------------------------------------------


class ThzDataset(NamedTuple):
    """All tensors on one device.

    Mirrors the 5-tuple yielded by MetamaterialDataset.__getitem__
    (data_loader.py:227-234) plus the normalization statistics that the
    reference keeps as Python dict attributes (param_ranges, metric_ranges).
    """

    spectra: torch.Tensor        # (N, S) raw dB spectra
    params: torch.Tensor         # (N, 4) physical units
    params_norm: torch.Tensor    # (N, 4) in [-1, 1]
    metrics: torch.Tensor        # (N, 8) physical units (may contain NaN)
    metrics_norm: torch.Tensor   # (N, 8) in [0, 1], NaN -> 0.5
    param_lo: torch.Tensor       # (4,)
    param_hi: torch.Tensor       # (4,)
    metric_lo: torch.Tensor      # (8,)
    metric_hi: torch.Tensor      # (8,)
    frequencies: torch.Tensor    # (S,)

    @property
    def num_samples(self) -> int:
        return self.spectra.shape[0]

    @property
    def spectrum_dim(self) -> int:
        return self.spectra.shape[1]


def build_dataset(
    spectra,
    params,
    metrics,
    cfg: DataConfig,
    frequencies=None,
    *,
    device: torch.device | str,
) -> ThzDataset:
    """Normalise raw arrays (tensors or numpy) into a ``ThzDataset`` whose
    tensors all lie on ``device``.  ``frequencies`` overrides the config
    linspace (a CSV's actual Freq_* header values)."""

    def f32(a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a, dtype=np.float32))  # a copy
        return a.to(device=device, dtype=torch.float32)

    lo = torch.full((cfg.param_dim,), cfg.param_min, dtype=torch.float32, device=device)
    hi = torch.full((cfg.param_dim,), cfg.param_max, dtype=torch.float32, device=device)
    spectra, params, metrics = f32(spectra), f32(params), f32(metrics)
    mlo, mhi = metric_ranges_from_data(metrics)
    freq = f32(frequencies if frequencies is not None else cfg.frequencies)
    return ThzDataset(
        spectra=spectra,
        params=params,
        params_norm=normalize_params(params, lo, hi),
        metrics=metrics,
        metrics_norm=normalize_metrics(metrics, mlo, mhi),
        param_lo=lo,
        param_hi=hi,
        metric_lo=mlo,
        metric_hi=mhi,
        frequencies=freq,
    )
