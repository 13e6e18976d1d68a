"""Inverse design API: spectrum -> structural parameters.

The port of ``pigan_thz_tpu/design/inverse.py``: the generator's prediction
and the frozen forward surrogate's check packaged as one object, plus
gradient refinement through the differentiable surrogate.  From the
generator's prediction, Adam runs on the normalised parameters (in atanh
space, so tanh keeps every iterate in (-1, 1)) to minimise the spectrum
match plus the Maxwell smoothness term through the frozen, eval-mode
surrogate; autograd differentiates with respect to the parameters only.

    designer = InverseDesigner(g, f, ds)
    out = designer.design(spectrum)                     # G prediction + F check
    out = designer.design(spectrum, refine_steps=200)   # + refinement
    mean, std, _, _ = designer.uncertainty(spectrum, torch.Generator(device=...))

Batched over spectra.  Plain PyTorch, as the JAX designer is plain XLA: no
kernel of the port runs here.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import torch
from torch import nn

from ..data.dataset import ThzDataset, denormalize_params
from ..models.forward_model import mc_dropout_predict
from ..ops import losses as L

# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class DesignResult(NamedTuple):
    params: torch.Tensor          # (B, 4) physical units
    params_norm: torch.Tensor     # (B, 4) in [-1, 1]
    pred_spectrum: torch.Tensor   # (B, S) surrogate spectrum of the design
    spectrum_mse: torch.Tensor    # (B,) match quality vs the target
    pred_metrics: torch.Tensor    # (B, 8) surrogate metric head (normalised)


def _frozen(module: nn.Module, device) -> nn.Module:
    return copy.deepcopy(module).to(device).eval().requires_grad_(False)


class InverseDesigner:
    """G and F are copied (eval mode, frozen) onto the device of ``ds`` at
    construction; later training of the modules is not seen."""

    def __init__(
        self,
        generator: nn.Module,
        forward_model: nn.Module,
        ds: ThzDataset,
        refine_lr: float = 0.02,
        maxwell_w: float = 0.1,
    ):
        self.ds = ds
        device = ds.param_lo.device
        self.generator = _frozen(generator, device)
        self.forward_model = _frozen(forward_model, device)
        self.refine_lr = refine_lr
        self.maxwell_w = maxwell_w

    def _predict(self, spectra: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.generator(spectra)

    def _refine(self, spectra: torch.Tensor, pn: torch.Tensor, steps: int) -> torch.Tensor:
        """``steps`` of optax's adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
        bias-corrected moments) on z = atanh(clip(pn, ±0.999))."""
        z = torch.arctanh(torch.clamp(pn, -0.999, 0.999))
        mu, nu = torch.zeros_like(z), torch.zeros_like(z)
        for t in range(1, steps + 1):
            z = z.detach().requires_grad_(True)
            spec = self.forward_model(torch.tanh(z))[0]
            loss = L.mse(spec, spectra) + self.maxwell_w * L.maxwell_smoothness_loss(spec)
            (grad,) = torch.autograd.grad(loss, z)
            with torch.no_grad():
                mu = (1.0 - ADAM_B1) * grad + ADAM_B1 * mu
                nu = (1.0 - ADAM_B2) * grad * grad + ADAM_B2 * nu
                mu_hat = mu / (1.0 - ADAM_B1 ** t)
                nu_hat = nu / (1.0 - ADAM_B2 ** t)
                z = z + -self.refine_lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
        return torch.tanh(z.detach())

    def design(self, spectra: torch.Tensor, refine_steps: int = 0) -> DesignResult:
        """Spectra (B, S) or one spectrum (S,) -> the design(s): G's
        prediction, refined for ``refine_steps`` Adam steps when > 0, then
        F's spectrum, metrics and the per-row spectrum MSE."""
        single = spectra.dim() == 1
        if single:
            spectra = spectra[None, :]
        pn = self._predict(spectra)
        if refine_steps > 0:
            pn = self._refine(spectra, pn, refine_steps)
        with torch.no_grad():
            spec, met = self.forward_model(pn)[:2]
            out = DesignResult(
                params=denormalize_params(pn, self.ds.param_lo, self.ds.param_hi),
                params_norm=pn,
                pred_spectrum=spec,
                spectrum_mse=torch.mean((spec - spectra) ** 2, dim=-1),
                pred_metrics=met,
            )
        if single:
            out = DesignResult(*(t[0] for t in out))
        return out

    def uncertainty(
        self, spectra: torch.Tensor, generator: torch.Generator, num_samples: int = 64,
        params_norm: torch.Tensor | None = None,
    ):
        """MC-dropout spread of the surrogate at a design point:
        (spectrum_mean, spectrum_std, metrics_mean, metrics_std), each
        (B, ...).  By default the point is the raw generator prediction for
        ``spectra``; pass ``params_norm`` (e.g. ``design(...).params_norm``)
        to take the spread at a refined design.  The masks come from
        ``generator`` (a ``torch.Generator`` on the device of ``ds``)."""
        if spectra.dim() == 1:
            spectra = spectra[None, :]
        if params_norm is not None and params_norm.dim() == 1:
            params_norm = params_norm[None, :]
        pn = self._predict(spectra) if params_norm is None else params_norm
        return mc_dropout_predict(self.forward_model, pn, generator, num_samples=num_samples)
