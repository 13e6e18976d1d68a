"""Forward surrogate: normalized params (4) -> (spectrum 250, metrics 8).

``ForwardMLP`` is the baseline 4->256->512->1024->512->256->(250+8) chain,
LayerNorm+LeakyReLU(0.2)+Dropout(0.2) per block and a linear split head
(reference forward_model.py:28-76;
``pigan_thz_tpu/models/forward_model.py:ForwardMLP``).  Its ``model``
Sequential carries the reference's torch layout: block i is
``model.{4i}`` Linear, ``model.{4i+1}`` LayerNorm, then LeakyReLU and
Dropout; the head is ``model.20``.

Dropout doubles as MC-dropout uncertainty (reference forward_model.py:33):
``mc_dropout_predict`` draws stochastic forward passes with masks from an
explicit ``torch.Generator``.

The enhanced forward models (branched, physics, uncertainty) are not
ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .blocks import Dense, compute_dtype_of, mlp_block


class ForwardMLP(nn.Module):
    def __init__(
        self,
        param_dim: int = 4,
        spectrum_dim: int = 250,
        metrics_dim: int = 8,
        hidden_dims: Sequence[int] = (256, 512, 1024, 512, 256),
        dropout_rate: float = 0.2,
        leaky_slope: float = 0.2,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        dt = compute_dtype_of(compute_dtype)
        self.spectrum_dim = spectrum_dim
        layers: list[nn.Module] = []
        d = param_dim
        for h in hidden_dims:
            layers += mlp_block(
                d, h, norm="layer", act="leaky_relu", leaky_slope=leaky_slope,
                dropout_rate=dropout_rate, compute_dtype=dt,
            )
            d = h
        layers.append(Dense(d, spectrum_dim + metrics_dim, dt))
        self.model = nn.Sequential(*layers)

    def forward(self, params_norm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        out = self.model(params_norm)
        return out[..., : self.spectrum_dim], out[..., self.spectrum_dim :]


@torch.no_grad()
def mc_dropout_predict(
    model: nn.Module,
    params_norm: torch.Tensor,
    generator: torch.Generator,
    num_samples: int = 100,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """MC-dropout uncertainty: ``num_samples`` stochastic forward passes of
    ``model`` on ``params_norm`` (B, P), returning (spectrum_mean,
    spectrum_std, metrics_mean, metrics_std), the std over samples with
    divisor N (``jnp.std``'s).

    The port of ``pigan_thz_tpu/models/forward_model.py:mc_dropout_predict``.
    The samples run as one batched pass of N x B rows (the counterpart of
    its vmap; exact, since the model normalises by rows).  Each
    ``nn.Dropout`` of rate p > 0 draws its keep mask from ``generator``
    (on the rows' device) and keeps ``x / (1 - p)`` where the mask is set,
    as flax's Dropout does; the rest of the model runs in eval mode.  The
    masks are not the JAX package's (threefry there, Philox here): only
    their statistics agree.  The module is left in the mode it came in."""
    b = params_norm.shape[0]
    x = params_norm.repeat(num_samples, *(1,) * (params_norm.dim() - 1))

    def drop(module, inputs, output):
        keep = 1.0 - module.p
        if module.p == 0.0:
            return output
        mask = torch.rand(output.shape, generator=generator, device=output.device) < keep
        return torch.where(mask, output / keep, torch.zeros_like(output))

    was_training = model.training
    hooks = [m.register_forward_hook(drop) for m in model.modules()
             if isinstance(m, nn.Dropout)]
    model.eval()
    try:
        spec, met = model(x)[:2]
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    # the statistics in float64: a mean of N equal float32 values is then
    # that value exactly, and their std exactly 0 (dropout 0)
    spec = spec.double().reshape(num_samples, b, -1)
    met = met.double().reshape(num_samples, b, -1)
    return tuple(t.float() for t in (spec.mean(dim=0), spec.std(dim=0, correction=0),
                                     met.mean(dim=0), met.std(dim=0, correction=0)))
