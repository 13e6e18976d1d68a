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

The enhanced forward models (``pigan_thz_tpu/models/forward_model.py``,
reference enhanced_forward_model.py), LayerNorm + ReLU MLPBlocks with the
JAX classes' own dropout rates:
- ``BranchedForwardModel``: a shared 128 / 256 / 512 trunk, then a
  1024 / 2048 / 1024 spectrum branch and a 256 / 128 / 64 metrics branch;
- ``PhysicsForwardModel``: a 64 / 128 / 256 / 512 trunk, self-attention
  over the single token (8 heads of 64), then a 1024 / 2048 / 1024 spectrum
  branch and a 256 / 128 metrics branch;
- ``UncertaintyForwardModel``: a 256 / 512 / 1024 trunk and four heads,
  returning (spectrum mean, metrics mean, spectrum variance, metrics
  variance), the variances through softplus; ``sample_predictions`` draws
  from that Gaussian with an explicit generator.
Every consumer reads ``out[0]`` and ``out[1]``, so each variant serves as F.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .blocks import Dense, FlaxMapped, SelfAttention, compute_dtype_of, mlp_block


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


class BranchedForwardModel(FlaxMapped):
    def __init__(self, param_dim: int = 4, spectrum_dim: int = 250, metrics_dim: int = 8,
                 compute_dtype: str = "float32"):
        super().__init__()
        dt = compute_dtype_of(compute_dtype)
        blocks = _BlockPairer(self, dt)
        self.trunk = nn.Sequential(*blocks.chain(param_dim, ((128, 0.2), (256, 0.2),
                                                             (512, 0.2))))
        self.spectrum = nn.Sequential(
            *blocks.chain(512, ((1024, 0.3), (2048, 0.3), (1024, 0.2))),
            self._pair(Dense(1024, spectrum_dim, dt), "Dense_0"))
        self.metrics = nn.Sequential(
            *blocks.chain(512, ((256, 0.2), (128, 0.2), (64, 0.1))),
            self._pair(Dense(64, metrics_dim, dt), "Dense_1"))

    def forward(self, params_norm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.trunk(params_norm)
        return self.spectrum(x), self.metrics(x)


class PhysicsForwardModel(FlaxMapped):
    def __init__(self, param_dim: int = 4, spectrum_dim: int = 250, metrics_dim: int = 8,
                 compute_dtype: str = "float32"):
        super().__init__()
        dt = compute_dtype_of(compute_dtype)
        blocks = _BlockPairer(self, dt)
        self.trunk = nn.Sequential(*blocks.chain(
            param_dim, ((64, None), (128, None), (256, 0.2), (512, 0.2))))
        # self-attention over the single token (enhanced_forward_model.py:156-175)
        self.attention = self._pair_child(SelfAttention(512, 8, compute_dtype=dt),
                                          "SelfAttention_0")
        self.spectrum = nn.Sequential(
            *blocks.chain(512, ((1024, 0.3), (2048, 0.3), (1024, 0.2))),
            self._pair(Dense(1024, spectrum_dim, dt), "Dense_0"))
        self.metrics = nn.Sequential(
            *blocks.chain(512, ((256, 0.2), (128, 0.2))),
            self._pair(Dense(128, metrics_dim, dt), "Dense_1"))

    def forward(self, params_norm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.attention(self.trunk(params_norm)[:, None, :])[:, 0, :]
        return self.spectrum(x), self.metrics(x)


class UncertaintyForwardModel(FlaxMapped):
    """(spec_mean, met_mean, spec_var, met_var), the variances through
    softplus, in train and eval mode alike (the JAX package's arity)."""

    def __init__(self, param_dim: int = 4, spectrum_dim: int = 250, metrics_dim: int = 8,
                 compute_dtype: str = "float32"):
        super().__init__()
        dt = compute_dtype_of(compute_dtype)
        blocks = _BlockPairer(self, dt)
        self.trunk = nn.Sequential(*blocks.chain(param_dim, ((256, 0.2), (512, 0.2),
                                                             (1024, 0.2))))
        heads = []
        for j, (feat, drop, out) in enumerate(((2048, 0.3, spectrum_dim),
                                               (1024, 0.2, spectrum_dim),
                                               (256, 0.2, metrics_dim),
                                               (128, 0.1, metrics_dim))):
            heads.append(nn.Sequential(*blocks.chain(1024, ((feat, drop),)),
                                       self._pair(Dense(feat, out, dt), f"Dense_{j}")))
        self.spectrum_mean, self.spectrum_var, self.metrics_mean, self.metrics_var = heads

    def forward(self, params_norm: torch.Tensor):
        x = self.trunk(params_norm)
        return (self.spectrum_mean(x), self.metrics_mean(x),
                F.softplus(self.spectrum_var(x)), F.softplus(self.metrics_var(x)))


class _BlockPairer:
    """Builds LayerNorm + ReLU MLPBlocks for ``owner``, numbered as flax
    numbers them (``MLPBlock_0``, ``MLPBlock_1`` ... in build order)."""

    def __init__(self, owner: FlaxMapped, dt):
        self.owner, self.dt, self.count = owner, dt, 0

    def chain(self, d_in: int, spec) -> list[nn.Module]:
        layers: list[nn.Module] = []
        for feat, drop in spec:
            layers += self.owner._pair_block(
                mlp_block(d_in, feat, norm="layer", act="relu", dropout_rate=drop,
                          compute_dtype=self.dt), f"MLPBlock_{self.count}")
            self.count += 1
            d_in = feat
        return layers


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
    as flax's Dropout does; the rest of the model runs in eval mode.  A
    layer whose mask is shared by the batch (attention weights) draws one
    mask a sample, as each of the JAX package's vmapped draws does.  The
    masks are not the JAX package's (threefry there, Philox here): only
    their statistics agree.  The module is left in the mode it came in."""
    b = params_norm.shape[0]
    x = params_norm.repeat(num_samples, *(1,) * (params_norm.dim() - 1))

    def drop(module, inputs, output):
        keep = 1.0 - module.p
        if module.p == 0.0:
            return output
        if 0 in getattr(module, "shared_dims", ()):
            shape = (num_samples, *module.mask_shape(output)[1:])
            mask = torch.rand(shape, generator=generator, device=output.device) < keep
            mask = mask.repeat_interleave(b, dim=0)
        else:
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


@torch.no_grad()
def sample_predictions(
    model: nn.Module,
    params_norm: torch.Tensor,
    generator: torch.Generator,
    num_samples: int = 100,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Monte-Carlo samples from the uncertainty model's predictive Gaussian:
    (spectra (N, B, S), metrics (N, B, M)), mean + sqrt(var) · ε with ε
    drawn from ``generator`` (spectra first, then metrics; on the rows'
    device).  The port of
    ``pigan_thz_tpu/models/forward_model.py:sample_predictions``; its draws
    are threefry's, these Philox's, so only their statistics agree.  The
    model runs in eval mode and is left in the mode it came in."""
    was_training = model.training
    model.eval()
    try:
        spec_mean, met_mean, spec_var, met_var = model(params_norm)
    finally:
        model.train(was_training)
    dev = params_norm.device
    eps_s = torch.randn((num_samples, *spec_mean.shape), generator=generator, device=dev)
    eps_m = torch.randn((num_samples, *met_mean.shape), generator=generator, device=dev)
    return spec_mean + torch.sqrt(spec_var) * eps_s, met_mean + torch.sqrt(met_var) * eps_m
