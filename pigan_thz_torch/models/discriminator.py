"""Discriminator: (spectrum, physical params) -> real/fake logit.

``MLPDiscriminator`` is the baseline concat MLP 254->512->256->1 with
LeakyReLU(0.2) and no norm or dropout (reference discriminator.py:21-28;
``pigan_thz_tpu/models/discriminator.py:MLPDiscriminator``).  It returns
logits: the reference's closing ``nn.Sigmoid`` + ``BCELoss`` is
``ops.losses.bce_logits`` here, and ``torch.sigmoid(logits)`` wherever the
reference reads probabilities.  Its ``main`` Sequential carries the
reference's torch layout: Linear at ``main.0``, ``main.2``, ``main.4``.

The enhanced discriminators (``pigan_thz_tpu/models/discriminator.py``,
reference enhanced_discriminator.py), all returning logits:
- ``DualEncoderDiscriminator``: a spectrum encoder (512 / 256 / 128,
  dropout 0.3 / 0.3 / 0.2) and a parameter encoder (64 / 32, dropout 0.3 /
  0.2), their features concatenated through a fusion encoder (256 / 128 /
  64, dropout 0.4 / 0.3 / 0.2) and a Dense -> 1; LeakyReLU throughout, and
  with ``use_spectral_norm`` every Dense is flax's spectral-norm Dense
  (``blocks.SpectralDense``: ``u`` and ``sigma`` are D's batch_stats);
- ``ConvDiscriminator``: the conv pyramid (no norm, LeakyReLU) to 16
  tokens, flattened beside the parameter encoder, a 512 / 256 / 128 fusion
  encoder (dropout 0.4 / 0.3 / 0.2) and a Dense -> 1, no spectral norm;
- ``MultiScaleDiscriminator``: dual-encoder discriminators on the spectrum
  and on its half-scale version (the mean of sample pairs, 125 points),
  whose sigmoid scores a 2 -> 64 -> 1 MLP fuses into one logit.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .blocks import (ConvStack1D, Dense, Dropout, FlaxMapped, SpectralDense,
                     compute_dtype_of)


class MLPDiscriminator(nn.Module):
    def __init__(
        self,
        spectrum_dim: int = 250,
        param_dim: int = 4,
        hidden_dims: Sequence[int] = (512, 256),
        leaky_slope: float = 0.2,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        dt = compute_dtype_of(compute_dtype)
        layers: list[nn.Module] = []
        d = spectrum_dim + param_dim
        for h in hidden_dims:
            layers += [Dense(d, h, dt), nn.LeakyReLU(leaky_slope)]
            d = h
        layers.append(Dense(d, 1, dt))
        self.main = nn.Sequential(*layers)

    def forward(self, spectrum: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        b = spectrum.shape[0]
        x = torch.cat([spectrum.reshape(b, -1), params.reshape(b, -1)], dim=-1)
        return self.main(x)


class _Encoder(FlaxMapped):
    """A LeakyReLU + Dropout dense stack, spectral-norm Dense layers with
    ``use_spectral_norm`` (``pigan_thz_tpu/models/discriminator.py:_Encoder``)."""

    def __init__(self, in_features: int, dims: Sequence[int], drops: Sequence[float],
                 use_spectral_norm: bool = False, leaky_slope: float = 0.2,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        layers: list[nn.Module] = []
        d = in_features
        for i, (h, p) in enumerate(zip(dims, drops)):
            layers.append(_spectral_dense(self, d, h, use_spectral_norm, compute_dtype,
                                          f"SpectralDense_{i}"))
            layers.append(nn.LeakyReLU(leaky_slope))
            if p > 0:
                layers.append(Dropout(p))
            d = h
        self.main = nn.Sequential(*layers)
        self.out_features = d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x)


def _spectral_dense(owner: FlaxMapped, d_in: int, d_out: int, spectral: bool, dt,
                    path: str) -> nn.Module:
    """flax's ``SpectralDense`` at ``path``: with spectral norm its params
    sit at ``path/Dense_0`` and its stats at ``path/SpectralNorm_0/...``."""
    if spectral:
        return owner._pair(SpectralDense(d_in, d_out, dt), path, "spectral")
    return owner._pair(Dense(d_in, d_out, dt), f"{path}/Dense_0")


def _flatten(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


class DualEncoderDiscriminator(FlaxMapped):
    def __init__(
        self,
        spectrum_dim: int = 250,
        param_dim: int = 4,
        use_spectral_norm: bool = True,
        leaky_slope: float = 0.2,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        dt = compute_dtype_of(compute_dtype)
        sn = use_spectral_norm
        self.spec_encoder = self._pair_child(_Encoder(
            spectrum_dim, (512, 256, 128), (0.3, 0.3, 0.2), sn, leaky_slope, dt), "_Encoder_0")
        self.param_encoder = self._pair_child(_Encoder(
            param_dim, (64, 32), (0.3, 0.2), sn, leaky_slope, dt), "_Encoder_1")
        self.fusion = self._pair_child(_Encoder(
            128 + 32, (256, 128, 64), (0.4, 0.3, 0.2), sn, leaky_slope, dt), "_Encoder_2")
        self.head = _spectral_dense(self, 64, 1, sn, dt, "SpectralDense_0")

    def forward(self, spectrum: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        x = torch.cat([self.spec_encoder(_flatten(spectrum)),
                       self.param_encoder(_flatten(params))], dim=-1)
        return self.head(self.fusion(x))


class ConvDiscriminator(FlaxMapped):
    def __init__(
        self,
        spectrum_dim: int = 250,
        param_dim: int = 4,
        leaky_slope: float = 0.2,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        dt = compute_dtype_of(compute_dtype)
        self.convs = self._pair_child(ConvStack1D(
            pool_to=16, norm="none", act="leaky_relu", leaky_slope=leaky_slope,
            compute_dtype=dt), "ConvStack1D_0")
        self.param_encoder = self._pair_child(_Encoder(
            param_dim, (64, 32), (0.3, 0.2), False, leaky_slope, dt), "_Encoder_0")
        self.fusion = self._pair_child(_Encoder(
            16 * self.convs.channels + 32, (512, 256, 128), (0.4, 0.3, 0.2), False,
            leaky_slope, dt), "_Encoder_1")
        self.head = self._pair(Dense(128, 1, dt), "Dense_0")

    def forward(self, spectrum: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        spec = _flatten(self.convs(_flatten(spectrum)))
        x = torch.cat([spec, self.param_encoder(_flatten(params))], dim=-1)
        return self.head(self.fusion(x))


class MultiScaleDiscriminator(FlaxMapped):
    def __init__(
        self,
        spectrum_dim: int = 250,
        param_dim: int = 4,
        use_spectral_norm: bool = True,
        leaky_slope: float = 0.2,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        dt = compute_dtype_of(compute_dtype)
        self.full_scale = self._pair_child(DualEncoderDiscriminator(
            spectrum_dim, param_dim, use_spectral_norm, leaky_slope, compute_dtype),
            "full_scale")
        self.half_scale = self._pair_child(DualEncoderDiscriminator(
            spectrum_dim // 2, param_dim, use_spectral_norm, leaky_slope, compute_dtype),
            "half_scale")
        self.fuse = nn.Sequential(self._pair(Dense(2, 64, dt), "Dense_0"),
                                  nn.LeakyReLU(leaky_slope),
                                  self._pair(Dense(64, 1, dt), "Dense_1"))

    def forward(self, spectrum: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        spec = _flatten(spectrum)
        full = self.full_scale(spec, params)
        half_len = spec.shape[-1] // 2
        half = spec[:, : 2 * half_len].reshape(spec.shape[0], half_len, 2).mean(dim=-1)
        half_out = self.half_scale(half, params)
        scores = torch.cat([torch.sigmoid(full), torch.sigmoid(half_out)], dim=-1)
        return self.fuse(scores)
