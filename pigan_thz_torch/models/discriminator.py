"""Discriminator: (spectrum, physical params) -> real/fake logit.

``MLPDiscriminator`` is the baseline concat MLP 254->512->256->1 with
LeakyReLU(0.2) and no norm or dropout (reference discriminator.py:21-28;
``pigan_thz_tpu/models/discriminator.py:MLPDiscriminator``).  It returns
logits: the reference's closing ``nn.Sigmoid`` + ``BCELoss`` is
``ops.losses.bce_logits`` here, and ``torch.sigmoid(logits)`` wherever the
reference reads probabilities.  Its ``main`` Sequential carries the
reference's torch layout: Linear at ``main.0``, ``main.2``, ``main.4``.

The enhanced discriminators (dual encoder, conv, multi-scale) are not
ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .blocks import Dense, compute_dtype_of


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
