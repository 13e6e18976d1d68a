"""Forward surrogate: normalized params (4) -> (spectrum 250, metrics 8).

``ForwardMLP`` is the baseline 4->256->512->1024->512->256->(250+8) chain,
LayerNorm+LeakyReLU(0.2)+Dropout(0.2) per block and a linear split head
(reference forward_model.py:28-76;
``pigan_thz_tpu/models/forward_model.py:ForwardMLP``).  Its ``model``
Sequential carries the reference's torch layout: block i is
``model.{4i}`` Linear, ``model.{4i+1}`` LayerNorm, then LeakyReLU and
Dropout; the head is ``model.20``.

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
