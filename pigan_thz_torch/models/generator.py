"""Generator: spectrum (250) -> normalized structural params (4), tanh head.

``MLPGenerator`` is the baseline 250->512->256->4 generator with
BatchNorm+ReLU blocks (reference generator.py:17-26;
``pigan_thz_tpu/models/generator.py:MLPGenerator``).  Its ``main``
Sequential carries the reference's torch layout: Linear at ``main.0``,
``main.3``, ``main.6``, BatchNorm at ``main.1`` and ``main.4``.

The enhanced generators (conv_attn, residual) are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .blocks import Dense, compute_dtype_of, mlp_block


class MLPGenerator(nn.Module):
    def __init__(
        self,
        input_dim: int = 250,
        output_dim: int = 4,
        hidden_dims: Sequence[int] = (512, 256),
        norm: str = "batch",
        compute_dtype: str = "float32",
    ):
        super().__init__()
        dt = compute_dtype_of(compute_dtype)
        layers: list[nn.Module] = []
        d = input_dim
        for h in hidden_dims:
            layers += mlp_block(d, h, norm=norm, act="relu", compute_dtype=dt)
            d = h
        layers += [Dense(d, output_dim, dt), nn.Tanh()]
        self.main = nn.Sequential(*layers)

    def forward(self, spectrum: torch.Tensor) -> torch.Tensor:
        return self.main(spectrum.reshape(spectrum.shape[0], -1))
