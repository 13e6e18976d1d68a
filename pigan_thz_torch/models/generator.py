"""Generator: spectrum (250) -> normalized structural params (4), tanh head.

``MLPGenerator`` is the baseline 250->512->256->4 generator with
BatchNorm+ReLU blocks (reference generator.py:17-26;
``pigan_thz_tpu/models/generator.py:MLPGenerator``).  Its ``main``
Sequential carries the reference's torch layout: Linear at ``main.0``,
``main.3``, ``main.6``, BatchNorm at ``main.1`` and ``main.4``.

The enhanced generators (``pigan_thz_tpu/models/generator.py``, reference
enhanced_generator.py):
- ``ResidualGenerator``: 250 -> 512 (MLPBlock), N residual blocks of 512,
  then 256 (dropout 0.3) and 128 (dropout 0.2) MLPBlocks, Dense -> 4, tanh;
- ``ConvAttnGenerator``: the conv pyramid to 32 tokens of 256, optional
  8-head self-attention over the tokens, the flattened 8192 through
  1024 / 512 / 256 / 128 MLPBlocks (dropout 0.3 / 0.3 / 0.2 / 0.2), Dense
  -> 4, tanh.
The dropout rates are the JAX classes' own constants.  Both record their
flax layer map (``blocks.FlaxMapped``) for ``interop.py``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .blocks import (ConvStack1D, Dense, FlaxMapped, ResidualBlock, SelfAttention,
                     compute_dtype_of, mlp_block)


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


class ResidualGenerator(FlaxMapped):
    def __init__(
        self,
        input_dim: int = 250,
        output_dim: int = 4,
        num_residual_blocks: int = 3,
        norm: str = "batch",
        compute_dtype: str = "float32",
    ):
        super().__init__()
        dt = compute_dtype_of(compute_dtype)
        layers = self._pair_block(
            mlp_block(input_dim, 512, norm=norm, act="relu", compute_dtype=dt), "MLPBlock_0")
        for i in range(num_residual_blocks):
            layers.append(self._pair_child(ResidualBlock(512, norm=norm, compute_dtype=dt),
                                           f"ResidualBlock_{i}"))
        d = 512
        for j, (feat, drop) in enumerate(((256, 0.3), (128, 0.2)), start=1):
            layers += self._pair_block(
                mlp_block(d, feat, norm=norm, act="relu", dropout_rate=drop, compute_dtype=dt),
                f"MLPBlock_{j}")
            d = feat
        layers += [self._pair(Dense(d, output_dim, dt), "Dense_0"), nn.Tanh()]
        self.main = nn.Sequential(*layers)

    def forward(self, spectrum: torch.Tensor) -> torch.Tensor:
        return self.main(spectrum.reshape(spectrum.shape[0], -1))


class ConvAttnGenerator(FlaxMapped):
    def __init__(
        self,
        input_dim: int = 250,
        output_dim: int = 4,
        use_attention: bool = True,
        norm: str = "batch",
        compute_dtype: str = "float32",
    ):
        super().__init__()
        dt = compute_dtype_of(compute_dtype)
        self.convs = self._pair_child(ConvStack1D(pool_to=32, norm=norm, compute_dtype=dt),
                                      "ConvStack1D_0")
        self.attention = (self._pair_child(SelfAttention(256, 8, compute_dtype=dt),
                                           "SelfAttention_0") if use_attention else None)
        layers: list[nn.Module] = []
        d = 32 * self.convs.channels
        for j, (feat, drop) in enumerate(((1024, 0.3), (512, 0.3), (256, 0.2), (128, 0.2))):
            layers += self._pair_block(
                mlp_block(d, feat, norm=norm, act="relu", dropout_rate=drop, compute_dtype=dt),
                f"MLPBlock_{j}")
            d = feat
        layers += [self._pair(Dense(d, output_dim, dt), "Dense_0"), nn.Tanh()]
        self.head = nn.Sequential(*layers)

    def forward(self, spectrum: torch.Tensor) -> torch.Tensor:
        tokens = self.convs(spectrum.reshape(spectrum.shape[0], -1))    # (B, 32, 256)
        if self.attention is not None:
            tokens = self.attention(tokens)
        return self.head(tokens.reshape(tokens.shape[0], -1))
