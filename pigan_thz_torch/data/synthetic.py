"""Synthetic THz metamaterial spectrum generator (batched, torch).

The oracle of ``pigan_thz_tpu/data/synthetic.py``: two Gaussian absorption
dips whose centre / depth / width are linear in the structural parameters
(r1, r2, w, g), a tanh high-frequency roll-off, a linear offset, additive
Gaussian noise, and a clamp at 0 dB (reference
``core/utils/data_loader.py:62-111``).  Randomness comes from an explicit
``torch.Generator``; it cannot reproduce JAX's threefry draws, so tests
feed both packages the same numpy inputs and compare noise statistics only.

``generate_dataset`` adds the eight metrics of each spectrum through the
peak analysis (``ops/peaks.py``: the dip-qualification kernel on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import DataConfig
from ..ops.peaks import batched_peak_metrics

# Model constants (data_loader.py:64-77).
_C1_BASE, _C1_R1, _C1_W = 0.870, 0.05, 0.03
_D1_BASE, _D1_R2, _D1_G = -12.657, 1.5, -1.0
_W1_BASE, _W1_R1 = 0.08, 0.02
_C2_BASE, _C2_R2, _C2_G = 2.115, 0.07, 0.04
_D2_BASE, _D2_R1, _D2_W = -11.763, 1.0, -0.8
_W2_BASE, _W2_R2 = 0.15, 0.03
_PARAM_CENTER = 2.5


class SyntheticBatch(NamedTuple):
    """Raw (physical-unit) synthetic samples, all on one device."""

    spectra: torch.Tensor   # (B, N) transmission in dB, <= 0
    params: torch.Tensor    # (B, 4) physical units (r1, r2, w, g)
    metrics: torch.Tensor   # (B, 8) f1,f2,Q1,FoM1,S1,Q2,FoM2,S2 (NaN allowed)


def dip_centers(params: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Expected resonance centres for fallback f1/f2 (data_loader.py:64,69)."""
    r1, r2, w, g = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    c1 = _C1_BASE + (r1 - _PARAM_CENTER) * _C1_R1 + (w - _PARAM_CENTER) * _C1_W
    c2 = _C2_BASE + (r2 - _PARAM_CENTER) * _C2_R2 + (g - _PARAM_CENTER) * _C2_G
    return c1, c2


def synthesize_spectra(
    freq: torch.Tensor,
    params: torch.Tensor,
    generator: torch.Generator | None = None,
    noise_level: float = 0.1,
    apply_offset: bool = True,
) -> torch.Tensor:
    """(B, 4) physical params -> (B, N) dB spectra on ``params.device``.
    Noise is drawn only when a ``generator`` (on that device) is given."""
    r1, r2, w, g = (params[:, i : i + 1] for i in range(4))
    f = freq.to(params.device)[None, :]

    c1, c2 = dip_centers(params)
    c1, c2 = c1[:, None], c2[:, None]
    d1 = _D1_BASE + (r2 - _PARAM_CENTER) * _D1_R2 + (g - _PARAM_CENTER) * _D1_G
    w1 = _W1_BASE + ((r1 - _PARAM_CENTER) * _W1_R1).abs()
    d2 = _D2_BASE + (r1 - _PARAM_CENTER) * _D2_R1 + (w - _PARAM_CENTER) * _D2_W
    w2 = _W2_BASE + ((r2 - _PARAM_CENTER) * _W2_R2).abs()

    t = d1 * torch.exp(-((f - c1) ** 2) / (2.0 * w1**2))
    t = t + d2 * torch.exp(-((f - c2) ** 2) / (2.0 * w2**2))
    t = t - 0.5 * (torch.tanh((f - 1.5) * 2.0) + 1.0)   # roll-off (dl.py:74)
    if apply_offset:
        t = t + (-0.5 + 0.5 * (f / 3.0))                  # offset (dl.py:76)
    if generator is not None and noise_level > 0.0:
        t = t + noise_level * torch.randn(
            t.shape, generator=generator, dtype=t.dtype, device=t.device
        )
    return t.clamp(max=0.0)                                # clamp (dl.py:80)


def sample_params(
    generator: torch.Generator, n: int, cfg: DataConfig,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Uniform physical parameters in [param_min, param_max]^4, float32 on
    ``device`` (where ``generator`` must live too)."""
    u = torch.rand(
        (n, cfg.param_dim), generator=generator, dtype=torch.float32, device=device
    )
    return cfg.param_min + (cfg.param_max - cfg.param_min) * u


def generate_dataset(
    generator: torch.Generator,
    n: int,
    cfg: DataConfig,
    with_noise: bool = True,
    *,
    device: torch.device | str,
) -> SyntheticBatch:
    """n synthetic samples on ``device``, the counterpart of
    ``pigan_thz_tpu/data/synthetic.py:generate_dataset``: params, then the
    noise, drawn from ``generator`` (which lives on ``device``); metrics
    from the peak analysis with the expected centres as fallbacks."""
    freq = cfg.frequencies.to(device)
    params = sample_params(generator, n, cfg, device=device)
    spectra = synthesize_spectra(
        freq, params, generator if with_noise else None, cfg.noise_level
    )
    c1, c2 = dip_centers(params)
    metrics = batched_peak_metrics(freq, spectra, fallback_f1=c1, fallback_f2=c2)
    return SyntheticBatch(spectra=spectra, params=params, metrics=metrics)
