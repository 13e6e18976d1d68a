"""Spectrum data augmentation: the port of ``pigan_thz_tpu/ops/augment.py``.

The reference declares augmentation knobs (noise_level 0.05,
frequency_shift 0.02, amplitude_scale 0.1;
config/training_optimization.py:103-107) that no trainer applies.  Here, as
in the JAX package, they are one vectorised transform for the training step:

- frequency shift: circular roll by a per-sample integer offset drawn from
  ± ``freq_shift`` of the spectrum length;
- amplitude scale: per-sample multiplicative jitter 1 ± ``amp_scale``;
- additive Gaussian noise (dB domain).

Spectra stay clamped to <= 0 dB like the synthetic generator's output.  The
draws come from a CPU ``torch.Generator`` (the step's), so one seed gives the
same augmentation on every device; they are not the JAX package's bits.
"""

from __future__ import annotations

import torch


def augment_spectra(
    generator: torch.Generator,
    spectra: torch.Tensor,
    noise_level: float = 0.05,
    freq_shift: float = 0.02,
    amp_scale: float = 0.1,
) -> torch.Tensor:
    """(B, N) -> (B, N) augmented copy; a knob set to 0 is off."""
    b, n = spectra.shape
    dev = spectra.device
    out = spectra
    if freq_shift > 0.0:
        max_shift = max(1, int(round(freq_shift * n)))
        shifts = torch.randint(-max_shift, max_shift + 1, (b,), generator=generator)
        idx = (torch.arange(n)[None, :] - shifts[:, None]) % n
        out = torch.gather(out, 1, idx.to(dev))
    if amp_scale > 0.0:
        u = torch.rand((b, 1), generator=generator) * 2.0 - 1.0
        out = out * (1.0 + amp_scale * u).to(dev)
    if noise_level > 0.0:
        out = out + (noise_level * torch.randn((b, n), generator=generator)).to(dev)
    return out.clamp(max=0.0)
