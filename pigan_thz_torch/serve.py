"""Model serving: the in-process inverse-design cycle.

``make_inverse_design_fn`` is the port of
``pigan_thz_tpu/serve.py:make_inverse_design_fn`` on its fused path:
spectra (B, S) -> generator -> normalised params (B, 4) -> frozen forward
surrogate -> (spectrum (B, S), metrics (B, 8)), and the params denormalised
to physical units.  Both models run through the fused kernels of
``ops/fused_kernels.py``: on the card that is one CUDA kernel launch per
model, on the CPU their plain PyTorch versions.  The modules' own
eval-mode ``forward`` is the unfused reference the tests compare against.

Not ported yet (ROADMAP.md, queue 1, item 13): the bf16 and int8 serving
dtypes, the ensemble-mean cycle and exported artifacts.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from .data.dataset import ThzDataset, denormalize_params
from .ops.fused_kernels import (
    forward_surrogate_fused,
    generator_fused,
    pack_forward_model,
    pack_generator,
)

InverseDesignFn = Callable[
    [torch.Tensor], tuple[torch.Tensor, torch.Tensor, torch.Tensor]
]


def make_inverse_design_fn(
    generator: nn.Module,
    forward_model: nn.Module,
    ds: ThzDataset,
    compute_dtype=None,
) -> InverseDesignFn:
    """Serving callable: spectra (B, S) float32, contiguous, on the device of
    ``ds`` -> (params_phys (B, 4), recon_spectrum (B, S), metrics (B, 8)).

    The weights are read (and the generator's BatchNorm folded) once, here,
    onto the device of ``ds``; later changes to the modules are not seen.
    Baseline MLP trio only: other layouts raise."""
    if compute_dtype is not None:
        raise NotImplementedError(
            "the port serves fp32 only; bf16 / int8 serving is ROADMAP.md "
            "queue 1, item 13"
        )
    device = ds.param_lo.device
    g_packed = pack_generator(generator, device)
    f_packed = pack_forward_model(forward_model, device)
    lo, hi, spectrum_dim = ds.param_lo, ds.param_hi, ds.spectrum_dim

    @torch.inference_mode()
    def fn(spectra: torch.Tensor):
        pn = generator_fused(g_packed, spectra)
        spec, met = forward_surrogate_fused(f_packed, pn, spectrum_dim=spectrum_dim)
        return denormalize_params(pn, lo, hi), spec, met

    return fn
