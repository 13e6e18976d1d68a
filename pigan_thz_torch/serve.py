"""Model serving: the in-process inverse-design cycle.

``make_inverse_design_fn`` is the port of
``pigan_thz_tpu/serve.py:make_inverse_design_fn`` on its fused path:
spectra (B, S) -> generator -> normalised params (B, 4) -> frozen forward
surrogate -> (spectrum (B, S), metrics (B, 8)), and the params denormalised
to physical units.  Both models run through the fused kernels of
``ops/fused_kernels.py``: on the card that is one CUDA kernel launch per
model, on the CPU their plain PyTorch versions.  The modules' own
eval-mode ``forward`` is the unfused reference the tests compare against.

``make_ensemble_inverse_design_fn`` is the port of the ensemble-mean cycle
(``pigan_thz_tpu/serve.py:make_ensemble_inverse_design_fn``): the mean of N
seed-ensemble members' normalised predictions, then F on the mean.  The JAX
package computes it outside any Pallas kernel (one vmap over the members),
and so does the port: plain PyTorch, the members' eval-mode forwards.

Not ported yet (ROADMAP.md, queue 1, item 13): the bf16 and int8 serving
dtypes and exported artifacts (``export_ensemble_inverse_design`` with them).
"""

from __future__ import annotations

import copy
from typing import Callable, Sequence

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


def make_ensemble_inverse_design_fn(
    generators: Sequence[nn.Module],
    forward_model: nn.Module,
    ds: ThzDataset,
    compute_dtype=None,
) -> InverseDesignFn:
    """Ensemble-mean serving: spectra (B, S) float32 on the device of ``ds``
    -> (params_phys (B, 4), recon_spectrum (B, S), metrics (B, 8)).

    ``generators`` are the members' G modules (``[st.g for st in states]`` of
    an ``EnsembleState``; ``parallel/ensemble.py:evaluate_ensemble_mean`` is
    the scoring twin of this path).  Each member predicts in eval mode, its
    BatchNorm on its own running stats; the normalised predictions are
    averaged in fp32, denormalised, and ``forward_model`` reconstructs the
    spectrum and metrics of the mean.  The members' weights and stats are
    read once, here, onto the device of ``ds``; later training is not seen.
    Plain PyTorch on either device, as the JAX package's is plain XLA."""
    if compute_dtype is not None:
        raise NotImplementedError(
            "the port serves fp32 only; bf16 / int8 serving is ROADMAP.md "
            "queue 1, item 13"
        )
    generators = list(generators)
    if not generators:
        raise ValueError("make_ensemble_inverse_design_fn: no member generators")
    device = ds.param_lo.device
    # one eval-mode skeleton and every member's tensors: a member bound to a
    # stacked buffer is read through its state_dict, not deep-copied
    members = [{k: v.detach().to(device, copy=True) for k, v in g.state_dict().items()}
               for g in generators]
    skeleton = copy.deepcopy(generators[0]).to(device).eval()
    f = copy.deepcopy(forward_model).to(device).eval()
    lo, hi = ds.param_lo, ds.param_hi

    @torch.inference_mode()
    def fn(spectra: torch.Tensor):
        preds = torch.stack([torch.func.functional_call(skeleton, sd, (spectra,))
                             for sd in members])                    # (N, B, 4)
        mean_norm = preds.to(torch.float32).mean(dim=0)
        spec, met = f(mean_norm)[:2]
        return (denormalize_params(mean_norm, lo, hi), spec.to(torch.float32),
                met.to(torch.float32))

    return fn
