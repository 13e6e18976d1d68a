"""Eager training steps: the port of ``pigan_thz_tpu/train/steps.py`` for
forward-surrogate pretraining.

``make_forward_step`` is one pretraining step with autograd: F's forward in
train mode, the loss of ``ForwardStepSettings``, the gradient, then the
optimiser (clip -> Adam -> schedule, ``schedules.ClipAdam``) on the state's
flat buffers in place.  Dropout takes its masks from the counter-based hash
of ``ops/forward_train.py`` keyed by the step's seed, so the eager step, the
plain version of the training kernel and the kernel see the same masks, and
nothing reads torch's global generator.  F's LayerNorms are torch's
``nn.LayerNorm`` here, which computes the variance in another order than
flax's one-pass form: a rounding difference only.

``make_multi_epoch_fn`` is the epoch loop as a Python loop, with the
contract of the JAX package's: per-epoch scales in, per-epoch mean metric
rows out.  The PI-GAN step and its ``StepSettings`` come with the GAN slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Sequence

import torch
from torch import nn

from ..data.dataset import ThzDataset, gather_batch
from ..ops import losses as L
from ..ops.forward_train import METRIC_KEYS, dropout_scale, resolve_draws
from .schedules import ClipAdam
from .state import ForwardState

Batch = tuple  # (spectra, params, params_norm, metrics, metrics_norm)


@dataclass(frozen=True)
class ForwardStepSettings:
    """Forward-surrogate training loss shape.

    Defaults = pretrain_fwd_model.py:81-85 (MSE + MSE).  The constraint
    trainer's phase 1 uses spectrum 5 / metrics 2 / smoothness 0.5
    (unified_constraint_trainer.py:251-255); the emergency trainer adds
    0.5*L1 (emergency_trainer.py:131).  ``nll_w`` > 0 trains the variance
    heads of the uncertainty forward model, which is not ported: it
    raises."""

    spectrum_w: float = 1.0
    metrics_w: float = 1.0
    smoothness_w: float = 0.0
    l1_w: float = 0.0
    nll_w: float = 0.0


def forward_train_mode(model: nn.Module, params_norm: torch.Tensor,
                       seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """ForwardMLP's forward in train mode, with each Dropout layer replaced
    by the hash masks of ``seed`` (layer index = block index)."""
    h = params_norm
    block = 0
    for layer in model.model:
        if isinstance(layer, nn.Dropout):
            if layer.p > 0.0:
                h = h * dropout_scale(seed, block, h.shape[0], h.shape[1], layer.p,
                                      h.device)
            block += 1
        else:
            h = layer(h)
    s = model.spectrum_dim
    return h[:, :s], h[:, s:]


def make_forward_step(
    tx: ClipAdam, settings: ForwardStepSettings = ForwardStepSettings()
) -> Callable:
    """step(state, batch, lr_scale=None, seed=0) -> (state, metrics): one
    pretraining step (pretrain_fwd_model.py:68-92) of ``state.f`` on
    ``state`` in place.  ``lr_scale`` multiplies the parameter update (the
    plateau controller's runtime scale); ``seed`` keys the step's dropout
    masks.  The JAX step takes the flax module as its first argument; here
    the module is part of the state."""
    if settings.nll_w:
        raise ValueError(
            "ForwardStepSettings.nll_w > 0 needs a model with variance heads "
            "(forward_model.name='uncertainty'), which is not ported "
            "(ROADMAP.md queue 1, item 15)"
        )

    def step(state: ForwardState, batch: Batch, lr_scale=None, seed: int = 0):
        spectra, _, params_norm, _, metrics_norm = batch[:5]
        model = state.f.train()
        params = list(model.parameters())
        pred_spec, pred_met = forward_train_mode(model, params_norm, seed)
        spec_l = L.mse(pred_spec, spectra)
        met_l = L.mse(pred_met, metrics_norm)
        total = settings.spectrum_w * spec_l + settings.metrics_w * met_l
        if settings.smoothness_w:
            total = total + settings.smoothness_w * L.maxwell_smoothness_loss(pred_spec)
        if settings.l1_w:
            total = total + settings.l1_w * (
                L.mae(pred_spec, spectra) + L.mae(pred_met, metrics_norm))
        grads = torch.autograd.grad(total, params)
        flat = torch.cat([g.reshape(-1) for g in grads])
        tx.update_(flat, state.opt, state.params, lr_scale)
        state.step += 1
        metrics = {"loss": total.detach(), "spectrum_loss": spec_l.detach(),
                   "metrics_loss": met_l.detach()}
        return state, metrics

    return step


def make_multi_epoch_fn(step_fn: Callable, batch_size: int):
    """multi_epoch(state, ds, scales, indices=None, seeds=None) ->
    (state, {key: (E,) per-epoch mean}) running E whole epochs of
    ``step_fn``.  ``scales`` (E,) is each epoch's learning-rate multiplier,
    passed to the step as ``lr_scale`` (the JAX package's
    ``with_scale=True``; a scale of 1 is exact).  ``indices`` (E, spe, B) and
    ``seeds`` (E·spe,) default to draws from ``state.generator``
    (``ops.forward_train.resolve_draws``, shared with the kernel path)."""

    def multi_epoch(state: ForwardState, ds: ThzDataset,
                    scales: Sequence[float] | torch.Tensor,
                    indices: torch.Tensor | None = None,
                    seeds: torch.Tensor | None = None):
        scales = torch.as_tensor(scales, dtype=torch.float32).reshape(-1)
        epochs = int(scales.numel())
        indices, seeds = resolve_draws(state.generator, ds.num_samples, batch_size,
                                       epochs, indices, seeds)
        spe = indices.shape[1]
        idx_dev = indices.to(ds.spectra.device)
        rows: Dict[str, list] = {k: [] for k in METRIC_KEYS}
        for e in range(epochs):
            scale = scales[e].to(state.device)
            sums = {}
            for s in range(spe):
                batch = gather_batch(ds, idx_dev[e, s])
                state, m = step_fn(state, batch, scale, int(seeds[e * spe + s]))
                for k in METRIC_KEYS:
                    sums.setdefault(k, []).append(m[k])
            for k in METRIC_KEYS:
                rows[k].append(torch.stack(sums[k]).mean())
        return state, {k: torch.stack(v) for k, v in rows.items()}

    return multi_epoch
