"""Seed ensembles: initialisation and scoring.  The port of the part of
``pigan_thz_tpu/parallel/ensemble.py`` that the seed-ensemble path runs:
``init_ensemble_states`` (:98-116), ``evaluate_ensemble`` (:136-158) and
``evaluate_ensemble_mean`` (:161-202).

Not ported yet (ROADMAP.md queue 1, item 14): the vmapped runtime-weights
λ-ablation ensemble (``make_ensemble_pigan_step``, ``make_ensemble_epoch_fn``,
``make_ensemble_multi_epoch_fn``, ``shard_ensemble``, ``weight_vector``),
which needs ``make_pigan_step(runtime_weights=True)``.

The JAX functions vmap the modules over the stacked variables; here the
members are modules over rows of the stacked buffers
(``state_utils.EnsembleState``), so scoring is a loop over the members'
eval-mode forwards.  No kernel is involved on either side.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import torch
from torch import nn

from ..data.dataset import ThzDataset, denormalize_params
from ..ops.losses import violation_rate
from ..ops.metrics import r2_score
from ..train.schedules import ClipAdam
from ..train.state import init_pigan_state
from .state_utils import EnsembleState, tree_stack


def member_generator(seed: int, member: int) -> torch.Generator:
    """The CPU generator of member ``member`` of the ensemble seeded
    ``seed``.  It depends on that pair alone, so a member gets the same
    initial weights and shuffles whether it trains packed with others,
    round-robin beside them or alone: the port's ``fold_in(key, i)``."""
    if seed < 0 or member < 0:
        raise ValueError("member_generator: seed and member must be >= 0")
    mixed = (seed * 0x9E3779B97F4A7C15 + (member + 1) * 0xBF58476D1CE4E5B9) % (1 << 63)
    return torch.Generator().manual_seed(mixed)


def init_ensemble_states(
    generator: nn.Module,
    discriminator: nn.Module,
    forward_model: nn.Module,
    g_tx: ClipAdam,
    d_tx: ClipAdam,
    generators: Sequence[torch.Generator],
    *,
    device: torch.device | str,
    fresh_forward: bool = False,
    ema: bool = False,
) -> EnsembleState:
    """One member per entry of ``generators`` (CPU generators: member m's
    draws its G and D, and later its shuffles), stacked.  Every member's
    frozen F is a copy of ``forward_model`` as it stands, hence shared, or
    with ``fresh_forward`` drawn anew by each member.  ``ema`` gives every
    member an EMA track."""
    if not generators:
        raise ValueError("init_ensemble_states: no member generators")
    return tree_stack([
        init_pigan_state(generator, discriminator, forward_model, g_tx, d_tx, gen,
                         device=device, fresh_forward=fresh_forward, ema=ema)
        for gen in generators])


@contextlib.contextmanager
def _eval_mode(*modules: nn.Module):
    before = [m.training for m in modules]
    for m in modules:
        m.eval()
    try:
        yield
    finally:
        for m, was in zip(modules, before):
            m.train(was)


@torch.no_grad()
def member_predictions(states: EnsembleState, spectra: torch.Tensor) -> torch.Tensor:
    """(M, B, 4): each member's generator on ``spectra`` in eval mode
    (BatchNorm with that member's own running stats), normalised units."""
    out = []
    for st in states:
        with _eval_mode(st.g):
            out.append(st.g(spectra))
    return torch.stack(out)


@torch.no_grad()
def evaluate_ensemble(states: EnsembleState, ds: ThzDataset) -> Dict[str, torch.Tensor]:
    """Per-member quality over ``ds``, a dict of (M,) tensors: param R²,
    the MSE of F(G(s)) against s, the violation rate of G's normalised
    output outside [0, 1], and the cycle error G(F(G(s))) against G(s).
    Each member is scored against its own frozen F."""
    rows = []
    for st in states:
        with _eval_mode(st.g, st.f):
            pred_norm = st.g(ds.spectra)
            recon = st.f(pred_norm)[0]
            cycled = st.g(recon)
        rows.append({
            "param_r2": r2_score(ds.params, denormalize_params(pred_norm, ds.param_lo,
                                                               ds.param_hi)),
            "recon_mse": torch.mean((ds.spectra - recon) ** 2),
            "violation_rate": violation_rate(pred_norm, 0.0, 1.0),
            "cycle_error": torch.mean((cycled - pred_norm) ** 2),
        })
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


@torch.no_grad()
def evaluate_ensemble_mean(states: EnsembleState, ds: ThzDataset) -> Dict[str, torch.Tensor]:
    """Quality of the ensemble-mean prediction: the members' normalised
    outputs averaged, then scored like one member's, through member 0's F
    (a seed ensemble shares it).  The cycle term re-predicts the mean
    reconstruction with every member and averages, as the mean itself is
    formed.  ``member_spread`` is the mean over samples and parameters of
    the members' population standard deviation."""
    preds = member_predictions(states, ds.spectra)                 # (M, B, 4)
    mean_norm = preds.mean(dim=0)
    with _eval_mode(states.f):
        recon = states.f(mean_norm)[0]
    cycled = member_predictions(states, recon).mean(dim=0)
    return {
        "param_r2": r2_score(ds.params, denormalize_params(mean_norm, ds.param_lo,
                                                           ds.param_hi)),
        "recon_mse": torch.mean((ds.spectra - recon) ** 2),
        "violation_rate": violation_rate(mean_norm, 0.0, 1.0),
        "cycle_error": torch.mean((cycled - mean_norm) ** 2),
        "member_spread": torch.mean(torch.std(preds, dim=0, unbiased=False)),
    }
