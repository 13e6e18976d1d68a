"""Ensembles: initialisation, the λ-ablation sweep and scoring.  The port of
``pigan_thz_tpu/parallel/ensemble.py``: ``init_ensemble_states``
(:98-116), ``evaluate_ensemble`` (:136-158) and ``evaluate_ensemble_mean``
(:161-202), which the seed-ensemble path runs, and the λ-ensemble with
runtime loss weights: ``WEIGHT_NAMES`` / ``weight_vector`` (:31-49),
``EnsembleSettings`` and ``make_ensemble_pigan_step`` (:52-95),
``shard_ensemble`` (:119-133), ``make_ensemble_epoch_fn`` and
``make_ensemble_multi_epoch_fn`` (:205-259).

The JAX functions vmap the step and the modules over the stacked variables;
here the members are modules over rows of the stacked buffers
(``state_utils.EnsembleState``), and the sweep is a loop over the members
that runs the one step of ``train/steps.py`` (``runtime_weights=True``) on
each member's views: member m is then bit for bit a solo run with its
weights on the same batches and seeds.  Every member sees the same batches
(a controlled ablation).  The member-packed kernel (K3) takes one set of
scalar loss weights for all members, so the sweep is eager in both packages.
No kernel is involved in scoring either.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Sequence

import torch
from torch import nn

from ..data.dataset import ThzDataset, denormalize_params, gather_batch
from ..ops.forward_train import resolve_draws
from ..ops.losses import violation_rate
from ..ops.metrics import r2_score
from ..train.schedules import ClipAdam
from ..train.state import init_pigan_state
from .mesh import DATA_AXIS
from .state_utils import EnsembleState, MemberBlock, tree_stack

WEIGHT_NAMES = ("adv", "recon", "physics_spectrum", "physics_metrics", "maxwell", "lc",
                "range")


def weight_vector(
    adv: float = 1.0,
    recon: float = 100.0,
    physics_spectrum: float = 10.0,
    physics_metrics: float = 1.0,
    maxwell: float = 1.0,
    lc: float = 1.0,
    range_: float = 0.1,
) -> torch.Tensor:
    """The seven core G-loss weights in ``WEIGHT_NAMES`` order, a (7,)
    float32 tensor on the CPU (the epoch functions move it)."""
    return torch.tensor([adv, recon, physics_spectrum, physics_metrics, maxwell, lc, range_],
                        dtype=torch.float32)


@dataclass(frozen=True)
class EnsembleSettings:
    # True = reference-parity loss surface (physics losses carry no gradient
    # into G, as StepSettings' default); False = gradients through frozen F
    detach_forward: bool = True
    label_real: float = 0.9
    label_fake: float = 0.1
    range_lo: float = 0.0
    range_hi: float = 1.0


def make_ensemble_pigan_step(
    g_tx: ClipAdam,
    d_tx: ClipAdam,
    settings: EnsembleSettings,
    param_lo: torch.Tensor,
    param_hi: torch.Tensor,
    step_settings=None,
) -> Callable:
    """step(state, batch, weights(7,), seed=0, draws=None) -> (state,
    metrics): one member's D-then-G update with runtime loss weights, which
    is ``make_pigan_step(..., runtime_weights=True)``.  A full
    ``StepSettings`` as ``step_settings`` gives the knobs beyond
    ``EnsembleSettings``; its seven core loss weights are then ignored for
    the runtime vector."""
    from ..train.steps import StepSettings, make_pigan_step

    if step_settings is None:
        step_settings = StepSettings(
            detach_forward=settings.detach_forward, label_real=settings.label_real,
            label_fake=settings.label_fake, range_lo=settings.range_lo,
            range_hi=settings.range_hi)
    return make_pigan_step(g_tx, d_tx, step_settings, param_lo, param_hi,
                           runtime_weights=True)


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


def shard_ensemble(states: EnsembleState, mesh) -> EnsembleState:
    """Split the members over the ranks of ``mesh``: with N members and W
    ranks, W dividing N, rank r keeps members r·N/W ... (r+1)·N/W - 1 (copies,
    stacked anew; ``states.block`` says which) and trains them on whole
    batches with no traffic between ranks; otherwise every rank keeps all N
    (the JAX package replicates them then).  ``gather_ensemble`` gives every
    rank the whole ensemble back."""
    n, w = len(states), mesh.shape[DATA_AXIS]
    if n % w:
        return states
    k = n // w
    start = mesh.rank * k
    local = tree_stack([states[m].clone() for m in range(start, start + k)])
    local.block = MemberBlock(mesh, start, n)
    return local


def gather_ensemble(states: EnsembleState) -> EnsembleState:
    """The whole ensemble on every rank, from the blocks of
    ``shard_ensemble`` (an unsplit ensemble is returned as it is).  The
    members' parameters, moments, BatchNorm stats and EMA are theirs; their
    counts are this rank's (every member took the same steps) and their
    generators copies of this rank's first member's."""
    block = states.block
    if block is None:
        return states
    mesh = block.mesh
    full = tree_stack([states[0].clone() for _ in range(block.total)])
    pairs = [(full.g_params, states.g_params), (full.d_params, states.d_params),
             (full.g_m, states.g_m), (full.g_v, states.g_v), (full.d_m, states.d_m),
             (full.d_v, states.d_v), *zip(full.bn, states.bn)]
    if states.g_ema is not None:
        pairs.append((full.g_ema, states.g_ema))
    with torch.no_grad():
        for dst, src in pairs:
            dst.copy_(torch.cat(mesh.all_gather(src)))
    return full


def _ensemble_weights(states: EnsembleState, weights) -> torch.Tensor:
    """The (M, 7) weight rows of the members ``states`` holds, on their
    device: all N rows given, this rank's block kept."""
    weights = torch.as_tensor(weights, dtype=torch.float32)
    if states.block is not None:
        weights = weights[states.block.start:states.block.start + len(states)]
    if tuple(weights.shape) != (len(states), 7):
        raise ValueError(f"weights of shape {tuple(weights.shape)} for {len(states)} members: "
                         "(N, 7), one row of WEIGHT_NAMES a member")
    return weights.to(states.device)


def make_ensemble_multi_epoch_fn(step_fn: Callable, batch_size: int):
    """multi_epoch(states, ds, generator, weights(N, 7), num_epochs,
    indices=None, seeds=None) -> (states, {key: (E, N) per-epoch means}).

    ``step_fn`` is ``make_ensemble_pigan_step``'s; member m takes it with
    its weight row on each batch.  Every member sees the same batches and
    step seeds: ``indices`` (E, spe, B) and ``seeds`` (E·spe,) default to
    draws from the CPU ``generator`` (``ops.forward_train.resolve_draws``;
    the JAX package's ``key``).  Under ``shard_ensemble`` each rank trains
    its block of members on the same draws and the rows of all N members
    are gathered once a call."""

    def multi_epoch(states: EnsembleState, ds: ThzDataset, generator: torch.Generator,
                    weights, num_epochs: int, indices: torch.Tensor | None = None,
                    seeds: torch.Tensor | None = None):
        w = _ensemble_weights(states, weights)
        indices, seeds = resolve_draws(generator, ds.num_samples, batch_size, num_epochs,
                                       indices, seeds)
        spe = indices.shape[1]
        idx_dev = indices.to(ds.spectra.device)
        rows: Dict[str, list] = {}
        for e in range(num_epochs):
            sums: list[Dict[str, list]] = [{} for _ in states]      # a member's steps
            for s in range(spe):
                batch = gather_batch(ds, idx_dev[e, s])
                seed = int(seeds[e * spe + s])
                for m, st in enumerate(states):
                    _, met = step_fn(st, batch, w[m], seed)
                    for k, v in met.items():
                        sums[m].setdefault(k, []).append(v)
            for k in sums[0]:
                rows.setdefault(k, []).append(
                    torch.stack([torch.stack(sm[k]).mean() for sm in sums]))
        out = {k: torch.stack(v) for k, v in rows.items()}          # (E, M)
        if states.block is not None:
            keys = list(out)
            parts = states.block.mesh.all_gather(torch.stack([out[k] for k in keys]))
            full = torch.cat(parts, dim=-1)                          # (K, E, N)
            out = {k: full[i] for i, k in enumerate(keys)}
        return states, out

    return multi_epoch


def make_ensemble_epoch_fn(step_fn: Callable, batch_size: int):
    """epoch(states, ds, generator, weights(N, 7), indices=None, seeds=None)
    -> (states, {key: (N,) means over the epoch}): one epoch of
    ``make_ensemble_multi_epoch_fn``; ``indices`` is (spe, B)."""
    multi = make_ensemble_multi_epoch_fn(step_fn, batch_size)

    def epoch(states: EnsembleState, ds: ThzDataset, generator: torch.Generator, weights,
              indices: torch.Tensor | None = None, seeds: torch.Tensor | None = None):
        states, rows = multi(states, ds, generator, weights, 1,
                             None if indices is None else indices[None], seeds)
        return states, {k: v[0] for k, v in rows.items()}

    return epoch
