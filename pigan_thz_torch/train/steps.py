"""Eager training steps: the port of ``pigan_thz_tpu/train/steps.py``.

``make_forward_step`` is one pretraining step with autograd: F's forward in
train mode, the loss of ``ForwardStepSettings``, the gradient, then the
optimiser (clip -> Adam -> schedule, ``schedules.ClipAdam``) on the state's
flat buffers in place.  F's LayerNorms are torch's ``nn.LayerNorm`` here,
which computes the variance in another order than flax's one-pass form: a
rounding difference only.  Every model of the zoo trains here; the
uncertainty model's variance heads too, with ``nll_w`` > 0.

Dropout, in every model and every call of a step (attention-weight dropout
included), takes its masks from the counter-based hash of
``ops/forward_train.py`` (``hash_masks``), keyed by the step's seed, the
call (``stream``) and the layer's index in the model, through
``dropout_scale``.  Nothing reads torch's global generator, so a resumed run
and the shadow replay redraw the same masks, and the forward step, the plain
version of the forward-training kernel and the kernel see the same masks.
``draws["dropout"]`` may hand a step other masks (the parity tests hand it
the JAX package's).

``make_pigan_step`` is one PI-GAN step with autograd, the whole alternating
update of the reference's hot loop (train_pigan.py:114-187): D on
[real; detached fake] with smoothed labels, then G against the
just-updated D, with the frozen forward surrogate's reconstruction,
metrics, Maxwell, LC and range losses and the extended trainers' terms of
``StepSettings``.  The model calls follow the JAX step's: G's D-phase pass (its
``batch_stats`` discarded), D on [real; fake] (its ``batch_stats`` stored:
spectral norm's ``u`` and ``sigma``), WGAN-GP's critic pass (discarded),
G's G-phase pass (stored), D on the G-phase batch (discarded), and G's
stability and cycle passes with the G-phase pass's masks (discarded); a
step that skips D's update stores D's from its forward.  A G without
dropout computes the same thing in both phases, so its one pass serves
both, as it always has.

``make_multi_epoch_fn`` is the epoch loop as a Python loop, with the
contract of the JAX package's: per-epoch scales in (the learning-rate scale
of the forward step, the constraint scale of the PI-GAN step), per-epoch
mean metric rows out.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Sequence

import torch
from torch import nn

from ..config import PiGanConfig
from ..data.dataset import ThzDataset, denormalize_params, gather_batch
from ..models.blocks import (MaskFn, batch_stats_over, dropout_masks, frozen_batch_stats,
                             has_dropout)
from ..ops import losses as L
from ..ops.augment import augment_spectra
from ..ops.forward_train import hash_masks, resolve_draws
from .schedules import ClipAdam
from .state import ForwardState, PiGanState

Batch = tuple  # (spectra, params, params_norm, metrics, metrics_norm)


@dataclass(frozen=True)
class StepSettings:
    """Knobs of the PI-GAN step (the JAX package's, field for field)."""

    # loss weights (config/config.py:79-88 defaults)
    adv_w: float = 1.0
    recon_w: float = 100.0
    physics_spec_w: float = 10.0
    physics_metrics_w: float = 1.0
    maxwell_w: float = 1.0
    lc_w: float = 1.0
    range_w: float = 0.1
    kl_w: float = 0.0
    # extended trainer losses (0 = off)
    constraint_w: float = 0.0        # enhanced constraint loss
    stability_w: float = 0.0         # input-noise stability
    cycle_w: float = 0.0             # cycle consistency G(F(G(s))) ~ G(s)
    window_w: float = 0.0            # physics resonance-window loss
    # semantics
    detach_forward: bool = True
    sigmoid_squash: bool = False     # constraint_optimizer.py:246
    label_real: float = 0.9          # label smoothing (train_pigan.py:127)
    label_fake: float = 0.1
    range_lo: float = 0.0            # parity: [0,1] window on tanh outputs
    range_hi: float = 1.0
    d_update_every: int = 1          # D update frequency (emergency_trainer.py:64-83)
    stability_noise: float = 0.01    # unified_trainer.py:260
    # EMA of generator params (0 = off); evaluate or serve with state.g_ema
    ema_decay: float = 0.0
    # GAN objective: "bce" (reference, Sigmoid+BCELoss) or "wgan_gp"
    gan_loss: str = "bce"
    gp_weight: float = 10.0
    # D-input instance noise (training_optimization.py:71), 0 = off
    instance_noise: float = 0.0
    # data augmentation (training_optimization.py:103-107), 0 = off
    augment_noise: float = 0.0
    augment_shift: float = 0.0
    augment_scale: float = 0.0

    @classmethod
    def from_config(cls, cfg: PiGanConfig, **overrides) -> "StepSettings":
        base = cls(
            adv_w=cfg.loss.adversarial,
            recon_w=cfg.loss.recon,
            physics_spec_w=cfg.loss.physics_spectrum,
            physics_metrics_w=cfg.loss.physics_metrics,
            maxwell_w=cfg.loss.maxwell,
            window_w=cfg.loss.window,
            lc_w=cfg.loss.lc,
            range_w=cfg.loss.param_range,
            kl_w=cfg.loss.bnn_kl,
            detach_forward=cfg.train.detach_forward,
            label_real=cfg.train.label_smooth_real,
            label_fake=cfg.train.label_smooth_fake,
        )
        return dataclasses.replace(base, **overrides)

    @property
    def augments(self) -> bool:
        return bool(self.augment_noise or self.augment_shift or self.augment_scale)


@dataclass(frozen=True)
class ForwardStepSettings:
    """Forward-surrogate training loss shape.

    Defaults = pretrain_fwd_model.py:81-85 (MSE + MSE).  The constraint
    trainer's phase 1 uses spectrum 5 / metrics 2 / smoothness 0.5
    (unified_constraint_trainer.py:251-255); the emergency trainer adds
    0.5*L1 (emergency_trainer.py:131).  ``nll_w`` > 0 adds
    ``losses.gaussian_nll`` of both heads and trains the variance heads of
    the uncertainty forward model (beyond the reference, as in the JAX
    package); a model with fewer than four outputs raises ``ValueError``."""

    spectrum_w: float = 1.0
    metrics_w: float = 1.0
    smoothness_w: float = 0.0
    l1_w: float = 0.0
    nll_w: float = 0.0


# The calls of a step, each with masks of its own (the JAX step's dropout
# keys): the forward step's one call, then the PI-GAN step's G in the D phase,
# D in the D phase (and WGAN-GP's critic), G in the G phase (and its
# stability and cycle passes), D in the G phase.
FORWARD, G_IN_D_PHASE, D_IN_D_PHASE, G_IN_G_PHASE, D_IN_G_PHASE = range(5)


def _masks(draws: Mapping | None, seed: int, stream: int, shard=None) -> MaskFn:
    provider = (draws or {}).get("dropout")
    if provider is not None:
        masks = functools.partial(provider, stream)
    else:
        masks = hash_masks(seed, stream)
    if shard is None:
        return masks

    def rows(layer, shape, rate, device):
        # the global batch's mask, of which this rank keeps its rows
        return shard.take(masks(layer, shard.global_shape(shape), rate, device))

    return rows


def _sharded(shard, *modules: nn.Module):
    """The block a step runs in: under a ``shard`` the modules' BatchNorm
    statistics are over every rank's rows."""
    if shard is None:
        return contextlib.nullcontext()
    return batch_stats_over(shard.sum, *modules)


def _gradient(loss: torch.Tensor, params: list, shard, **kw) -> torch.Tensor:
    """The flat gradient of ``loss``; under a ``shard`` averaged over the
    ranks (every rank's loss is its share of the global loss, scaled so
    that the ranks' mean is the global loss), the same bits on every rank."""
    grads = torch.autograd.grad(loss, params, **kw)
    flat = torch.cat([g.reshape(-1) for g in grads])
    return flat if shard is None else shard.mean(flat)


def _sq_norm(module: nn.Module):
    """The clip's squared global norm of ``module``'s gradient where the
    module is split over a model axis (``parallel/tensor.py``), else None."""
    plan = getattr(module, "tp_plan", None)
    return None if plan is None else plan.sq_norm


def call_train_mode(model: nn.Module, masks: MaskFn, *inputs):
    """``model``'s train-mode forward with every dropout mask from ``masks``."""
    with dropout_masks(model, masks):
        return model.train()(*inputs)


def make_forward_step(
    tx: ClipAdam, settings: ForwardStepSettings = ForwardStepSettings()
) -> Callable:
    """step(state, batch, lr_scale=None, seed=0, draws=None, shard=None) ->
    (state, metrics): one pretraining step (pretrain_fwd_model.py:68-92) of
    ``state.f`` on ``state`` in place.  ``lr_scale`` multiplies the
    parameter update (the plateau controller's runtime scale); ``seed`` keys
    the step's dropout masks, or ``draws["dropout"]`` supplies them.  With
    ``shard`` (``parallel/mesh.py:BatchShard``, the data-parallel epoch)
    ``batch`` is the global batch: the step trains on this rank's rows with
    the global batch's masks and averages its gradient over the ranks.  The
    JAX step takes the flax module as its first argument; here the module
    is part of the state."""
    def step(state: ForwardState, batch: Batch, lr_scale=None, seed: int = 0,
             draws: Mapping | None = None, shard=None):
        with _sharded(shard, state.f):
            return _forward_step(state, batch, lr_scale, seed, draws, shard)

    def _forward_step(state, batch, lr_scale, seed, draws, shard):
        if shard is not None:
            batch = tuple(shard.take(t) for t in batch[:5])
        spectra, _, params_norm, _, metrics_norm = batch[:5]
        model = state.f
        params = list(model.parameters())
        out = call_train_mode(model, _masks(draws, seed, FORWARD, shard), params_norm)
        # means lead whatever the arity (the uncertainty model returns four)
        pred_spec, pred_met = out[0], out[1]
        spec_l = L.mse(pred_spec, spectra)
        met_l = L.mse(pred_met, metrics_norm)
        total = settings.spectrum_w * spec_l + settings.metrics_w * met_l
        if settings.smoothness_w:
            total = total + settings.smoothness_w * L.maxwell_smoothness_loss(pred_spec)
        if settings.l1_w:
            total = total + settings.l1_w * (
                L.mae(pred_spec, spectra) + L.mae(pred_met, metrics_norm))
        if settings.nll_w:
            if len(out) < 4:
                raise ValueError(
                    "ForwardStepSettings.nll_w > 0 needs a model with "
                    "variance heads (forward_model.name='uncertainty')")
            total = total + settings.nll_w * (
                L.gaussian_nll(pred_spec, out[2], spectra)
                + L.gaussian_nll(pred_met, out[3], metrics_norm))
        # heads the loss does not read (the uncertainty model's variances
        # without nll_w) take zero gradients, as jax.grad gives them
        flat = _gradient(total, params, shard, allow_unused=True, materialize_grads=True)
        tx.update_(flat, state.opt, state.params, lr_scale, sq_norm=_sq_norm(model))
        state.step += 1
        metrics = {"loss": total.detach(), "spectrum_loss": spec_l.detach(),
                   "metrics_loss": met_l.detach()}
        return state, metrics

    return step


# ---------------------------------------------------------------------------
# PI-GAN step (D update, then G update against the updated D)
# ---------------------------------------------------------------------------


def make_pigan_step(
    g_tx: ClipAdam,
    d_tx: ClipAdam,
    settings: StepSettings,
    param_lo: torch.Tensor | None = None,
    param_hi: torch.Tensor | None = None,
    runtime_weights: bool = False,
) -> Callable:
    """step(state, batch, constraint_scale=1.0, seed=0, draws=None,
    shard=None) -> (state, metrics): one PI-GAN step on ``state`` in place.
    With ``runtime_weights`` the step is step(state, batch, weights,
    seed=0, draws=None, shard=None): ``weights`` (7,) gives the seven core
    G-loss weights in ``parallel/ensemble.py:WEIGHT_NAMES`` order (adv,
    recon, physics_spectrum, physics_metrics, maxwell, lc, range) in place
    of the settings' and the constraint scale is 1; with the settings'
    weights it is the static step, bit for bit (one body serves both).

    ``constraint_scale`` multiplies the constraint loss (the annealing knob
    of unified_constraint_trainer.py:515-529).  ``seed`` seeds the step's
    own generator, which draws what the stochastic knobs need, in this
    order: the augmentation, the instance noise, the WGAN-GP interpolation
    weights, the stability noise.  ``draws`` may supply any of
    ``"instance_noise"`` (2B, S), ``"gp_eps"`` (B, 1) and
    ``"stability_noise"`` (B, S) instead (unit scale; the step multiplies
    by the settings' levels), and ``"dropout"`` a mask provider taking the
    call (``G_IN_D_PHASE`` ...) before the layer index, shape, rate and
    device.

    With ``shard`` (``parallel/mesh.py:BatchShard``, the data-parallel
    epoch) ``batch`` is the global batch.  The step draws everything at the
    global shape (the augmentation on the whole batch, the noise, the
    interpolation weights, every dropout mask) and keeps this rank's rows;
    G's BatchNorm statistics are over every rank's rows; each loss is this
    rank's share of the global loss, scaled so that the ranks' mean is the
    global one (the means over rows as they are, the window term's sum over
    rows times the world size), and each update's flat gradient is averaged
    over the ranks before the optimiser: the JAX package's global-batch
    step on every rank.  The JAX step takes the three flax modules first;
    here they are part of the state."""
    if settings.gan_loss not in ("bce", "wgan_gp"):
        raise ValueError(f"gan_loss {settings.gan_loss!r}: use bce | wgan_gp")
    st = settings
    wgan = st.gan_loss == "wgan_gp"

    def squash(p):
        return torch.sigmoid(p) if st.sigmoid_squash else p

    static_weights = (st.adv_w, st.recon_w, st.physics_spec_w, st.physics_metrics_w,
                      st.maxwell_w, st.lc_w, st.range_w)

    def step_body(state: PiGanState, batch: Batch, constraint_scale, seed: int,
                  draws: Mapping[str, torch.Tensor] | None, shard, weights):
        with _sharded(shard, state.g, state.d):
            return _pigan_step(state, batch, constraint_scale, seed, draws, shard, weights)

    def _pigan_step(state, batch, constraint_scale, seed, draws, shard, weights):
        w_adv, w_recon, w_pspec, w_pmet, w_maxwell, w_lc, w_range = weights
        spectra, params_phys, _, _, metrics_norm = batch[:5]
        gb, dev = spectra.shape[0], spectra.device      # the global batch under a shard
        lo = param_lo if param_lo is not None else torch.full((4,), 2.2, device=dev)
        hi = param_hi if param_hi is not None else torch.full((4,), 2.8, device=dev)
        draws = draws or {}
        gen = torch.Generator().manual_seed(int(seed))

        def rows(x):
            return x if shard is None else shard.take(x)

        def draw(name, shape, uniform=False):
            # at the global shape; under a shard this rank's rows of it
            if name in draws:
                return rows(draws[name]).to(dev)
            fn = torch.rand if uniform else torch.randn
            return rows(fn(shape, generator=gen)).to(dev)

        if st.augments:
            spectra = augment_spectra(gen, spectra, noise_level=st.augment_noise,
                                      freq_shift=st.augment_shift,
                                      amp_scale=st.augment_scale)
        spectra, params_phys, metrics_norm = rows(spectra), rows(params_phys), rows(metrics_norm)
        b = spectra.shape[0]
        g, d, f = state.g.train(), state.d.train(), state.f.eval()
        g_params, d_params = list(g.parameters()), list(d.parameters())
        g_masks = _masks(draws, seed, G_IN_G_PHASE, shard)
        d_masks = _masks(draws, seed, D_IN_D_PHASE, shard)

        # G's G-phase pass; G's BatchNorm stats move here
        pred_norm = squash(call_train_mode(g, g_masks, spectra))
        pred_phys = denormalize_params(pred_norm, lo, hi)

        # ---- D update (train_pigan.py:123-143) -------------------------
        if has_dropout(g):
            # the D phase's own pass of G, with masks of its own
            with torch.no_grad(), frozen_batch_stats(g):
                fake_norm = squash(call_train_mode(
                    g, _masks(draws, seed, G_IN_D_PHASE, shard), spectra))
            fake_phys = denormalize_params(fake_norm, lo, hi)
        else:
            fake_phys = pred_phys.detach()
        cat_spec = torch.cat([spectra, spectra], dim=0)
        cat_par = torch.cat([params_phys, fake_phys], dim=0)
        if st.instance_noise > 0.0:
            cat_spec = cat_spec + st.instance_noise * draw("instance_noise",
                                                           (2 * gb, cat_spec.shape[1]))
        labels = torch.cat([torch.full((b, 1), st.label_real, device=dev),
                            torch.full((b, 1), st.label_fake, device=dev)], dim=0)

        def gradient_penalty():
            # at (clean spectra, interpolated params), D's batch_stats as the
            # step found them and discarded after; per-row gradients are
            # exact: a row of D reads only its own inputs
            eps = draw("gp_eps", (gb, 1), uniform=True)
            sp = spectra.detach().clone().requires_grad_(True)
            par = (eps * params_phys + (1.0 - eps) * fake_phys).requires_grad_(True)
            with frozen_batch_stats(d):
                critic = call_train_mode(d, d_masks, sp, par)
            g_spec, g_par = torch.autograd.grad(critic.sum(), (sp, par), create_graph=True)
            norm = torch.sqrt(torch.sum(g_spec**2, dim=1) + torch.sum(g_par**2, dim=1)
                              + 1e-12)
            return torch.mean((norm - 1.0) ** 2)

        def d_loss_of(logits, penalty=None):
            if not wgan:
                # the reference sums two means: 2x the mean over the concat batch
                return 2.0 * L.bce_logits(logits, labels)
            loss = torch.mean(logits[b:]) - torch.mean(logits[:b])
            if penalty is not None:
                loss = loss + st.gp_weight * penalty
            return loss

        if st.d_update_every <= 1 or state.step % st.d_update_every == 0:
            penalty = gradient_penalty() if wgan else None
            d_logits = call_train_mode(d, d_masks, cat_spec, cat_par)   # stores D's stats
            d_loss = d_loss_of(d_logits, penalty)
            d_tx.update_(_gradient(d_loss, d_params, shard), state.d_opt, state.d_params,
                         sq_norm=_sq_norm(d))
        else:
            # skipped: forward only, D's parameters and optimiser untouched
            # (its batch_stats stored, as the JAX step's skip branch does);
            # the reported d_loss leaves the penalty out
            with torch.no_grad():
                d_logits = call_train_mode(d, d_masks, cat_spec, cat_par)
                d_loss = d_loss_of(d_logits)
        d_logits, d_loss = d_logits.detach(), d_loss.detach()
        # D accuracy at threshold 0.5 (unified_evaluator.py:315-317)
        probs = torch.sigmoid(d_logits)
        d_acc = 0.5 * ((probs[:b] > 0.5).float().mean() + (probs[b:] <= 0.5).float().mean())

        # ---- G update against the just-updated D (train_pigan.py:145-187)
        with frozen_batch_stats(d):
            adv_logits = call_train_mode(d, _masks(draws, seed, D_IN_G_PHASE, shard), spectra,
                                         pred_phys)
        if wgan:
            adv = -torch.mean(adv_logits)
        else:
            adv = L.bce_logits(adv_logits, torch.ones((b, 1), device=dev))  # unsmoothed
        # frozen forward surrogate, eval mode (train_pigan.py:75); out[0] and
        # out[1] whatever the arity (the uncertainty model returns four)
        f_out = f(pred_norm)
        recon_spec, pred_met = f_out[0], f_out[1]
        if st.detach_forward:
            recon_spec, pred_met = recon_spec.detach(), pred_met.detach()
        recon_l = L.mse(recon_spec, spectra)
        met_l = L.mse(pred_met, metrics_norm)
        maxwell_l = L.maxwell_smoothness_loss(recon_spec)
        lc_l = L.lc_approx_loss(pred_met[:, 0:1], pred_met[:, 1:2], pred_norm)
        range_l = L.param_range_loss(pred_norm, st.range_lo, st.range_hi)
        # kl_w multiplies bnn_kl_loss, which is identically zero
        total = (
            w_adv * adv
            + w_recon * recon_l
            + w_pspec * recon_l   # double-count parity
            + w_pmet * met_l
            + w_maxwell * maxwell_l
            + w_lc * lc_l
            + w_range * range_l
        )
        aux = {
            "adv_loss": adv,
            "recon_spec_loss": recon_l,
            "recon_metrics_loss": met_l,
            "maxwell_loss": maxwell_l,
            "lc_loss": lc_l,
            "param_range_loss": range_l,
            "violation_rate": L.violation_rate(pred_norm.detach(), st.range_lo, st.range_hi),
        }
        if st.constraint_w:
            ec = L.enhanced_constraint_loss(pred_norm, recon_spec)
            total = total + st.constraint_w * constraint_scale * ec.loss
            aux["constraint_loss"] = ec.loss
        if st.window_w:
            # a sum over rows: this rank's share of the global sum is its
            # own sum times the world size (the ranks' mean is the sum)
            total = total + st.window_w * L.physics_window_loss(
                recon_spec, spectra, pred_met, consistency_weight=0.0,
                window_weight=1.0 if shard is None else float(shard.world))
        if st.stability_w:
            noisy = spectra + st.stability_noise * draw("stability_noise",
                                                        (gb, spectra.shape[1]))
            with frozen_batch_stats(g):
                pred_noisy = squash(call_train_mode(g, g_masks, noisy))
            total = total + st.stability_w * L.stability_loss(pred_norm, pred_noisy)
        if st.cycle_w:
            with frozen_batch_stats(g):
                cycled = squash(call_train_mode(g, g_masks, recon_spec))
            total = total + st.cycle_w * L.cycle_consistency_loss(pred_norm, cycled)

        g_tx.update_(_gradient(total, g_params, shard), state.g_opt, state.g_params,
                     sq_norm=_sq_norm(g))
        if st.ema_decay > 0.0:
            if state.g_ema is None:
                raise ValueError(
                    "StepSettings.ema_decay > 0 needs a state that carries g_ema: "
                    "init_pigan_state(..., ema=True) (the Trainer does this itself)")
            with torch.no_grad():
                state.g_ema.mul_(st.ema_decay).add_((1.0 - st.ema_decay) * state.g_params)
        state.step += 1
        metrics = {"d_loss": d_loss, "g_loss": total.detach(), "d_accuracy": d_acc,
                   **{k: v.detach() for k, v in aux.items()}}
        return state, metrics

    if runtime_weights:
        def step(state: PiGanState, batch: Batch, weights: torch.Tensor, seed: int = 0,
                 draws: Mapping[str, torch.Tensor] | None = None, shard=None):
            weights = torch.as_tensor(weights, dtype=torch.float32, device=state.device)
            if tuple(weights.shape) != (7,):
                raise ValueError(f"weights of shape {tuple(weights.shape)}: the seven core "
                                 "G-loss weights, shape (7,)")
            return step_body(state, batch, 1.0, seed, draws, shard, weights.unbind())
    else:
        def step(state: PiGanState, batch: Batch, constraint_scale=1.0, seed: int = 0,
                 draws: Mapping[str, torch.Tensor] | None = None, shard=None):
            return step_body(state, batch, constraint_scale, seed, draws, shard,
                             static_weights)

    return step


# ---------------------------------------------------------------------------
# The epoch loop
# ---------------------------------------------------------------------------


def make_multi_epoch_fn(step_fn: Callable, batch_size: int, shard=None):
    """multi_epoch(state, ds, scales, indices=None, seeds=None, draws=None)
    -> (state, {key: (E,) per-epoch mean}) running E whole epochs of
    ``step_fn``.  ``scales`` (E,) is each epoch's scale, passed to the step
    as its third argument: the learning-rate multiplier of the forward step
    (a scale of 1 is exact), the constraint scale of the PI-GAN step (the
    JAX package's ``with_scale=True``).  ``indices`` (E, spe, B) and
    ``seeds`` (E·spe,) default to draws from ``state.generator``
    (``ops.forward_train.resolve_draws``, shared with the kernel paths).
    ``draws``, a sequence of one mapping per step, hands the PI-GAN step
    its noise instead of its own generator's.  ``shard`` is handed to every
    step with the global batch (``parallel/sharding.py``); the rows are
    then this rank's."""

    def multi_epoch(state, ds: ThzDataset, scales: Sequence[float] | torch.Tensor,
                    indices: torch.Tensor | None = None,
                    seeds: torch.Tensor | None = None,
                    draws: Sequence[Mapping[str, torch.Tensor]] | None = None):
        scales = torch.as_tensor(scales, dtype=torch.float32).reshape(-1)
        epochs = int(scales.numel())
        indices, seeds = resolve_draws(state.generator, ds.num_samples, batch_size,
                                       epochs, indices, seeds)
        spe = indices.shape[1]
        idx_dev = indices.to(ds.spectra.device)
        rows: Dict[str, list] = {}
        for e in range(epochs):
            scale = scales[e].to(state.device)
            sums: Dict[str, list] = {}
            for s in range(spe):
                batch = gather_batch(ds, idx_dev[e, s])
                t = e * spe + s
                extra = () if draws is None else (draws[t],)
                kw = {} if shard is None else {"shard": shard}
                state, m = step_fn(state, batch, scale, int(seeds[t]), *extra, **kw)
                for k, v in m.items():
                    sums.setdefault(k, []).append(v)
            for k, v in sums.items():
                rows.setdefault(k, []).append(torch.stack(v).mean())
        return state, {k: torch.stack(v) for k, v in rows.items()}

    return multi_epoch
