"""Eager training steps: the port of ``pigan_thz_tpu/train/steps.py``.

``make_forward_step`` is one pretraining step with autograd: F's forward in
train mode, the loss of ``ForwardStepSettings``, the gradient, then the
optimiser (clip -> Adam -> schedule, ``schedules.ClipAdam``) on the state's
flat buffers in place.  Dropout takes its masks from the counter-based hash
of ``ops/forward_train.py`` keyed by the step's seed, so the eager step, the
plain version of the training kernel and the kernel see the same masks, and
nothing reads torch's global generator.  F's LayerNorms are torch's
``nn.LayerNorm`` here, which computes the variance in another order than
flax's one-pass form: a rounding difference only.

``make_pigan_step`` is one PI-GAN step with autograd, the whole alternating
update of the reference's hot loop (train_pigan.py:114-187): D on
[real; detached fake] with smoothed labels, then G against the
just-updated D, with the frozen forward surrogate's reconstruction,
metrics, Maxwell, LC and range losses and the extended trainers' terms of
``StepSettings``.  G's forward runs once per step and serves both phases
(the JAX step calls it twice on the same parameters and batch and keeps
one set of BatchNorm stats), so the running stats move once; the second
generator passes of the stability and cycle terms leave them alone.

``make_multi_epoch_fn`` is the epoch loop as a Python loop, with the
contract of the JAX package's: per-epoch scales in (the learning-rate scale
of the forward step, the constraint scale of the PI-GAN step), per-epoch
mean metric rows out.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Sequence

import torch
from torch import nn

from ..config import PiGanConfig
from ..data.dataset import ThzDataset, denormalize_params, gather_batch
from ..models.blocks import frozen_batch_stats
from ..ops import losses as L
from ..ops.augment import augment_spectra
from ..ops.forward_train import dropout_scale, resolve_draws
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
                                      h.device).to(h.dtype)
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
    """step(state, batch, constraint_scale=1.0, seed=0, draws=None) ->
    (state, metrics): one PI-GAN step on ``state`` in place.

    ``constraint_scale`` multiplies the constraint loss (the annealing knob
    of unified_constraint_trainer.py:515-529).  ``seed`` seeds the step's
    own generator, which draws what the stochastic knobs need, in this
    order: the augmentation, the instance noise, the WGAN-GP interpolation
    weights, the stability noise.  ``draws`` may supply any of
    ``"instance_noise"`` (2B, S), ``"gp_eps"`` (B, 1) and
    ``"stability_noise"`` (B, S) instead (unit scale; the step multiplies
    by the settings' levels).  The JAX step takes the three flax modules
    first; here they are part of the state."""
    if runtime_weights:
        raise NotImplementedError(
            "runtime_weights=True (the ensemble λ-sweep's dynamic loss weights) is "
            "not ported yet: ROADMAP.md queue 1, item 14 (ensembles and parallelism)")
    if settings.gan_loss not in ("bce", "wgan_gp"):
        raise ValueError(f"gan_loss {settings.gan_loss!r}: use bce | wgan_gp")
    st = settings
    wgan = st.gan_loss == "wgan_gp"

    def squash(p):
        return torch.sigmoid(p) if st.sigmoid_squash else p

    def step(state: PiGanState, batch: Batch, constraint_scale=1.0, seed: int = 0,
             draws: Mapping[str, torch.Tensor] | None = None):
        spectra, params_phys, _, _, metrics_norm = batch[:5]
        b, dev = spectra.shape[0], spectra.device
        lo = param_lo if param_lo is not None else torch.full((4,), 2.2, device=dev)
        hi = param_hi if param_hi is not None else torch.full((4,), 2.8, device=dev)
        draws = draws or {}
        gen = torch.Generator().manual_seed(int(seed))

        def draw(name, shape, uniform=False):
            if name in draws:
                return draws[name].to(dev)
            fn = torch.rand if uniform else torch.randn
            return fn(shape, generator=gen).to(dev)

        if st.augments:
            spectra = augment_spectra(gen, spectra, noise_level=st.augment_noise,
                                      freq_shift=st.augment_shift,
                                      amp_scale=st.augment_scale)
        g, d, f = state.g.train(), state.d.train(), state.f.eval()
        g_params, d_params = list(g.parameters()), list(d.parameters())

        # G's forward, once for both phases; the BatchNorm stats move here
        pred_norm = squash(g(spectra))
        pred_phys = denormalize_params(pred_norm, lo, hi)

        # ---- D update (train_pigan.py:123-143) -------------------------
        fake_phys = pred_phys.detach()
        cat_spec = torch.cat([spectra, spectra], dim=0)
        cat_par = torch.cat([params_phys, fake_phys], dim=0)
        if st.instance_noise > 0.0:
            cat_spec = cat_spec + st.instance_noise * draw("instance_noise", cat_spec.shape)
        labels = torch.cat([torch.full((b, 1), st.label_real, device=dev),
                            torch.full((b, 1), st.label_fake, device=dev)], dim=0)

        def d_loss_of(logits, with_penalty: bool):
            if not wgan:
                # the reference sums two means: 2x the mean over the concat batch
                return 2.0 * L.bce_logits(logits, labels)
            loss = torch.mean(logits[b:]) - torch.mean(logits[:b])
            if with_penalty:
                # gradient penalty at (clean spectra, interpolated params);
                # per-row gradients are exact: a row of D reads only its own inputs
                eps = draw("gp_eps", (b, 1), uniform=True)
                sp = spectra.detach().clone().requires_grad_(True)
                par = (eps * params_phys + (1.0 - eps) * fake_phys).requires_grad_(True)
                g_spec, g_par = torch.autograd.grad(d(sp, par).sum(), (sp, par),
                                                    create_graph=True)
                norm = torch.sqrt(torch.sum(g_spec**2, dim=1) + torch.sum(g_par**2, dim=1)
                                  + 1e-12)
                loss = loss + st.gp_weight * torch.mean((norm - 1.0) ** 2)
            return loss

        if st.d_update_every <= 1 or state.step % st.d_update_every == 0:
            d_logits = d(cat_spec, cat_par)
            d_loss = d_loss_of(d_logits, with_penalty=True)
            grads = torch.autograd.grad(d_loss, d_params)
            d_tx.update_(torch.cat([x.reshape(-1) for x in grads]), state.d_opt,
                         state.d_params)
        else:
            # skipped: forward only, D and its optimiser untouched; the
            # reported d_loss leaves the penalty out
            with torch.no_grad():
                d_logits = d(cat_spec, cat_par)
                d_loss = d_loss_of(d_logits, with_penalty=False)
        d_logits, d_loss = d_logits.detach(), d_loss.detach()
        # D accuracy at threshold 0.5 (unified_evaluator.py:315-317)
        probs = torch.sigmoid(d_logits)
        d_acc = 0.5 * ((probs[:b] > 0.5).float().mean() + (probs[b:] <= 0.5).float().mean())

        # ---- G update against the just-updated D (train_pigan.py:145-187)
        adv_logits = d(spectra, pred_phys)
        if wgan:
            adv = -torch.mean(adv_logits)
        else:
            adv = L.bce_logits(adv_logits, torch.ones((b, 1), device=dev))  # unsmoothed
        # frozen forward surrogate, eval mode (train_pigan.py:75)
        recon_spec, pred_met = f(pred_norm)
        if st.detach_forward:
            recon_spec, pred_met = recon_spec.detach(), pred_met.detach()
        recon_l = L.mse(recon_spec, spectra)
        met_l = L.mse(pred_met, metrics_norm)
        maxwell_l = L.maxwell_smoothness_loss(recon_spec)
        lc_l = L.lc_approx_loss(pred_met[:, 0:1], pred_met[:, 1:2], pred_norm)
        range_l = L.param_range_loss(pred_norm, st.range_lo, st.range_hi)
        # kl_w multiplies bnn_kl_loss, which is identically zero
        total = (
            st.adv_w * adv
            + st.recon_w * recon_l
            + st.physics_spec_w * recon_l   # double-count parity
            + st.physics_metrics_w * met_l
            + st.maxwell_w * maxwell_l
            + st.lc_w * lc_l
            + st.range_w * range_l
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
            total = total + st.window_w * L.physics_window_loss(
                recon_spec, spectra, pred_met, consistency_weight=0.0, window_weight=1.0)
        if st.stability_w:
            noisy = spectra + st.stability_noise * draw("stability_noise", spectra.shape)
            with frozen_batch_stats(g):
                pred_noisy = squash(g(noisy))
            total = total + st.stability_w * L.stability_loss(pred_norm, pred_noisy)
        if st.cycle_w:
            with frozen_batch_stats(g):
                cycled = squash(g(recon_spec))
            total = total + st.cycle_w * L.cycle_consistency_loss(pred_norm, cycled)

        grads = torch.autograd.grad(total, g_params)
        g_tx.update_(torch.cat([x.reshape(-1) for x in grads]), state.g_opt, state.g_params)
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

    return step


# ---------------------------------------------------------------------------
# The epoch loop
# ---------------------------------------------------------------------------


def make_multi_epoch_fn(step_fn: Callable, batch_size: int):
    """multi_epoch(state, ds, scales, indices=None, seeds=None, draws=None)
    -> (state, {key: (E,) per-epoch mean}) running E whole epochs of
    ``step_fn``.  ``scales`` (E,) is each epoch's scale, passed to the step
    as its third argument: the learning-rate multiplier of the forward step
    (a scale of 1 is exact), the constraint scale of the PI-GAN step (the
    JAX package's ``with_scale=True``).  ``indices`` (E, spe, B) and
    ``seeds`` (E·spe,) default to draws from ``state.generator``
    (``ops.forward_train.resolve_draws``, shared with the kernel paths).
    ``draws``, a sequence of one mapping per step, hands the PI-GAN step
    its noise instead of its own generator's."""

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
                state, m = step_fn(state, batch, scale, int(seeds[t]), *extra)
                for k, v in m.items():
                    sums.setdefault(k, []).append(v)
            for k, v in sums.items():
                rows.setdefault(k, []).append(torch.stack(v).mean())
        return state, {k: torch.stack(v) for k, v in rows.items()}

    return multi_epoch
