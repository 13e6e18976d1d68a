"""The plain reference of the training steps: F's pretraining step and the
typed D-then-G PI-GAN step, with clip-by-global-norm Adam and the schedules.

A frozen copy of the math of jianghu105/PI-GAN-THz
``core/train/pretrain_fwd_model.py:68-92`` (F: MSE on the spectrum plus MSE
on the normalised metrics, dropout 0.2, Adam b1 0.9, cosine to 0) and
``core/train/train_pigan.py:123-187`` (D on real and generated parameters
with smoothed labels, the reference's sum of two means; then G against the
updated D, the frozen F in eval mode, the typed loss mix with the
reconstruction term counted twice; Adam b1 0.5, G cosine to 0.01x, D halved
every quarter; both clipped to a global norm of 1), written from the
configuration alone.  Gradients come from autograd over
``reference.models.run``.  It imports nothing of the program.

F's dropout keeps an entry where a counter hash of (step seed, layer, row,
column) falls below the keep threshold: the hash (lowbias32) is part of the
input the benchmark hands both sides, as the step seeds are.
"""

from __future__ import annotations

import math

import torch

from . import models as M

_M32 = 0xFFFFFFFF
_C1, _C2 = 0x7FEB352D, 0x846CA68B


def _mix_int(x: int) -> int:
    x &= _M32
    x ^= x >> 16
    x = (x * _C1) & _M32
    x ^= x >> 15
    x = (x * _C2) & _M32
    return x ^ (x >> 16)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 15)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def dropout_factors(seed: int, layer: int, shape: tuple, rate: float, device) -> torch.Tensor:
    """(rows, cols) float32: 1 / keep where kept, else 0."""
    rows, cols = shape[0], math.prod(shape[1:])
    h = _mix_int(_mix_int(seed) ^ layer)
    r = _mix(torch.arange(rows, dtype=torch.int64, device=device) ^ h)
    bits = _mix(r[:, None] ^ torch.arange(cols, dtype=torch.int64, device=device)[None, :])
    keep = bits < min(2**32 - 1, int(round((1.0 - rate) * 2**32)))
    return torch.where(keep, 1.0 / (1.0 - rate), 0.0).to(torch.float32).view(shape)


# ---------------------------------------------------------------------------
# Optimiser and schedules
# ---------------------------------------------------------------------------


def cosine_lr(base: float, decay_steps: int, alpha: float, count: int) -> float:
    t = min(count, decay_steps)
    return base * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps)) + alpha)


def step_lr(base: float, every: int, rate: float, count: int) -> float:
    return base * rate ** (count // every)


class Adam:
    """clip_by_global_norm(clip) then Adam, over a dict of leaves."""

    def __init__(self, params: dict, b1: float, clip: float, b2: float = 0.999,
                 eps: float = 1e-8):
        self.b1, self.b2, self.eps, self.clip = b1, b2, eps, clip
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0
        self.first_grad: dict | None = None     # the clipped gradient of step 1

    @torch.no_grad()
    def update_(self, params: dict, grads: dict, lr: float) -> None:
        norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
        scale = 1.0 if norm < self.clip else self.clip / norm
        if self.first_grad is None:
            self.first_grad = {k: g * scale for k, g in grads.items()}
        t = self.count + 1
        bc1, bc2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        for k, p in params.items():
            g = grads[k] * scale
            self.m[k].mul_(self.b1).add_((1.0 - self.b1) * g)
            self.v[k].mul_(self.b2).add_((1.0 - self.b2) * g * g)
            p.sub_(lr * (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + self.eps))
        self.count += 1


def _grads(loss: torch.Tensor, params: dict) -> dict:
    keys = list(params)
    gs = torch.autograd.grad(loss, [params[k] for k in keys])
    return dict(zip(keys, gs))


def _leaves(w: dict, layout) -> dict:
    return {name: w[name].detach().clone().requires_grad_(True) for name, _, _ in layout}


# ---------------------------------------------------------------------------
# F's pretraining step
# ---------------------------------------------------------------------------


class ForwardTrainer:
    """F from weights ``w``, trained step by step on given batches."""

    def __init__(self, cfg: dict, w: dict, decay_steps: int, precision: str = "fp32"):
        self.cfg, self.precision = cfg, precision
        self.ops = M.forward_layers(cfg)
        self.layout = M.param_layout(self.ops)
        self.params = _leaves(w, self.layout)
        tc = cfg["train"]
        self.opt = Adam(self.params, b1=0.9, clip=tc["grad_clip"])
        self.base_lr, self.decay_steps = tc["fwd_lr"], decay_steps
        self.losses: list[float] = []

    def step(self, spectra, params_norm, metrics_norm, seed: int, batch_cut: int | None = None):
        """One step; ``batch_cut`` keeps only the first rows (a planted fault)."""
        s = self.cfg["spectrum_dim"]
        if batch_cut is not None:
            spectra, params_norm, metrics_norm = (t[:batch_cut] for t in
                                                  (spectra, params_norm, metrics_norm))
        dev = spectra.device

        def masks(i, shape, rate):
            return dropout_factors(seed, i, shape, rate, dev)

        out = M.run(self.ops, self.params, params_norm, train=True, masks=masks,
                    precision=self.precision)
        loss = torch.mean((out[:, :s] - spectra) ** 2) + torch.mean((out[:, s:] - metrics_norm) ** 2)
        grads = _grads(loss, self.params)
        lr = cosine_lr(self.base_lr, self.decay_steps, 0.0, self.opt.count)
        self.opt.update_(self.params, grads, lr)
        self.losses.append(float(loss.detach()))


# ---------------------------------------------------------------------------
# The typed D-then-G PI-GAN step
# ---------------------------------------------------------------------------


def bce_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(logits.clamp(min=0.0) - logits * target
                      + torch.log1p(torch.exp(-logits.abs())))


class GanTrainer:
    """G and D from ``w_g``, ``w_d`` against the frozen F ``w_f``, trained
    step by step as typed (BCE, ``detach_forward``, no dropout, no noise)."""

    def __init__(self, cfg: dict, w_g: dict, w_d: dict, w_f: dict, g_decay_steps: int,
                 d_every: int, precision: str = "fp32"):
        if not cfg["train"]["detach_forward"]:
            raise ValueError("the reference GAN step is the typed one: detach_forward")
        self.cfg, self.precision = cfg, precision
        self.g_ops, self.d_ops = M.generator_layers(cfg), M.discriminator_layers(cfg)
        self.f_ops = M.forward_layers(cfg)
        self.g = _leaves(w_g, M.param_layout(self.g_ops))
        self.d = _leaves(w_d, M.param_layout(self.d_ops))
        self.f = {k: v.detach() for k, v in w_f.items()}
        tc = cfg["train"]
        self.g_opt = Adam(self.g, b1=0.5, clip=tc["grad_clip"])
        self.d_opt = Adam(self.d, b1=0.5, clip=tc["grad_clip"])
        self.g_decay_steps, self.d_every = g_decay_steps, d_every
        self.d_losses: list[float] = []
        self.g_losses: list[float] = []

    def step(self, spectra, params_phys, metrics_norm, batch_cut: int | None = None):
        cfg, tc, lw = self.cfg, self.cfg["train"], self.cfg["loss"]
        s, prec = cfg["spectrum_dim"], self.precision
        if batch_cut is not None:
            spectra, params_phys, metrics_norm = (t[:batch_cut] for t in
                                                  (spectra, params_phys, metrics_norm))
        b, dev = spectra.shape[0], spectra.device
        pred_norm = M.run(self.g_ops, self.g, spectra, train=True, precision=prec)
        pred_phys = M.denormalize_params(pred_norm, cfg)

        # D on (real, generated) with smoothed labels: the sum of two means
        cat_spec = torch.cat([spectra, spectra])
        cat_par = torch.cat([params_phys, pred_phys.detach()])
        labels = torch.cat([torch.full((b, 1), tc["label_real"], device=dev),
                            torch.full((b, 1), tc["label_fake"], device=dev)])
        d_logits = M.run(self.d_ops, self.d, torch.cat([cat_spec, cat_par], dim=1),
                         precision=prec)
        d_loss = 2.0 * bce_logits(d_logits, labels)
        d_lr = step_lr(tc["lr_d"], self.d_every, 0.5, self.d_opt.count)
        self.d_opt.update_(self.d, _grads(d_loss, self.d), d_lr)

        # G against the updated D, the frozen F in eval mode (detached)
        adv_logits = M.run(self.d_ops, self.d, torch.cat([spectra, pred_phys], dim=1),
                           precision=prec)
        adv = bce_logits(adv_logits, torch.ones((b, 1), device=dev))
        with torch.no_grad():
            f_out = M.run(self.f_ops, self.f, pred_norm.detach(), precision=prec)
        recon_spec, pred_met = f_out[:, :s], f_out[:, s:]
        recon = torch.mean((recon_spec - spectra) ** 2)
        met = torch.mean((pred_met - metrics_norm) ** 2)
        d1 = recon_spec[:, 1:] - recon_spec[:, :-1]
        maxwell = torch.mean((d1[:, 1:] - d1[:, :-1]) ** 2)
        r1, r2, w, g = pred_norm.unbind(dim=1)
        lc = (torch.mean((pred_met[:, 0] - (0.4 * r1 + 0.6 * w)) ** 2)
              + torch.mean((pred_met[:, 1] - (0.3 * r2 + 0.7 * g)) ** 2))
        rng = torch.mean((0.0 - pred_norm).clamp(min=0.0) ** 2
                         + (pred_norm - 1.0).clamp(min=0.0) ** 2)
        total = (lw["adversarial"] * adv + lw["recon"] * recon + lw["physics_spectrum"] * recon
                 + lw["physics_metrics"] * met + lw["maxwell"] * maxwell + lw["lc"] * lc
                 + lw["param_range"] * rng)
        g_lr = cosine_lr(tc["lr_g"], self.g_decay_steps, 0.01, self.g_opt.count)
        self.g_opt.update_(self.g, _grads(total, self.g), g_lr)
        self.d_losses.append(float(d_loss.detach()))
        self.g_losses.append(float(total.detach()))
