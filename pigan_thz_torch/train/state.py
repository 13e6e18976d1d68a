"""Training state of the forward surrogate: one flat fp32 buffer.

The port of ``pigan_thz_tpu/train/state.py`` for the forward-pretraining
path.  ``ForwardState`` holds F as an ``nn.Module`` whose parameters are
views into one contiguous (P,) fp32 buffer, laid out in the module's
``named_parameters`` order (the reference torch layout: each Linear's
(out, in) weight, then its bias, each LayerNorm's weight and bias).  Adam's
moments ``m`` and ``v`` are (P,) buffers beside it.  So the eager step, the
plain version of the training kernel and the kernel all update the same
memory in place, and "packing" the state for the kernel costs no copy.

The state's ``generator`` is a CPU ``torch.Generator``: it draws each
epoch's shuffle and each step's dropout seed, so one seed gives the same
batches and masks on every device.

``make_optimizers`` builds the three models' optimisers from the config
(cosine for G, step decay for D, cosine to 0 for F), as the JAX package
does.  G and D come with the GAN slice.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
from torch import nn

from ..config import PiGanConfig
from ..models.blocks import flax_init_
from .schedules import AdamState, ClipAdam, build_optimizer


def flat_layout(module: nn.Module) -> list[tuple[str, int, tuple[int, ...]]]:
    """(name, float offset, shape) of each parameter in the flat buffer."""
    out, pos = [], 0
    for name, p in module.named_parameters():
        out.append((name, pos, tuple(p.shape)))
        pos += p.numel()
    return out


def bind_flat_(module: nn.Module, flat: torch.Tensor) -> nn.Module:
    """Make ``module``'s parameters views into ``flat`` (copying their
    current values in first).  Moving the module afterwards (``.to``)
    breaks the binding: bind on the training device."""
    layout = flat_layout(module)
    size = num_params(module)
    if flat.shape != (size,) or flat.dtype != torch.float32 or not flat.is_contiguous():
        raise ValueError(f"flat buffer must be contiguous float32 ({size},)")
    with torch.no_grad():
        for (_, off, shape), p in zip(layout, module.parameters()):
            view = flat[off: off + p.numel()].view(shape)
            view.copy_(p.detach().to(flat.device))
            p.data = view
    return module


def num_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


@dataclass
class ForwardState:
    """Forward-surrogate pretraining state.

    ``step`` counts the steps taken; ``f``'s parameters are views into
    ``params``; ``opt`` holds Adam's m, v and count; ``generator`` draws the
    shuffles and dropout seeds.  Training updates all of it in place."""

    step: int
    f: nn.Module
    params: torch.Tensor
    opt: AdamState
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return self.params.device

    def clone(self) -> "ForwardState":
        """An independent copy (module, buffers and generator state)."""
        f = copy.deepcopy(self.f)
        params = self.params.clone()
        bind_flat_(f, params)
        gen = torch.Generator()
        gen.set_state(self.generator.get_state())
        return ForwardState(self.step, f, params, self.opt.clone(), gen)

    def is_finite(self) -> bool:
        """True iff parameters and both moments are all finite."""
        return bool(
            torch.isfinite(self.params).all()
            & torch.isfinite(self.opt.m).all()
            & torch.isfinite(self.opt.v).all()
        )


def init_forward_state(
    model: nn.Module,
    tx: ClipAdam,
    seed: int,
    *,
    device: torch.device | str | None = None,
) -> ForwardState:
    """Initialise ``model`` with flax's scheme from a CPU generator seeded
    with ``seed``, bind it to a fresh flat buffer on ``device`` (default:
    where the model is), and start Adam at zero.  The same generator then
    draws the training run's shuffles and dropout seeds."""
    gen = torch.Generator().manual_seed(seed)
    model = flax_init_(model.cpu(), gen)
    if device is None:
        device = next(iter(model.parameters())).device
    params = torch.empty(num_params(model), dtype=torch.float32, device=device)
    bind_flat_(model, params)
    return ForwardState(step=0, f=model, params=params, opt=tx.init(params), generator=gen)


def make_optimizers(cfg: PiGanConfig, steps_per_epoch: int):
    """(g_tx, d_tx, f_tx) from the run config, reproducing the reference's
    scheduler pairing: cosine for G, step decay for D, cosine to 0 for F."""
    epochs = cfg.train.num_epochs
    g_tx = build_optimizer(
        lr=cfg.train.lr_g,
        total_epochs=epochs,
        steps_per_epoch=steps_per_epoch,
        schedule="cosine",
        b1=0.5,
        grad_clip=cfg.train.grad_clip,
        adam_state_dtype=cfg.train.adam_state_dtype,
    )
    d_tx = build_optimizer(
        lr=cfg.train.lr_d,
        total_epochs=epochs,
        steps_per_epoch=steps_per_epoch,
        schedule="step",
        b1=0.5,
        grad_clip=cfg.train.grad_clip,
        adam_state_dtype=cfg.train.adam_state_dtype,
    )
    f_tx = build_optimizer(
        lr=cfg.train.fwd_pretrain_lr,
        total_epochs=cfg.train.fwd_pretrain_epochs,
        steps_per_epoch=steps_per_epoch,
        schedule="cosine",
        b1=0.9,
        grad_clip=cfg.train.grad_clip,
        schedule_alpha=0.0,   # torch CosineAnnealingLR default eta_min=0
        adam_state_dtype=cfg.train.adam_state_dtype,
    )
    return g_tx, d_tx, f_tx
