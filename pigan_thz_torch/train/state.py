"""Training states: each trained model in one flat fp32 buffer.

The port of ``pigan_thz_tpu/train/state.py``.  ``ForwardState`` holds F as an ``nn.Module`` whose parameters are
views into one contiguous (P,) fp32 buffer, laid out in the module's
``named_parameters`` order (the reference torch layout: each Linear's
(out, in) weight, then its bias, each LayerNorm's weight and bias).  Adam's
moments ``m`` and ``v`` are (P,) buffers beside it.  So the eager step, the
plain version of the training kernel and the kernel all update the same
memory in place, and "packing" the state for the kernel costs no copy.

The state's ``generator`` is a CPU ``torch.Generator``: it draws each
epoch's shuffle and each step's dropout seed, so one seed gives the same
batches and masks on every device.

``PiGanState`` is the GAN phase's state in the same form: G and D each a
module over a flat buffer with Adam's moments and a count of its own, G's
BatchNorm running stats in the module's buffers, the frozen F (a copy in
eval mode over a flat buffer of its own, no gradients), an optional EMA of
G's flat buffer, the step count and the generator.

``make_optimizers`` builds the three models' optimisers from the config
(cosine for G, step decay for D, cosine to 0 for F), as the JAX package
does.

Each state's ``state_dict`` names everything training reads and updates
(the step, the flat buffers, Adam's moments and counts, the modules'
buffers, the EMA, the generator's state), and ``load_state_dict_`` copies a
payload back into the state's own buffers: the modules' parameters are
views into those buffers, so assigning new tensors would unbind them from
the memory that the kernels and the eager step update.  The checkpoint
manager (``checkpoint.py``) saves and restores through these two.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
from torch import nn

from ..config import PiGanConfig
from ..models.blocks import flax_init_
from ..utils.profiling import host_bool
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


def _module_buffers(prefix: str, module: nn.Module) -> dict:
    """``module``'s buffers (BatchNorm running stats and counts) by name."""
    return {f"{prefix}.{name}": buf for name, buf in module.named_buffers()}


def _signature(payload: dict) -> dict:
    return {k: tuple(v.shape) if isinstance(v, torch.Tensor) else type(v).__name__
            for k, v in payload.items()}


def _load_payload_(own: dict, payload: dict, what: str) -> None:
    """Check ``payload`` against ``own`` (a state's ``state_dict``) key by
    key and shape by shape, then copy its tensors into ``own``'s in place
    (the generator's state aside: the caller sets it)."""
    if _signature(payload) != _signature(own):
        raise ValueError(
            f"the checkpoint does not match the {what} it is loaded into.\n"
            f"  loaded:   {_signature(payload)}\n  expected: {_signature(own)}")
    with torch.no_grad():
        for key, dst in own.items():
            if isinstance(dst, torch.Tensor) and key != "generator":
                dst.copy_(payload[key])


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
        return host_bool(
            torch.isfinite(self.params).all()
            & torch.isfinite(self.opt.m).all()
            & torch.isfinite(self.opt.v).all()
        )

    def state_dict(self) -> dict:
        """The step, F's flat buffer, Adam's m, v and count, F's buffers and
        the generator's state (a CPU ``ByteTensor``); the tensors are the
        state's own, not copies."""
        return {"step": self.step, "params": self.params, "opt.m": self.opt.m,
                "opt.v": self.opt.v, "opt.count": self.opt.count,
                **_module_buffers("f", self.f), "generator": self.generator.get_state()}

    def load_state_dict_(self, payload: dict) -> None:
        """Copy ``payload`` (a ``state_dict``, from any device) into this
        state in place; a payload of another architecture raises
        ``ValueError`` with both sets of shapes."""
        _load_payload_(self.state_dict(), payload, "ForwardState")
        self.step, self.opt.count = int(payload["step"]), int(payload["opt.count"])
        self.generator.set_state(payload["generator"].cpu())


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


def _clone_bound(module: nn.Module, flat: torch.Tensor) -> tuple[nn.Module, torch.Tensor]:
    """A deep copy of ``module`` bound to a copy of ``flat``."""
    module, flat = copy.deepcopy(module), flat.clone()
    bind_flat_(module, flat)
    return module, flat


@dataclass
class PiGanState:
    """PI-GAN training state (G + D + frozen F + both optimisers).

    ``g``, ``d`` and ``f`` have their parameters in ``g_params``,
    ``d_params`` and ``f_params``; what flax keeps in ``batch_stats`` (G's
    BatchNorm running stats, the conv stack's too; D's spectral-norm ``u``
    and ``sigma``) are the modules' buffers.  ``g_ema`` optionally carries an exponential moving
    average of ``g_params`` (``StepSettings.ema_decay`` > 0).  Training
    updates all of it in place."""

    step: int
    g: nn.Module
    d: nn.Module
    f: nn.Module
    g_params: torch.Tensor
    d_params: torch.Tensor
    f_params: torch.Tensor
    g_opt: AdamState
    d_opt: AdamState
    generator: torch.Generator
    g_ema: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.g_params.device

    def batch_norms(self) -> list[nn.Module]:
        """G's BatchNorm layers, in order."""
        return [m for m in self.g.modules() if isinstance(m, nn.BatchNorm1d)]

    def clone(self) -> "PiGanState":
        """An independent copy (modules, buffers and generator state)."""
        g, g_params = _clone_bound(self.g, self.g_params)
        d, d_params = _clone_bound(self.d, self.d_params)
        f, f_params = _clone_bound(self.f, self.f_params)
        gen = torch.Generator()
        gen.set_state(self.generator.get_state())
        return PiGanState(
            self.step, g, d, f, g_params, d_params, f_params, self.g_opt.clone(),
            self.d_opt.clone(), gen,
            None if self.g_ema is None else self.g_ema.clone())

    def is_finite(self) -> bool:
        """True iff G's and D's parameters and moments, their floating
        buffers (BatchNorm stats, spectral norm's ``u`` and ``sigma``) and
        the EMA are all finite."""
        tensors = [self.g_params, self.d_params, self.g_opt.m, self.g_opt.v,
                   self.d_opt.m, self.d_opt.v]
        tensors += [t for m in (self.g, self.d) for t in m.buffers() if t.is_floating_point()]
        if self.g_ema is not None:
            tensors.append(self.g_ema)
        return all(host_bool(torch.isfinite(t).all()) for t in tensors)

    def state_dict(self) -> dict:
        """The step, G's, D's and F's flat buffers, both Adams' m, v and
        count, the modules' buffers (BatchNorm running stats and counts,
        spectral norm's ``u`` and ``sigma``), ``g_ema`` when the state carries one and the generator's
        state (a CPU ``ByteTensor``); the tensors are the state's own."""
        payload = {"step": self.step, "g_params": self.g_params, "d_params": self.d_params,
                   "f_params": self.f_params}
        for name, opt in (("g_opt", self.g_opt), ("d_opt", self.d_opt)):
            payload.update({f"{name}.m": opt.m, f"{name}.v": opt.v, f"{name}.count": opt.count})
        for name in ("g", "d", "f"):
            payload.update(_module_buffers(name, getattr(self, name)))
        if self.g_ema is not None:
            payload["g_ema"] = self.g_ema
        payload["generator"] = self.generator.get_state()
        return payload

    def load_state_dict_(self, payload: dict) -> None:
        """Copy ``payload`` into this state in place.  A payload with
        ``g_ema`` gives a state without one the track, and a payload without
        it drops the state's: a checkpoint of an EMA run resumes into a
        plain state and the reverse.  A payload of another architecture
        raises ``ValueError`` with both sets of shapes."""
        own = self.state_dict()
        own.pop("g_ema", None)
        rest = {k: v for k, v in payload.items() if k != "g_ema"}
        ema = payload.get("g_ema")
        if ema is not None and tuple(ema.shape) != tuple(self.g_params.shape):
            raise ValueError(f"the checkpoint's g_ema has shape {tuple(ema.shape)}, the "
                             f"generator {tuple(self.g_params.shape)}")
        _load_payload_(own, rest, "PiGanState")
        self.step = int(payload["step"])
        self.g_opt.count, self.d_opt.count = (int(payload["g_opt.count"]),
                                              int(payload["d_opt.count"]))
        if ema is None:
            self.g_ema = None
        elif self.g_ema is None:
            self.g_ema = ema.to(self.device, torch.float32).clone()
        else:
            self.g_ema.copy_(ema)
        self.generator.set_state(payload["generator"].cpu())

    def set_forward_(self, forward_model: nn.Module) -> None:
        """Refresh the frozen F with ``forward_model``'s weights (a copy)."""
        with torch.no_grad():
            for dst, src in zip(self.f.parameters(), forward_model.parameters()):
                dst.copy_(src.to(dst.device))


def init_pigan_state(
    generator: nn.Module,
    discriminator: nn.Module,
    forward_model: nn.Module,
    g_tx: ClipAdam,
    d_tx: ClipAdam,
    seed: int | torch.Generator,
    *,
    device: torch.device | str,
    fresh_forward: bool = False,
    ema: bool = False,
) -> PiGanState:
    """Initialise G and D with flax's scheme from a CPU generator seeded with
    ``seed``, or from ``seed`` itself when it is a CPU ``torch.Generator``
    (G first, then D), bind each to a fresh flat buffer on
    ``device`` and start both Adams at zero.  F is a copy of
    ``forward_model`` as it stands (pretrained weights), or freshly
    initialised from the same generator with ``fresh_forward``; it is put in
    eval mode and takes no gradients.  ``ema`` adds an EMA track seeded at
    G's initial parameters.  The generator then draws the run's shuffles and
    step seeds."""
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
    out = []
    for module in (generator, discriminator):
        module = flax_init_(copy.deepcopy(module).cpu(), gen)
        params = torch.empty(num_params(module), dtype=torch.float32, device=device)
        bind_flat_(module, params)
        for buf in module.buffers():          # BatchNorm stats; .to() would rebind
            buf.data = buf.data.to(device)
        out.append((module, params))
    f = copy.deepcopy(forward_model).cpu()
    if fresh_forward:
        flax_init_(f, gen)
    f_params = torch.empty(num_params(f), dtype=torch.float32, device=device)
    bind_flat_(f, f_params)
    f.requires_grad_(False).eval()
    (g, g_params), (d, d_params) = out
    return PiGanState(
        step=0, g=g, d=d, f=f, g_params=g_params, d_params=d_params, f_params=f_params,
        g_opt=g_tx.init(g_params), d_opt=d_tx.init(d_params), generator=gen,
        g_ema=g_params.clone() if ema else None)


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
