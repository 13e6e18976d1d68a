"""Learning-rate schedules and the hand-written optimiser of the JAX package.

The port of ``pigan_thz_tpu/train/schedules.py``.  Reference pairing
(per-epoch torch schedulers re-expressed per optimiser step):
- G: Adam(2e-4, betas=(0.5, 0.999)) + cosine to 0.01× (train_pigan.py:56,61);
- D: Adam(2e-4) + StepLR halving every quarter of the run (:57,62);
- F pretrain: Adam(1e-3, b1 0.9) + cosine to 0 (pretrain_fwd_model.py:44-48);
- all three clip gradients to global norm 1.0 (train_pigan.py:142,186).

Schedules are functions of the optimiser's step count (an int or an int
tensor) returning float32, with optax's formulas evaluated in float32, so
the same count gives the same learning rate as the JAX package.

``ClipAdam`` is the optax chain clip_by_global_norm -> Adam(W) -> schedule
that ``build_optimizer`` builds there, on one flat fp32 parameter buffer,
updated in place.  It is not ``torch.optim.Adam`` plus ``clip_grad_norm_``
(ROADMAP.md queue 3): optax scales by clip/‖g‖ only when ‖g‖ ≥ clip (torch
divides by ‖g‖ + 1e-6 always), bias corrections use count + 1, the learning
rate is read at the count before the increment, and an ``lr_scale``
multiplies the final update.

``ReduceLROnPlateau`` is host-side only and a copy of the JAX package's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

Schedule = Callable[["int | torch.Tensor"], torch.Tensor]


def _count(count) -> torch.Tensor:
    return torch.as_tensor(count).to(torch.float32)


def cosine_schedule(
    base_lr: float, total_epochs: int, steps_per_epoch: int, alpha: float = 0.01
) -> Schedule:
    """CosineAnnealingLR: lr decays to alpha * base_lr over the run
    (optax.cosine_decay_schedule)."""
    decay_steps = float(max(1, total_epochs * steps_per_epoch))

    def schedule(count) -> torch.Tensor:
        t = torch.clamp(_count(count), max=decay_steps)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * t / decay_steps))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def step_schedule(
    base_lr: float,
    total_epochs: int,
    steps_per_epoch: int,
    decay_rate: float = 0.5,
    decay_every_frac: float = 0.25,
) -> Schedule:
    """StepLR with step_size = total_epochs * decay_every_frac epochs
    (optax.exponential_decay, staircase)."""
    every = max(1, int(total_epochs * decay_every_frac) * steps_per_epoch)

    def schedule(count) -> torch.Tensor:
        t = _count(count)
        decayed = base_lr * torch.pow(
            torch.tensor(decay_rate, dtype=torch.float32), torch.floor(t / every)
        )
        return torch.where(t <= 0, torch.tensor(base_lr, dtype=torch.float32), decayed)

    return schedule


def _linear(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule (polynomial of power 1)."""

    def schedule(count) -> torch.Tensor:
        if transition_steps <= 0:
            return torch.full_like(_count(count), init_value)
        t = torch.clamp(_count(count), 0.0, float(transition_steps))
        return (init_value - end_value) * (1.0 - t / transition_steps) + end_value

    return schedule


def linear_schedule(
    base_lr: float, total_epochs: int, steps_per_epoch: int, end_frac: float = 0.1
) -> Schedule:
    """LinearLR analogue of the constraint trainer's per-mode policies
    (unified_constraint_trainer.py:196-214)."""
    return _linear(base_lr, base_lr * end_frac, max(1, total_epochs * steps_per_epoch))


def warmup_cosine_schedule(
    base_lr: float, total_epochs: int, steps_per_epoch: int, alpha: float = 0.01
) -> Schedule:
    """Linear warmup from 0 over the first 5 % of steps to base_lr, then a
    cosine decay to alpha * base_lr (optax.warmup_cosine_decay_schedule)."""
    total = max(1, total_epochs * steps_per_epoch)
    warmup = max(1, int(0.05 * total))
    ramp = _linear(0.0, base_lr, warmup)
    decay_steps = float(total - warmup)
    if not decay_steps > 0:
        raise ValueError(f"warmup_cosine needs more than {warmup} steps, got {total}")

    def decay(count) -> torch.Tensor:
        t = torch.clamp(_count(count), max=decay_steps)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * t / decay_steps))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    def schedule(count) -> torch.Tensor:
        t = torch.as_tensor(count)
        return torch.where(t < warmup, ramp(t), decay(t - warmup))

    return schedule


def constant_schedule(base_lr: float) -> Schedule:
    def schedule(count) -> torch.Tensor:
        return torch.full_like(_count(count), base_lr)

    return schedule


class ReduceLROnPlateau:
    """Metric-reactive LR controller, ``torch.optim.lr_scheduler.
    ReduceLROnPlateau`` semantics re-expressed for chunked training.

    The reference's emergency forward recovery drives its LR with this
    scheduler (emergency_trainer.py:131-133: factor 0.5, patience 20, mode
    'min'); the defaults mirror that call.  Schedules are step-count
    functions, so the controller emits a runtime *scale* multiplying the
    schedule instead of mutating an optimiser: ``step(metric)`` is called
    once per epoch, and the Trainer applies the latest scale to the next
    chunk of epochs (epoch-granular accounting, chunk-granular application).

    A new best resets the bad-epoch count; ``num_bad > patience`` multiplies
    the scale by ``factor`` (floored at ``min_scale``, skipped within
    ``eps``) and starts ``cooldown`` epochs during which bad epochs do not
    accumulate.  Host-side state only: ``state_dict()`` /
    ``load_state_dict()`` carry it across a resume.
    """

    def __init__(
        self,
        factor: float = 0.5,
        patience: int = 20,
        threshold: float = 1e-4,
        threshold_mode: str = "rel",
        cooldown: int = 0,
        min_scale: float = 0.0,
        mode: str = "min",
        eps: float = 1e-8,
        base_lr: float | None = None,
    ):
        if not 0.0 < factor < 1.0:
            raise ValueError("factor must be in (0, 1)")
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode!r}: use min | max")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(f"threshold_mode {threshold_mode!r}: use rel | abs")
        self.factor = float(factor)
        self.patience = int(patience)
        self.threshold = float(threshold)
        self.threshold_mode = threshold_mode
        self.cooldown = int(cooldown)
        self.min_scale = float(min_scale)
        self.mode = mode
        self.eps = float(eps)
        # torch's eps guard compares LR deltas in absolute LR units; with
        # base_lr given the guard is exact, without it it applies to the
        # scale itself
        self.base_lr = None if base_lr is None else float(base_lr)
        self.scale = 1.0
        self.best = float("inf") if mode == "min" else float("-inf")
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        self.num_reductions = 0

    def _is_better(self, a: float, best: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < best * (1.0 - self.threshold)
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best * (1.0 + self.threshold)
        return a > best + self.threshold

    def step(self, metric: float) -> float:
        """Observe one epoch's metric; returns the (possibly reduced)
        current LR scale.  NaN counts as a bad epoch, as in torch."""
        current = float(metric)
        if self._is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_scale = max(self.scale * self.factor, self.min_scale)
            unit = self.base_lr if self.base_lr is not None else 1.0
            if (self.scale - new_scale) * unit > self.eps:
                self.scale = new_scale
                self.num_reductions += 1
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.scale

    def state_dict(self) -> dict:
        return {
            "scale": self.scale,
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
            "cooldown_counter": self.cooldown_counter,
            "num_reductions": self.num_reductions,
        }

    def load_state_dict(self, state: dict) -> None:
        self.scale = float(state["scale"])
        self.best = float(state["best"])
        self.num_bad_epochs = int(state["num_bad_epochs"])
        self.cooldown_counter = int(state["cooldown_counter"])
        self.num_reductions = int(state.get("num_reductions", 0))


def make_schedule(
    kind: str,
    lr: float,
    total_epochs: int,
    steps_per_epoch: int,
    schedule_alpha: float = 0.01,
    step_decay_rate: float = 0.5,
    step_decay_every_frac: float = 0.25,
) -> Schedule:
    """The one kind -> schedule dispatch, used by ``build_optimizer`` and by
    the forward-training kernel's precomputed learning-rate stream."""
    if kind == "cosine":
        return cosine_schedule(lr, total_epochs, steps_per_epoch, schedule_alpha)
    if kind == "warmup_cosine":
        return warmup_cosine_schedule(lr, total_epochs, steps_per_epoch, schedule_alpha)
    if kind == "step":
        return step_schedule(
            lr, total_epochs, steps_per_epoch, step_decay_rate, step_decay_every_frac
        )
    if kind == "linear":
        return linear_schedule(lr, total_epochs, steps_per_epoch)
    if kind == "constant":
        return constant_schedule(lr)
    raise ValueError(f"unknown schedule: {kind!r}")


# ---------------------------------------------------------------------------
# clip_by_global_norm -> Adam(W) -> schedule, on one flat buffer
# ---------------------------------------------------------------------------


@dataclass
class AdamState:
    """Adam's moments beside a flat (P,) parameter buffer, and its count
    (the number of updates taken)."""

    m: torch.Tensor
    v: torch.Tensor
    count: int = 0

    def clone(self) -> "AdamState":
        return AdamState(self.m.clone(), self.v.clone(), self.count)


@dataclass(frozen=True)
class ClipAdam:
    """optax.chain(clip_by_global_norm(grad_clip), adam(schedule)) — or
    adamw with ``weight_decay`` > 0 — over one flat fp32 buffer.

    ``state_dtype`` "bfloat16" is the JAX package's ``scale_by_adam_bf16``:
    the recurrence runs in float32 and the update uses its float32 moments,
    then the stored m and v are rounded to bfloat16 (round to nearest even;
    the buffers stay float32 tensors that hold bfloat16 values).  It takes
    no weight decay.  The training kernels refuse it, as the TPU kernels do:
    it runs on the eager step."""

    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1.0
    weight_decay: float = 0.0
    state_dtype: str = "float32"

    def __post_init__(self):
        if self.state_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"adam_state_dtype {self.state_dtype!r}: use float32 | bfloat16")
        if self.state_dtype == "bfloat16" and self.weight_decay > 0:
            raise ValueError("adam_state_dtype='bfloat16' does not support weight_decay")

    def init(self, params: torch.Tensor) -> AdamState:
        return AdamState(torch.zeros_like(params), torch.zeros_like(params), 0)

    @torch.no_grad()
    def update_(
        self,
        grads: torch.Tensor,
        state: AdamState,
        params: torch.Tensor,
        lr_scale: float | torch.Tensor | None = None,
        sq_norm=None,
    ) -> None:
        """One optimiser step, in place on ``params`` and ``state``.
        ``sq_norm`` (g -> the squared global norm) stands in for Σg² where
        ``grads`` is one rank's part of a gradient split over a model axis
        (``parallel/tensor.py:ShardPlan.sq_norm``)."""
        g = grads
        if self.grad_clip > 0:
            norm = torch.sqrt(torch.sum(g * g) if sq_norm is None else sq_norm(g))
            g = torch.where(norm < self.grad_clip, g, g / norm * self.grad_clip)
        m = (1.0 - self.b1) * g + self.b1 * state.m
        v = (1.0 - self.b2) * g * g + self.b2 * state.v
        # in the buffer's dtype: float32 as optax computes them, float64 for
        # a float64 buffer (tests/test_torch_reference_run.py's audit)
        t = torch.tensor(state.count + 1, dtype=params.dtype)
        bc1 = 1.0 - torch.pow(torch.tensor(self.b1, dtype=params.dtype), t)
        bc2 = 1.0 - torch.pow(torch.tensor(self.b2, dtype=params.dtype), t)
        dev = params.device
        upd = (m / bc1.to(dev)) / (torch.sqrt(v / bc2.to(dev)) + self.eps)
        if self.state_dtype == "bfloat16":
            m, v = m.to(torch.bfloat16), v.to(torch.bfloat16)
        state.m.copy_(m)
        state.v.copy_(v)
        if self.weight_decay > 0:
            upd = upd + self.weight_decay * params
        upd = upd * (-self.schedule(state.count)).to(dev)
        if lr_scale is not None:
            upd = upd * lr_scale
        params.add_(upd)
        state.count += 1


def build_optimizer(
    lr: float,
    total_epochs: int,
    steps_per_epoch: int,
    schedule: str = "cosine",
    b1: float = 0.5,
    b2: float = 0.999,
    eps: float = 1e-8,
    grad_clip: float = 1.0,
    weight_decay: float = 0.0,
    schedule_alpha: float = 0.01,
    step_decay_rate: float = 0.5,
    step_decay_every_frac: float = 0.25,
    adam_state_dtype: str = "float32",
) -> ClipAdam:
    sched = make_schedule(
        schedule, lr, total_epochs, steps_per_epoch,
        schedule_alpha=schedule_alpha, step_decay_rate=step_decay_rate,
        step_decay_every_frac=step_decay_every_frac,
    )
    return ClipAdam(sched, b1=b1, b2=b2, eps=eps, grad_clip=grad_clip,
                    weight_decay=weight_decay, state_dtype=adam_state_dtype)

