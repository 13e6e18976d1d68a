"""Training programs: declarative multi-phase, metric-gated pipelines.  The
port of ``pigan_thz_tpu/train/programs.py``, with the same phases, gates and
defaults.

The most framework-like behaviour in the reference is its metric-gated
multi-phase control flow: train, evaluate, then branch into repair phases
depending on violation rate / R².  The reference hard-codes each pipeline
inside a monolithic trainer class (unified_constraint_trainer.py:949-996
progressive; emergency_trainer.py:162-305 repair;
constraint_optimizer.py:203-395 post-hoc fine-tune).  Here a pipeline is
DATA: a list of ``Phase`` records with optional ``gate`` predicates evaluated
on fresh evaluation results (``Trainer.evaluate``), run by ``run_program``.
The canonical reference pipelines are provided as functions.

Phase kinds:
- "forward": (re)train the forward surrogate with ForwardStepSettings;
- "gan":     run PI-GAN epochs with a StepSettings, optional constraint
             annealing schedule, best-snapshot metric and early stop.

On the card every phase runs through the training kernels (the Trainer's
engine rule): the forward phases through the forward-training kernel, the
GAN phases through the GAN-training kernel, the emergency phases on its
cycle path with ``d_update_every=2``, the fine-tune on ``sigmoid_squash``
with the constraint term.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .steps import ForwardStepSettings, StepSettings
from .trainer import Trainer

EvalResults = Dict[str, Dict]


@dataclass(frozen=True)
class Phase:
    name: str
    kind: str                      # "forward" | "gan"
    epochs: int
    # when set, the phase only runs if gate(latest_eval_results) is True
    gate: Optional[Callable[[EvalResults], bool]] = None
    forward_settings: ForwardStepSettings = field(default_factory=ForwardStepSettings)
    gan_settings: Optional[StepSettings] = None
    lr: Optional[float] = None                     # forward-phase LR override
    schedule: Optional[str] = None                 # forward-phase base schedule
    # forward-phase ReduceLROnPlateau kwargs (schedules.ReduceLROnPlateau);
    # the runner builds a fresh controller per run - a dict keeps Phase
    # declarative/stateless
    plateau: Optional[Dict] = None
    # per-phase GAN optimizer policies (unified_constraint_trainer.py:196-214)
    lr_g: Optional[float] = None
    lr_d: Optional[float] = None
    schedule_g: Optional[str] = None               # cosine|linear|step|constant
    schedule_d: Optional[str] = None
    constraint_schedule: Optional[Callable[[int], float]] = None
    snapshot_metric: Optional[str] = None
    snapshot_mode: str = "min"
    early_stop: Optional[Callable[[Dict[str, float]], bool]] = None
    early_stop_patience: Optional[int] = None      # forward phases
    keep_best: bool = False                        # forward phases
    refresh_frozen_forward: bool = True            # push new F into GAN state


@dataclass
class ProgramResult:
    phases_run: List[str]
    phases_skipped: List[str]
    final_eval: EvalResults


def run_program(trainer: Trainer, phases: List[Phase], log_every: int = 10) -> ProgramResult:
    """Execute phases in order; a gated phase re-evaluates first and runs
    only if its predicate holds (unified_constraint_trainer.py:969-988)."""
    run_, skipped = [], []
    latest_eval: Optional[EvalResults] = None
    for phase in phases:
        if phase.gate is not None:
            # re-evaluate only if a phase has run since the last evaluation
            # (consecutive skipped gates reuse the cached results)
            if trainer.pigan_state is not None and latest_eval is None:
                latest_eval = trainer.evaluate()
            if latest_eval is None or not phase.gate(latest_eval):
                skipped.append(phase.name)
                continue
        if trainer.logger:
            trainer.logger.info(f"=== phase: {phase.name} ({phase.kind}, {phase.epochs} ep) ===")
        if phase.kind == "forward":
            from .schedules import ReduceLROnPlateau

            trainer.pretrain_forward(
                epochs=phase.epochs,
                settings=phase.forward_settings,
                lr=phase.lr,
                log_every=log_every,
                early_stop_patience=phase.early_stop_patience,
                keep_best=phase.keep_best,
                schedule=phase.schedule or "cosine",
                plateau=(
                    ReduceLROnPlateau(**phase.plateau)
                    if phase.plateau is not None else None
                ),
            )
            if phase.refresh_frozen_forward and trainer.pigan_state is not None:
                trainer.init_pigan()  # re-freeze latest F into the GAN state
        elif phase.kind == "gan":
            if trainer.pigan_state is None:
                trainer.init_pigan()
            trainer.train_pigan(
                epochs=phase.epochs,
                settings=phase.gan_settings,
                log_every=log_every,
                constraint_schedule=phase.constraint_schedule,
                snapshot_metric=phase.snapshot_metric,
                snapshot_mode=phase.snapshot_mode,
                early_stop=phase.early_stop,
                lr_g=phase.lr_g,
                lr_d=phase.lr_d,
                schedule_g=phase.schedule_g,
                schedule_d=phase.schedule_d,
            )
        else:
            raise ValueError(f"unknown phase kind: {phase.kind!r}")
        run_.append(phase.name)
        latest_eval = None  # state changed; next gate re-evaluates
    final_eval = trainer.evaluate() if trainer.pigan_state is not None else {}
    return ProgramResult(phases_run=run_, phases_skipped=skipped, final_eval=final_eval)


# ---------------------------------------------------------------------------
# Canonical pipelines from the reference
# ---------------------------------------------------------------------------


def _anneal(start: float = 0.5, end: float = 2.0, over: int = 100) -> Callable[[int], float]:
    """Linear constraint-weight annealing (unified_constraint_trainer.py:515-529)."""

    def schedule(epoch: int) -> float:
        t = min(1.0, epoch / max(1, over))
        return start + (end - start) * t

    return schedule


def standard_phases(forward_epochs: int = 100, gan_epochs: int = 200) -> List[Phase]:
    """Phase 1+2 of the progressive pipeline
    (unified_constraint_trainer.py:221-293, :364-501): forward weights
    5/2/0.5, then GAN with adv 1 / recon 5 / fwd-consistency 2 / range 5 /
    maxwell 2 and gradients flowing through frozen F."""
    return [
        Phase(
            name="forward_pretrain", kind="forward", epochs=forward_epochs,
            forward_settings=ForwardStepSettings(
                spectrum_w=5.0, metrics_w=2.0, smoothness_w=0.5
            ),
        ),
        Phase(
            name="gan_standard", kind="gan", epochs=gan_epochs,
            gan_settings=StepSettings(
                adv_w=1.0, recon_w=5.0, physics_spec_w=2.0, physics_metrics_w=1.0,
                maxwell_w=2.0, lc_w=1.0, range_w=5.0, detach_forward=False,
            ),
        ),
    ]


def constraint_phase(epochs: int = 100) -> Phase:
    """Constraint-focused repair, gated on violation rate > 0.2
    (unified_constraint_trainer.py:969-977, :503-676)."""
    return Phase(
        name="constraint_focused", kind="gan", epochs=epochs,
        gate=lambda ev: ev["structural_prediction_evaluation"][
            "param_range_violation_rate"
        ] > 0.2,
        gan_settings=StepSettings(
            adv_w=0.5, recon_w=2.0, physics_spec_w=1.0, constraint_w=10.0,
            range_w=5.0, detach_forward=False,
        ),
        constraint_schedule=_anneal(0.5, 2.0, epochs),
        snapshot_metric="violation_rate",
        snapshot_mode="min",
        early_stop=lambda m: m["violation_rate"] < 0.1,
    )


def emergency_phases(
    forward_epochs: int = 150, warmup_epochs: int = 100, gan_epochs: int = 100
) -> List[Phase]:
    """Emergency repair for collapsed runs (emergency_trainer.py:29-305,
    gated in the progressive pipeline on param R² < 0.7):
    intensive forward recovery (MSE+0.5·L1, early stop, keep best), a GAN
    warmup with adversarial OFF, then balanced GAN with adv 0.1, D updated
    every 2 batches, and cycle consistency."""
    return [
        Phase(
            name="emergency_forward", kind="forward", epochs=forward_epochs,
            gate=lambda ev: ev["pigan_evaluation"]["parameter_prediction"]["r2"] < 0.7,
            forward_settings=ForwardStepSettings(l1_w=0.5),
            lr=5e-4,
            # reference: fixed Adam LR driven by ReduceLROnPlateau
            # (emergency_trainer.py:125-133: mode 'min', factor 0.5,
            # patience 20) - not a decaying schedule
            schedule="constant",
            plateau=dict(factor=0.5, patience=20),
            early_stop_patience=30,
            keep_best=True,
        ),
        Phase(
            name="emergency_warmup", kind="gan", epochs=warmup_epochs,
            gate=lambda ev: ev["pigan_evaluation"]["parameter_prediction"]["r2"] < 0.7,
            gan_settings=StepSettings(
                adv_w=0.0, recon_w=10.0, physics_spec_w=2.0, cycle_w=1.0,
                d_update_every=2, detach_forward=False,
            ),
        ),
        Phase(
            name="emergency_balanced_gan", kind="gan", epochs=gan_epochs,
            gate=lambda ev: ev["pigan_evaluation"]["parameter_prediction"]["r2"] < 0.7,
            gan_settings=StepSettings(
                adv_w=0.1, recon_w=10.0, physics_spec_w=2.0, cycle_w=1.0,
                d_update_every=2, detach_forward=False,
            ),
            lr_d=5e-5,  # emergency_trainer.py:64-83: reduced D learning rate
        ),
    ]


def progressive_pipeline(
    forward_epochs: int = 100, gan_epochs: int = 200,
    constraint_epochs: int = 100, emergency_epochs: int = 100,
) -> List[Phase]:
    """The full progressive program (unified_constraint_trainer.py:949-996)."""
    return [
        *standard_phases(forward_epochs, gan_epochs),
        constraint_phase(constraint_epochs),
        *emergency_phases(
            forward_epochs=emergency_epochs,
            warmup_epochs=emergency_epochs,
            gan_epochs=emergency_epochs,
        ),
    ]


def constraint_finetune_phase(epochs: int = 100) -> Phase:
    """Post-hoc constraint fine-tuning of already-trained finals
    (constraint_optimizer.py:203-395): sigmoid-squashed G output,
    constraint-dominant weights, D every 3rd batch, best-violation snapshot."""
    return Phase(
        name="constraint_finetune", kind="gan", epochs=epochs,
        gan_settings=StepSettings(
            adv_w=1.0, recon_w=20.0, physics_spec_w=0.0, constraint_w=50.0,
            range_w=10.0, sigmoid_squash=True, d_update_every=3,
            detach_forward=False,
        ),
        snapshot_metric="violation_rate",
        snapshot_mode="min",
    )
