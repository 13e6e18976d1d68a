"""High-level Trainer: the port of ``pigan_thz_tpu/train/trainer.py``.

``Trainer`` builds the dataset (``load_or_synthesize``), the trio G, D, F
through the registry, the steps per epoch and the optimisers.
``pretrain_forward`` trains F (pretrain_fwd_model.py, the programs' phase 1,
the emergency recovery), ``init_pigan`` and ``train_pigan`` run the PI-GAN
phase (train_pigan.py and the trainer variants' settings), both in chunks of
whole epochs; ``train`` dispatches on the mode and ``save_final`` /
``load_final`` write and read the artifacts; ``evaluator`` / ``evaluate``
run the four evaluation suites (``evaluate/evaluator.py``) on the trained
state, which is what the gates of the training programs
(``train/programs.py``) read.  With a ``CheckpointManager``
(``checkpoint.py``) both phases save the full state after the chunks that
cross its interval, and ``resume_from`` restores a checkpoint into a fresh
trainer: the run then continues bit for bit as if it had not stopped.

Each chunk of ``epochs_per_call`` epochs is one call of a multi-epoch
function: on the card a training kernel (``ops/forward_train.py``,
``ops/gan_train.py``: one launch per chunk), else the eager step
(``train/steps.py``).  The ``engine`` argument picks, for both phases:

- ``"auto"``: on CUDA the kernel, raising where it does not take the
  configuration or the settings (the error names what it waits for and
  ``engine="eager"``): no phase runs as plain PyTorch on the card unless the
  caller asks for it, or no TPU kernel covers the phase's models.  A phase
  whose config names a model other than the baseline ``mlp`` (the
  enhanced variants: G and D for the PI-GAN phase, which reads F too, F
  for the forward phase) takes the eager step, as the JAX package's
  ``megakernel="auto"`` takes the XLA path for them, and says so.  On the
  CPU, where there is no kernel, the eager step;
- ``"kernel"``: the kernel, raising in the same way, for an enhanced model
  too; on the CPU it runs the kernel's plain version (the port's analogue
  of Pallas interpret mode);
- ``"eager"``: the eager step, on either device.

With a ``mesh`` (``parallel/mesh.py:make_mesh``, one trainer a rank) both
phases run data-parallel over the ranks on the eager step
(``parallel/sharding.py:make_parallel_multi_epoch_fn``: the global batch
of ``train.batch_size`` rows, each rank its share, BatchNorm over all of
them), as the JAX package's ``Trainer(mesh=...)`` runs only its XLA path:
``engine="kernel"`` raises ``ValueError``, ``"auto"`` logs why it takes the
eager step.  Every rank holds the whole dataset and a replica of the state
(rank 0's, broadcast); the metric rows every decision reads (plateau,
keep-best, early stop, snapshots, the programs' gates) are averaged over
the ranks, so every rank takes the same one.  Rank 0 alone logs and writes
checkpoints and artifacts, and the ranks then meet at a barrier.  A mesh
with a model axis (``make_mesh(data=D, model=M)``) splits every state's
wide leaves over the M ranks of each data index and their layers' compute
with them (``parallel/tensor.py``); the batch goes over the D data ranks.
Checkpoints and ``save_final`` gather the split leaves first, so rank 0
writes the world-1 files.

The choice is logged.  A non-finite metric row or state raises
``FloatingPointError``.  It does not restore and retry on the eager path,
as the JAX package's megakernel net does: that would hide a fault of the
kernel.

On the kernel engine a *shadow replay* guards against a kernel result that
is finite but wrong (``shadow_parity``, default ``"every:20"``: chunk 0 of
each phase kind and every 20th after; ``"first"``, ``"all"``, ``"off"``).
A due chunk's draws are resolved from the state's generator before the
launch, the state is cloned, and after the kernel's chunk the clone runs
the chunk's first epoch on the eager step with the same draws.  The two
first-epoch metric rows are compared with the JAX package's tolerances
(relative 0.25, 0.5 for the forward phase with dropout, absolute 1e-2);
each replay is recorded in ``shadow_checks``, and a mismatch raises
``RuntimeError``: the run does not continue, neither from the kernel's
result nor from the eager one.
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from ..config import PiGanConfig, _to_dict
from ..data.dataset import ThzDataset, load_or_synthesize
from ..evaluate.evaluator import Evaluator
from ..models.registry import build_trio
from ..ops.forward_train import make_forward_epoch_fn, resolve_draws, supports_forward_kernel
from ..ops.gan_train import make_gan_epoch_fn, supports_gan_kernel
from ..parallel.sharding import make_parallel_multi_epoch_fn, replicate_dataset, shard_state
from ..parallel.tensor import gather_module, gather_state, reshard_into_
from ..utils.logging import RunLogger
from ..utils.profiling import HOST_SYNCS, count, span
from . import checkpoint as ckpt
from .schedules import ReduceLROnPlateau, build_optimizer
from .state import (
    ForwardState,
    PiGanState,
    init_forward_state,
    init_pigan_state,
    make_optimizers,
)
from .steps import (
    ForwardStepSettings,
    StepSettings,
    make_forward_step,
    make_multi_epoch_fn,
    make_pigan_step,
)

History = Dict[str, List[float]]
ENGINES = ("auto", "eager", "kernel")

# The shadow replay's tolerances on a first-epoch row, the JAX package's: the
# kernel and the eager step differ by float reassociation over one epoch
# (~1e-3 relative); the finite-but-wrong fault it was built for was ~10x off.
_SHADOW_RTOL = 0.25
_SHADOW_RTOL_DROPOUT = 0.5
_SHADOW_ATOL = 1e-2


class Trainer:
    def __init__(
        self,
        cfg: PiGanConfig,
        ds: Optional[ThzDataset] = None,
        logger: Optional[RunLogger] = None,
        csv_path: Optional[str] = None,
        epochs_per_call: int = 25,
        engine: str = "auto",
        device: torch.device | str = "cuda",
        shadow_parity: str = "every:20",
        mesh=None,
    ):
        if engine not in ENGINES:
            raise ValueError(f"engine {engine!r}: use one of {ENGINES}")
        self._shadow_every: Optional[int] = None
        if shadow_parity.startswith("every:"):
            n = int(shadow_parity.split(":", 1)[1])
            if n < 1:
                raise ValueError(f"shadow_parity {shadow_parity!r}: N >= 1")
            self._shadow_every = n
        elif shadow_parity not in ("off", "first", "all"):
            raise ValueError(f"shadow_parity {shadow_parity!r}: use off | first | all | every:N")
        self.shadow_parity = shadow_parity
        self._shadow_counts: Dict[str, int] = {}     # chunks of each kind (every:N)
        self._shadow_done: set = set()
        self.shadow_checks: List[dict] = []          # one record per replay
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.ds = ds if ds is not None else load_or_synthesize(
            cfg.data, csv_path, device=self.device)
        if self.ds.spectra.device != self.device:
            raise ValueError(f"dataset on {self.ds.spectra.device}, trainer on {self.device}")
        self.mesh = mesh
        if mesh is not None:
            if mesh.device != self.device:
                raise ValueError(f"mesh rank {mesh.rank} on {mesh.device}, trainer on "
                                 f"{self.device}")
            self.ds = replicate_dataset(self.ds, mesh)
            if mesh.rank != 0:
                logger = None           # rank 0 logs
        if self.ds.spectrum_dim != cfg.data.spectrum_dim:
            # a CSV with another Freq_* column count adapts the config, so
            # that F is built against the real spectrum width
            import dataclasses

            cfg = cfg.replace(
                data=dataclasses.replace(cfg.data, spectrum_dim=self.ds.spectrum_dim))
        self.cfg = cfg
        self.logger = logger
        # templates on the CPU: init_forward_state and init_pigan_state
        # initialise copies of them from the run's seed on the device
        self.generator, self.discriminator, self.forward_model = build_trio(
            cfg, device="cpu", generator=torch.Generator().manual_seed(cfg.train.seed))
        self.steps_per_epoch = max(1, self.ds.num_samples // cfg.train.batch_size)
        self.g_tx, self.d_tx, self.f_tx = make_optimizers(cfg, self.steps_per_epoch)
        self.forward_state: Optional[ForwardState] = None
        self.pigan_state: Optional[PiGanState] = None
        self.train_history: History = {}
        self.epochs_per_call = max(1, epochs_per_call)
        self.engine = engine
        self._progress_anchor: Optional[tuple] = None

    # ------------------------------------------------------------------
    def _log(self, msg: str) -> None:
        if self.logger:
            self.logger.info(msg)

    def _log_always(self, msg: str) -> None:
        """Engine choices are never silent: without a logger they go to
        stderr (rank 0's, under a mesh)."""
        if self.mesh is not None and self.mesh.rank != 0:
            return
        if self.logger:
            self.logger.info(msg)
        else:
            print(f"[trainer] {msg}", file=sys.stderr)

    def _uncovered(self, roles: tuple) -> list:
        """The phase's models that no TPU kernel covers: any name but the
        baseline ``mlp`` in the config."""
        cfg = self.cfg
        names = {"generator": cfg.generator.name, "discriminator": cfg.discriminator.name,
                 "forward model": cfg.forward_model.name}
        return [f"{role} {names[role]!r}" for role in roles if names[role] != "mlp"]

    def _use_kernel(self, what: str, kernel: str, reason: Optional[str],
                    roles: tuple) -> bool:
        """The engine rule for one phase: True for the kernel (on the CPU its
        plain version), False for the eager step.  Under "auto" on the card
        a phase with a model that no TPU kernel covers (``roles`` named other
        than ``mlp``) takes the eager step; otherwise raises where the kernel
        was asked for, or is the card's default, and does not take the phase
        (``reason``)."""
        if self.mesh is not None:
            if self.engine == "kernel":
                raise ValueError(
                    "engine='kernel' is incompatible with mesh: data parallelism over ranks "
                    "runs the eager step (as the JAX package's megakernel='force' with a mesh "
                    "raises)")
            self._log_always(f"{what} on the eager step: data parallelism over "
                             f"{self.mesh.size} ranks runs no training kernel "
                             f"(engine={self.engine!r})")
            return False
        if self.engine == "eager":
            self._log_always(f"{what} on the eager step (engine='eager')")
            return False
        if self.engine == "auto" and self.device.type != "cuda":
            self._log_always(f"{what} on the eager step (no kernel on {self.device.type})")
            return False
        uncovered = self._uncovered(roles)
        if self.engine == "auto" and uncovered:
            self._log_always(f"{what} on the eager step: no TPU kernel covers the "
                             f"{', '.join(uncovered)} (engine='auto')")
            return False
        if reason is not None:
            raise ValueError(f"engine={self.engine!r} but: {reason}; engine='eager' (--engine "
                             f"eager) runs {what} on the eager PyTorch step")
        where = "the CUDA kernel" if self.device.type == "cuda" else "its plain version"
        self._log_always(f"{what} through the {kernel} kernel ({where}), one launch per "
                         "chunk")
        return True

    def _eager_epochs(self, step):
        """The eager multi-epoch function of ``step``: over the ranks under a
        mesh."""
        if self.mesh is None:
            return make_multi_epoch_fn(step, self.cfg.train.batch_size)
        return make_parallel_multi_epoch_fn(step, self.cfg.train.batch_size, self.mesh)

    def _eager_forward_fn(self, settings, tx):
        return self._eager_epochs(make_forward_step(tx, settings))

    def _eager_gan_fn(self, settings, g_tx, d_tx):
        return self._eager_epochs(
            make_pigan_step(g_tx, d_tx, settings, self.ds.param_lo, self.ds.param_hi))

    def _replicas(self, state):
        """``state`` as rank 0 holds it on every rank (under a mesh)."""
        return state if self.mesh is None else shard_state(state, self.mesh)

    def _rank0_writes(self, fn, *args, **kw) -> None:
        """``fn`` on rank 0 alone, then a barrier (under a mesh)."""
        if self.mesh is None or self.mesh.rank == 0:
            fn(*args, **kw)
        if self.mesh is not None:
            self.mesh.barrier()

    def _whole(self, state):
        """``state`` whole (on a model axis its split leaves gathered: every
        rank calls this)."""
        return state if self.mesh is None or self.mesh.model == 1 else gather_state(state)

    def _forward_epoch_fn(self, settings, tx, lr, epochs, schedule):
        """(multi-epoch fn, engine used) for this phase."""
        if self._use_kernel("forward pretraining", "forward-training",
                            supports_forward_kernel(self.cfg, settings), ("forward model",)):
            fn = make_forward_epoch_fn(
                self.cfg, settings, lr=lr,
                total_epochs=epochs if lr is not None else None, schedule=schedule)
            return fn, "kernel"
        return self._eager_forward_fn(settings, tx), "eager"

    def _gan_epoch_fn(self, settings, g_tx, d_tx, overrides: dict, epochs: int):
        """(multi-epoch fn, engine used) for a PI-GAN phase."""
        if self._use_kernel("PI-GAN training", "GAN-training",
                            supports_gan_kernel(self.cfg, settings),
                            ("generator", "discriminator", "forward model")):
            fn = make_gan_epoch_fn(
                self.cfg, settings, **overrides,
                horizon_epochs=epochs if overrides else None)
            return fn, "kernel"
        return self._eager_gan_fn(settings, g_tx, d_tx), "eager"

    # ------------------------------------------------------------------
    # One chunk, and the shadow replay
    # ------------------------------------------------------------------
    def _shadow_due(self, what: str) -> bool:
        """Whether the next ``what`` chunk on the kernel is replayed (the JAX
        package's cadence; each call counts one chunk)."""
        if self.shadow_parity == "off":
            return False
        if self._shadow_every is not None:
            c = self._shadow_counts.get(what, 0)
            self._shadow_counts[what] = c + 1
            return c % self._shadow_every == 0
        return self.shadow_parity == "all" or what not in self._shadow_done

    def _run_chunk(self, what: str, fn, eager, state, scales: torch.Tensor, at: int):
        """One chunk of ``len(scales)`` epochs through ``fn``: (state,
        {key: [per-epoch floats]}), with one host transfer.  A non-finite
        state raises ``FloatingPointError``; on the kernel engine (``eager``
        given) a due shadow replay that disagrees raises ``RuntimeError``."""
        with span("pigan.train.chunk", what=what, epochs=int(scales.numel()), at=at):
            replay = None
            if eager is not None and self._shadow_due(what):
                # the chunk's draws as the kernel's function would draw them, so
                # that the state's generator ends where it ends without a replay
                indices, seeds = resolve_draws(state.generator, self.ds.num_samples,
                                               self.cfg.train.batch_size, int(scales.numel()))
                replay = (state.clone(), indices, seeds)   # the kernel updates in place
                state, ms = fn(state, self.ds, scales, indices, seeds)
            else:
                state, ms = fn(state, self.ds, scales)
            with span("pigan.train.transfer"):
                host = torch.stack([ms[k] for k in ms]).cpu()        # one transfer
                count(HOST_SYNCS)
            rows = {k: host[j].tolist() for j, k in enumerate(ms)}
            with span("pigan.train.check"):
                finite = state.is_finite()
            if not finite:
                raise FloatingPointError(
                    f"non-finite {what} state after the chunk at epoch {at} "
                    f"({'kernel' if eager is not None else 'eager'} engine)")
            # a non-finite row raises in _record, before a replay could mistake it
            if replay is not None and all(math.isfinite(x) for v in rows.values() for x in v):
                with span("pigan.train.replay"):
                    self._shadow_replay(what, eager, *replay, scales, rows, at)
        return state, rows

    def _shadow_replay(self, what: str, eager, backup, indices, seeds, scales, rows, at):
        """Run the chunk's first epoch on the eager step from the pre-chunk
        ``backup`` with the chunk's own draws, and hold the kernel's
        first-epoch row to it.  Records the replay in ``shadow_checks``;
        raises ``RuntimeError`` on a mismatch (a non-finite replay row is
        one)."""
        self._shadow_done.add(what)
        spe = indices.shape[1]
        _, sms = eager(backup, self.ds, scales[:1], indices[:1], seeds[:spe])
        srows = {k: float(v[0]) for k, v in sms.items()}
        rtol = _SHADOW_RTOL
        if what == "forward" and self.cfg.forward_model.dropout_rate > 0:
            rtol = _SHADOW_RTOL_DROPOUT
        bad, worst_key, worst_rel = [], None, 0.0
        for k, v in rows.items():
            if k not in srows:
                bad.append(f"{k}: missing in the replay")
                continue
            a, b = v[0], srows[k]
            if not math.isfinite(b):
                bad.append(f"{k}: {a:.6g} vs {b:.6g} (replay non-finite)")
                worst_key, worst_rel = k, float("inf")
                continue
            denom = max(abs(a), abs(b))
            rel = abs(a - b) / denom if denom > 0 else 0.0
            if abs(a - b) > _SHADOW_ATOL + rtol * denom:
                bad.append(f"{k}: {a:.6g} vs {b:.6g}")
            if rel > worst_rel:
                worst_key, worst_rel = k, rel
        self.shadow_checks.append(dict(what=what, at=at, ok=not bad, rtol=rtol,
                                       worst_key=worst_key, worst_rel=worst_rel))
        if bad:
            raise RuntimeError(
                f"{what} chunk at epoch {at}: the kernel's first epoch disagrees with the "
                f"eager step's replay from the same state and draws ({'; '.join(bad)}). "
                "A finite but wrong kernel result: the run stops here")
        self._log_always(f"{what} shadow replay ok at epoch {at} "
                         f"(worst {worst_key} rel diff {worst_rel:.2e})")

    def _record(self, metrics: Dict[str, float], prefix: str, epoch: int) -> None:
        for k, val in metrics.items():
            if not math.isfinite(val):
                raise FloatingPointError(
                    f"non-finite {prefix}{k} at epoch {epoch}: training diverged")
            self.train_history.setdefault(f"{prefix}{k}", []).append(val)
        if self.logger:
            self.logger.add_scalars(metrics, epoch, prefix)

    def _progress(self, what: str, t_start: float, done: int, total: int) -> None:
        """Per-chunk steps/s and ETA; the first chunk's window includes the
        kernel build and is labelled so."""
        now = time.time()
        if self._progress_anchor is None or self._progress_anchor[0] < t_start:
            self._progress_anchor = (now, done)
            rate = done * self.steps_per_epoch / max(now - t_start, 1e-9)
            note = " (incl. set-up)"
        else:
            t0, e0 = self._progress_anchor
            rate = (done - e0) * self.steps_per_epoch / max(now - t0, 1e-9)
            note = ""
        left = (total - done) * self.steps_per_epoch / max(rate, 1e-9)
        self._log(f"[{what}] epoch {done}/{total} {rate:,.0f} steps/s{note}, "
                  f"ETA {int(left // 60)}:{int(left % 60):02d}")

    # ------------------------------------------------------------------
    # Forward surrogate training (pretrain_fwd_model.py / phase 1 / emergency)
    # ------------------------------------------------------------------
    def pretrain_forward(
        self,
        epochs: Optional[int] = None,
        settings: ForwardStepSettings = ForwardStepSettings(),
        lr: Optional[float] = None,
        seed: int = 0,
        log_every: int = 10,
        early_stop_patience: Optional[int] = None,
        keep_best: bool = False,
        reset: bool = False,
        schedule: str = "cosine",
        plateau: Optional[ReduceLROnPlateau] = None,
        checkpoint_manager: Optional[ckpt.CheckpointManager] = None,
    ) -> History:
        """Train F for ``epochs`` (default ``train.fwd_pretrain_epochs``).

        ``lr`` overrides the config's learning rate with a fresh optimiser
        whose ``schedule`` spans this call's epochs.  ``plateau`` observes
        each epoch's loss; its scale multiplies the learning rate from the
        next chunk on.  ``early_stop_patience`` stops after that many epochs
        without a new best loss; ``keep_best`` restores the state at the end
        of the last chunk that improved it.  ``checkpoint_manager`` is
        offered the state after each chunk (``maybe_save``) at the epoch
        count of the whole history, with the plateau controller's state in
        ``extra``; a pristine controller paired with a manager that holds a
        saved one resumes from it."""
        cfg = self.cfg
        # epochs=0 means "initialise the state only"
        epochs = cfg.train.fwd_pretrain_epochs if epochs is None else epochs
        if schedule != "cosine" and lr is None:
            raise ValueError(
                "schedule= only applies to an lr override (without lr the "
                "optimizer comes from the config's fwd_pretrain settings)")
        tx = self.f_tx
        if lr is not None:
            tx = build_optimizer(
                lr=lr, total_epochs=epochs, steps_per_epoch=self.steps_per_epoch,
                schedule=schedule, b1=0.9, grad_clip=cfg.train.grad_clip,
                schedule_alpha=0.0, adam_state_dtype=cfg.train.adam_state_dtype)
        if self.forward_state is None or reset:
            self.forward_state = self._replicas(init_forward_state(
                self.forward_model, tx, cfg.train.seed + seed, device=self.device))
        elif lr is not None:
            # fresh moments for the new learning rate: the override's
            # horizon is `epochs`, so the old count would start it mid-decay
            self.forward_state.opt = tx.init(self.forward_state.params)
        multi_epoch, engine = self._forward_epoch_fn(settings, tx, lr, epochs, schedule)
        # the eager step of the same phase, for the kernel's shadow replay
        eager = self._eager_forward_fn(settings, tx) if engine == "kernel" else None

        if (plateau is not None and checkpoint_manager is not None
                and math.isinf(plateau.best) and plateau.num_bad_epochs == 0):
            # a killed run resumed: a pristine controller takes the saved
            # one's reductions instead of retraining at the pre-plateau rate
            latest = checkpoint_manager.latest_epoch()
            if latest is not None:
                _, _, meta = checkpoint_manager.restore_with_meta(None, latest)
                saved = (meta or {}).get("extra", {}).get("plateau")
                if saved:
                    plateau.load_state_dict(saved)
                    self._log(f"[forward] plateau controller resumed from checkpoint "
                              f"{latest} (scale {plateau.scale:g})")

        best_loss, best_state, bad_epochs = float("inf"), None, 0
        epoch, stop = 0, False
        # checkpoint epochs count the whole history, so that repeated calls
        # with one manager keep saving
        ckpt_base = len(self.train_history.get("forward/loss", []))
        t_start = time.time()
        while epoch < epochs and not stop:
            chunk = min(self.epochs_per_call, epochs - epoch)
            lr_scale = plateau.scale if plateau is not None else 1.0
            self.forward_state, rows = self._run_chunk(
                "forward", multi_epoch, eager, self.forward_state,
                torch.full((chunk,), lr_scale), epoch)
            with span("pigan.train.record", follows=True):
                improved_in_chunk = False
                for j in range(chunk):
                    e = epoch + j
                    m = {k: v[j] for k, v in rows.items()}
                    if plateau is not None:
                        before = plateau.num_reductions
                        plateau.step(m["loss"])
                        if plateau.num_reductions != before:
                            self._log(f"[forward] plateau: LR scale -> {plateau.scale:g} at "
                                      f"epoch {e + 1} (applies next chunk)")
                        m = dict(m, lr_scale=lr_scale)
                    self._record(m, "forward/", e)
                    if (e + 1) % log_every == 0:
                        self._log(f"[forward] epoch {e + 1}/{epochs} loss={m['loss']:.6f}")
                    if m["loss"] < best_loss - 1e-7:
                        best_loss, bad_epochs = m["loss"], 0
                        improved_in_chunk = True
                    else:
                        bad_epochs += 1
                        if early_stop_patience and bad_epochs >= early_stop_patience:
                            self._log(f"[forward] early stop at epoch {e + 1}")
                            stop = True
                            break
                if keep_best and improved_in_chunk:
                    best_state = self.forward_state.clone()     # chunk granularity
                if checkpoint_manager is not None:
                    self._rank0_writes(
                        checkpoint_manager.maybe_save,
                        ckpt_base + epoch + chunk, self._whole(self.forward_state),
                        history=self.train_history,
                        config=self.cfg,
                        extra={"plateau": plateau.state_dict()} if plateau is not None else None)
                epoch += chunk
                self._progress("forward", t_start, epoch, epochs)
        if keep_best and best_state is not None:
            self.forward_state = best_state
        return self.train_history

    # ------------------------------------------------------------------
    # PI-GAN training (train_pigan.py / trainer-variant settings)
    # ------------------------------------------------------------------
    def init_pigan(self, seed: int = 0, fresh_gd: bool = False) -> PiGanState:
        """Create the PI-GAN state (G and D fresh from the run's seed, F a
        copy of the pretrained one, or fresh when none was trained); on a
        later call refresh only the frozen F, unless ``fresh_gd``."""
        trained = self.forward_state.f if self.forward_state is not None else None
        if trained is not None and self.mesh is not None and self.mesh.model > 1:
            trained = gather_module(trained)        # whole: the new state splits it anew
        if self.pigan_state is None or fresh_gd:
            self.pigan_state = self._replicas(init_pigan_state(
                self.generator, self.discriminator, trained or self.forward_model,
                self.g_tx, self.d_tx, self.cfg.train.seed + 2000 + seed,
                device=self.device, fresh_forward=trained is None))
        elif trained is not None:
            if self.mesh is not None and self.mesh.model > 1:
                whole = gather_state(self.pigan_state)
                whole.set_forward_(trained)
                reshard_into_(self.pigan_state, whole)
            else:
                self.pigan_state.set_forward_(trained)
        return self.pigan_state

    def train_pigan(
        self,
        epochs: Optional[int] = None,
        settings: Optional[StepSettings] = None,
        log_every: int = 10,
        constraint_schedule: Optional[Callable[[int], float]] = None,
        snapshot_metric: Optional[str] = None,
        snapshot_mode: str = "min",
        early_stop: Optional[Callable[[Dict[str, float]], bool]] = None,
        checkpoint_manager: Optional[ckpt.CheckpointManager] = None,
        lr_g: Optional[float] = None,
        lr_d: Optional[float] = None,
        schedule_g: Optional[str] = None,
        schedule_d: Optional[str] = None,
        seed: int = 0,
    ) -> History:
        """Run GAN epochs with optional constraint annealing
        (unified_constraint_trainer.py:515-529), best-snapshot restore
        (:645-674), metric-based early stop (:662-665) and per-phase
        optimiser overrides, the constraint trainer's per-mode learning
        rates and schedules (:196-214).  Overriding an optimiser starts its
        Adam moments and count afresh, and its schedule spans this call's
        ``epochs``.

        Without overrides the schedules' horizon is ``cfg.train.num_epochs``,
        not this call's ``epochs``: callers that train in several calls need
        a horizon that spans the total (the command sets it from
        ``--epochs``).  ``seed`` reseeds the state's generator, so that
        successive calls do not replay one shuffle sequence.
        ``checkpoint_manager`` is offered the state after each chunk
        (``maybe_save``) at the epoch count of the whole history."""
        cfg = self.cfg
        epochs = cfg.train.num_epochs if epochs is None else epochs
        settings = settings or StepSettings.from_config(cfg)
        if self.pigan_state is None:
            self.init_pigan()
        state = self.pigan_state
        if settings.ema_decay > 0.0 and state.g_ema is None:
            state.g_ema = state.g_params.clone()     # the track starts at the current G

        g_tx, d_tx, overrides = self.g_tx, self.d_tx, {}
        if lr_g is not None or schedule_g is not None:
            g_tx = build_optimizer(
                lr=cfg.train.lr_g if lr_g is None else lr_g, total_epochs=epochs,
                steps_per_epoch=self.steps_per_epoch, schedule=schedule_g or "cosine",
                b1=0.5, grad_clip=cfg.train.grad_clip,
                adam_state_dtype=cfg.train.adam_state_dtype)
            state.g_opt = g_tx.init(state.g_params)
            overrides.update(lr_g=lr_g, schedule_g=schedule_g)
        if lr_d is not None or schedule_d is not None:
            d_tx = build_optimizer(
                lr=cfg.train.lr_d if lr_d is None else lr_d, total_epochs=epochs,
                steps_per_epoch=self.steps_per_epoch, schedule=schedule_d or "step",
                b1=0.5, grad_clip=cfg.train.grad_clip,
                adam_state_dtype=cfg.train.adam_state_dtype)
            state.d_opt = d_tx.init(state.d_params)
            overrides.update(lr_d=lr_d, schedule_d=schedule_d)
        multi_epoch, engine = self._gan_epoch_fn(settings, g_tx, d_tx, overrides, epochs)
        eager = self._eager_gan_fn(settings, g_tx, d_tx) if engine == "kernel" else None

        state.generator.manual_seed(cfg.train.seed + 3000 + seed)
        best_val, best_state = None, None
        epoch, stop = 0, False
        ckpt_base = len(self.train_history.get("pigan/d_loss", []))
        t_start = time.time()
        while epoch < epochs and not stop:
            chunk = min(self.epochs_per_call, epochs - epoch)
            scales = torch.tensor(
                [constraint_schedule(epoch + j) if constraint_schedule else 1.0
                 for j in range(chunk)], dtype=torch.float32)
            self.pigan_state, rows = self._run_chunk(
                "pigan", multi_epoch, eager, self.pigan_state, scales, epoch)
            with span("pigan.train.record", follows=True):
                chunk_has_best = False
                for j in range(chunk):
                    e = epoch + j
                    m = {k: v[j] for k, v in rows.items()}
                    self._record(m, "pigan/", e)
                    if (e + 1) % log_every == 0:
                        self._log(f"[pigan] epoch {e + 1}/{epochs} D={m['d_loss']:.4f} "
                                  f"G={m['g_loss']:.4f} viol={m['violation_rate']:.3f}")
                    if snapshot_metric is not None:
                        val = m[snapshot_metric]
                        if (best_val is None or (snapshot_mode == "min" and val < best_val)
                                or (snapshot_mode == "max" and val > best_val)):
                            best_val, chunk_has_best = val, True
                    if early_stop is not None and early_stop(m):
                        self._log(f"[pigan] early stop at epoch {e + 1}")
                        stop = True
                        break
                if chunk_has_best:
                    best_state = self.pigan_state.clone()       # chunk granularity
                if checkpoint_manager is not None:
                    self._rank0_writes(
                        checkpoint_manager.maybe_save,
                        ckpt_base + epoch + chunk, self._whole(self.pigan_state),
                        history=self.train_history, config=self.cfg)
                epoch += chunk
                self._progress("pigan", t_start, epoch, epochs)
        if snapshot_metric is not None and best_state is not None:
            self.pigan_state = best_state
            self._log(f"[pigan] restored best snapshot ({snapshot_metric}={best_val:.4f})")
        return self.train_history

    # ------------------------------------------------------------------
    # Resume (unified_constraint_trainer.py:1140-1176: epoch, models,
    # optimiser moments, history and config all come back)
    # ------------------------------------------------------------------
    def resume_from(self, manager: ckpt.CheckpointManager, which: str = "pigan",
                    epoch: Optional[int] = None) -> Optional[int]:
        """Restore the latest (or ``epoch``'s) checkpoint of ``manager``
        into this trainer: the full state of the ``which`` phase ("pigan" or
        "forward"), the generator's state among it, and the history, so the
        run continues as if it had not stopped.  Returns the epoch, or None
        when the manager is empty.  Each model section whose config differs
        from the checkpoint's is logged: the restored weights then run under
        the current settings."""
        if which == "pigan":
            if self.pigan_state is None:
                self.init_pigan()
            state = self.pigan_state
        elif which == "forward":
            if self.forward_state is None:
                self.pretrain_forward(epochs=0)
            state = self.forward_state
        else:
            raise ValueError(f"unknown target: {which!r}")
        whole = self._whole(state)          # the files are the world-1 state's
        step, _, meta = manager.restore_with_meta(whole, epoch)
        if whole is not state and step is not None:
            reshard_into_(state, whole)
        if step is None:
            return None
        if meta.get("history"):
            self.train_history = {k: [float(x) for x in v] for k, v in meta["history"].items()}
        if isinstance(meta.get("config"), dict):
            cur = _to_dict(self.cfg)
            for sec in ("generator", "discriminator", "forward_model"):
                saved = meta["config"].get(sec)
                if saved is not None and saved != cur.get(sec):
                    diff = {k: (v, cur[sec].get(k)) for k, v in saved.items()
                            if cur[sec].get(k) != v}
                    self._log_always(
                        f"resume: {sec} config differs from the checkpoint's (saved, "
                        f"current): {diff}; the restored weights run under the current "
                        "settings")
        return step

    # ------------------------------------------------------------------
    # Full pipeline (unified_trainer.train_full_pipeline :422-455)
    # ------------------------------------------------------------------
    def train_full_pipeline(self, forward_epochs: Optional[int] = None,
                            gan_epochs: Optional[int] = None) -> History:
        self.pretrain_forward(epochs=forward_epochs)
        self.init_pigan()
        self.train_pigan(epochs=gan_epochs)
        return self.train_history

    def train(self, mode: str = "full", **kw) -> History:
        """Mode dispatch (unified_trainer.py:114-155)."""
        if mode == "forward_only":
            return self.pretrain_forward(**kw)
        if mode == "pigan_only":
            self.init_pigan()
            return self.train_pigan(**kw)
        if mode == "full":
            return self.train_full_pipeline(**kw)
        raise ValueError(f"unknown mode: {mode!r}")

    # ------------------------------------------------------------------
    # Evaluation
    # ------------------------------------------------------------------
    def evaluator(self, violation_window: tuple = (0.0, 1.0),
                  use_ema: bool = False) -> Evaluator:
        """The four suites over the PI-GAN state's G, D and frozen F.
        ``use_ema=True`` evaluates the EMA generator track (the parameters
        of ``state.g_ema``, the BatchNorm stats of the live generator); it
        needs training with ``StepSettings.ema_decay`` > 0."""
        if self.pigan_state is None:
            raise ValueError("evaluator: train or init_pigan first")
        st = self.pigan_state
        g = st.g
        if use_ema:
            if st.g_ema is None:
                raise ValueError("no EMA track: train with StepSettings(ema_decay=...) first")
            g = ckpt.ema_generator(st)
        return Evaluator(g, st.d, st.f, violation_window=violation_window)

    def evaluate(self, noise=None, violation_window: tuple = (0.0, 1.0),
                 use_ema: bool = False) -> Dict:
        """``run_comprehensive_evaluation`` on the training set; ``noise``
        is the stability suite's (N, S) unit normals or a ``torch.Generator``
        (default: seeded with 0)."""
        return self.evaluator(violation_window, use_ema=use_ema).run_comprehensive_evaluation(
            self.ds, noise)

    # ------------------------------------------------------------------
    # Artifacts
    # ------------------------------------------------------------------
    def save_final(self, directory: str, backup_tag: str | None = None) -> None:
        """The final trio (and ``generator_ema``), ``model_config.json``, the
        training history and, when F was pretrained here,
        ``forward_model_pretrained``; ``backup_tag`` also writes
        ``generator_<tag>`` etc. beside the finals."""
        if self.pigan_state is None:
            raise ValueError("save_final: train or init_pigan first")
        forward = None
        if self.forward_state is not None:
            forward = self.forward_state.f
            if self.mesh is not None and self.mesh.model > 1:
                forward = gather_module(forward)
        self._rank0_writes(self._save_final, directory, backup_tag,
                           self._whole(self.pigan_state), forward)

    def _save_final(self, directory: str, backup_tag: str | None, state, forward) -> None:
        ckpt.save_final_trio(directory, state, backup_tag=backup_tag)
        ckpt.save_model_config(directory, self.cfg)
        ckpt.save_train_history(directory, self.train_history)
        if forward is not None:
            ckpt.save_model(directory, ckpt.FORWARD_MODEL_PRETRAINED, forward)

    def load_final(self, directory: str) -> None:
        """Load the final artifacts (the reference's ``.pth`` layout, bare
        or wrapped; ``checkpoint.load_model``) into the PI-GAN state, with
        the EMA generator when it is there, and the saved history when the
        trainer has none of its own."""
        if self.pigan_state is None:
            self.init_pigan()
        st = self.pigan_state
        ckpt.load_final_trio(directory, st.g, st.d, st.f)   # in place: views stay bound
        st.g_ema = None
        if ckpt.exists(directory, ckpt.GENERATOR_EMA):
            sd = ckpt.extract_state_dict(ckpt.load_torch_file(
                os.path.join(directory, f"{ckpt.GENERATOR_EMA}.pth")), "generator")
            st.g_ema = torch.cat([sd[name].reshape(-1) for name, _ in
                                  st.g.named_parameters()]).to(self.device)
        # the loss curves that save_final wrote, unless this trainer has its
        # own: a run that loads finals and trains on keeps what it recorded
        if not self.train_history:
            history = ckpt.load_train_history(directory)
            if history:
                self.train_history = {k: [float(x) for x in v] for k, v in history.items()}
