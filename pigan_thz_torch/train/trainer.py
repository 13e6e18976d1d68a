"""High-level Trainer: the forward half of ``pigan_thz_tpu/train/trainer.py``.

``Trainer`` builds the dataset (``load_or_synthesize``), the forward
surrogate F through the registry, the steps per epoch and the optimisers;
``pretrain_forward`` trains F (pretrain_fwd_model.py, the programs' phase 1,
the emergency recovery) in chunks of whole epochs.  G, D and the PI-GAN
phase come with the GAN slice.

Each chunk of ``epochs_per_call`` epochs is one call of a multi-epoch
function: on the card the forward-training kernel (``ops/forward_train.py``,
one launch per chunk), else the eager step (``train/steps.py``).  The
``engine`` argument picks:

- ``"auto"``: the kernel on CUDA when ``supports_forward_kernel`` holds, the
  eager step otherwise; the choice is logged;
- ``"kernel"``: the kernel, raising where its envelope excludes the config;
  on the CPU it runs the kernel's plain version (the port's analogue of
  Pallas interpret mode);
- ``"eager"``: the eager step.

A non-finite metric row or state raises ``FloatingPointError``.  It does
not restore and retry on the eager path, as the JAX package's megakernel
net does: that would hide a fault of the kernel.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Dict, List, Optional

import torch

from ..config import PiGanConfig
from ..data.dataset import ThzDataset, load_or_synthesize
from ..models.registry import build_forward_model
from ..ops.forward_train import make_forward_epoch_fn, supports_forward_kernel
from ..utils.logging import RunLogger
from .schedules import ReduceLROnPlateau, build_optimizer
from .state import ForwardState, init_forward_state, make_optimizers
from .steps import ForwardStepSettings, make_forward_step, make_multi_epoch_fn

History = Dict[str, List[float]]
ENGINES = ("auto", "eager", "kernel")


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
    ):
        if engine not in ENGINES:
            raise ValueError(f"engine {engine!r}: use one of {ENGINES}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.ds = ds if ds is not None else load_or_synthesize(
            cfg.data, csv_path, device=self.device)
        if self.ds.spectra.device != self.device:
            raise ValueError(f"dataset on {self.ds.spectra.device}, trainer on {self.device}")
        if self.ds.spectrum_dim != cfg.data.spectrum_dim:
            # a CSV with another Freq_* column count adapts the config, so
            # that F is built against the real spectrum width
            import dataclasses

            cfg = cfg.replace(
                data=dataclasses.replace(cfg.data, spectrum_dim=self.ds.spectrum_dim))
        self.cfg = cfg
        self.logger = logger
        # initialised again from the run's seed by init_forward_state
        self.forward_model = build_forward_model(
            cfg.forward_model, cfg.data.spectrum_dim, cfg.data.metrics_dim,
            cfg.data.param_dim, generator=torch.Generator().manual_seed(cfg.train.seed))
        self.steps_per_epoch = max(1, self.ds.num_samples // cfg.train.batch_size)
        _, _, self.f_tx = make_optimizers(cfg, self.steps_per_epoch)
        self.forward_state: Optional[ForwardState] = None
        self.train_history: History = {}
        self.epochs_per_call = max(1, epochs_per_call)
        self.engine = engine
        self._progress_anchor: Optional[tuple] = None

    # ------------------------------------------------------------------
    def _log(self, msg: str) -> None:
        if self.logger:
            self.logger.info(msg)

    def _log_always(self, msg: str) -> None:
        """Engine choices are never silent: without a logger they go to stderr."""
        if self.logger:
            self.logger.info(msg)
        else:
            print(f"[trainer] {msg}", file=sys.stderr)

    def _forward_epoch_fn(self, settings, tx, lr, epochs, schedule):
        """(multi-epoch fn, engine used) for this phase."""
        reason = supports_forward_kernel(self.cfg)
        if self.engine == "kernel" and reason is not None:
            raise ValueError(f"engine='kernel' but: {reason}")
        use_kernel = self.engine == "kernel" or (
            self.engine == "auto" and reason is None and self.device.type == "cuda")
        if use_kernel:
            fn = make_forward_epoch_fn(
                self.cfg, settings, lr=lr,
                total_epochs=epochs if lr is not None else None, schedule=schedule)
            where = "the CUDA kernel" if self.device.type == "cuda" else "its plain version"
            self._log_always(f"forward pretraining through the forward-training kernel "
                             f"({where}), one launch per chunk")
            return fn, "kernel"
        why = "engine='eager'" if self.engine == "eager" else (
            reason or f"no kernel on {self.device.type}")
        self._log_always(f"forward pretraining on the eager step ({why})")
        fn = make_multi_epoch_fn(make_forward_step(tx, settings), self.cfg.train.batch_size)
        return fn, "eager"

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
    ) -> History:
        """Train F for ``epochs`` (default ``train.fwd_pretrain_epochs``).

        ``lr`` overrides the config's learning rate with a fresh optimiser
        whose ``schedule`` spans this call's epochs.  ``plateau`` observes
        each epoch's loss; its scale multiplies the learning rate from the
        next chunk on.  ``early_stop_patience`` stops after that many epochs
        without a new best loss; ``keep_best`` restores the state at the end
        of the last chunk that improved it."""
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
            self.forward_state = init_forward_state(
                self.forward_model, tx, cfg.train.seed + seed, device=self.device)
        elif lr is not None:
            # fresh moments for the new learning rate: the override's
            # horizon is `epochs`, so the old count would start it mid-decay
            self.forward_state.opt = tx.init(self.forward_state.params)
        multi_epoch, engine = self._forward_epoch_fn(settings, tx, lr, epochs, schedule)

        best_loss, best_state, bad_epochs = float("inf"), None, 0
        epoch, stop = 0, False
        t_start = time.time()
        while epoch < epochs and not stop:
            chunk = min(self.epochs_per_call, epochs - epoch)
            lr_scale = plateau.scale if plateau is not None else 1.0
            self.forward_state, ms = multi_epoch(
                self.forward_state, self.ds, torch.full((chunk,), lr_scale))
            host = torch.stack([ms[k] for k in ms]).cpu()        # one transfer
            rows = {k: host[j].tolist() for j, k in enumerate(ms)}
            if not self.forward_state.is_finite():
                raise FloatingPointError(
                    f"non-finite forward state after the chunk at epoch {epoch} "
                    f"({engine} engine)")
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
            epoch += chunk
            self._progress("forward", t_start, epoch, epochs)
        if keep_best and best_state is not None:
            self.forward_state = best_state
        return self.train_history
