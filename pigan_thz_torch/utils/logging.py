"""Run logging: console + file + JSONL scalars + optional TensorBoard.

A copy of ``pigan_thz_tpu/utils/logging.py`` (pure Python, no JAX).

Parity surface with the reference Logger (core/utils/logger.py:8-89 —
console/file handlers + TensorBoard SummaryWriter in a timestamped run dir),
plus a machine-readable `scalars.jsonl` stream that benchmark tooling
can consume without TensorBoard.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Mapping


class RunLogger:
    def __init__(
        self,
        workdir: str,
        name: str = "pigan",
        use_tensorboard: bool = True,
        use_wandb: bool = False,
        stdout: bool = True,
    ):
        # use_wandb mirrors the reference monitoring config's (off-by-
        # default) wandb toggle (training_optimization.py:220); gated —
        # silently disabled when the wandb package is absent.
        ts = time.strftime("%Y%m%d-%H%M%S")
        self.run_dir = os.path.join(workdir, f"{name}_{ts}")
        os.makedirs(self.run_dir, exist_ok=True)

        self._logger = logging.getLogger(f"{name}_{ts}_{id(self)}")
        self._logger.setLevel(logging.INFO)
        self._logger.propagate = False
        fh = logging.FileHandler(os.path.join(self.run_dir, f"{name}.log"))
        fh.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
        self._logger.addHandler(fh)
        if stdout:
            sh = logging.StreamHandler(sys.stdout)
            sh.setFormatter(logging.Formatter("%(message)s"))
            self._logger.addHandler(sh)

        self._scalars = open(os.path.join(self.run_dir, "scalars.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            # dependency-free tfevents writer (utils/tensorboard.py) —
            # on-by-default parity with the reference Logger, which
            # constructs a SummaryWriter unconditionally (logger.py:47)
            from .tensorboard import TfEventsWriter

            self._tb = TfEventsWriter(os.path.join(self.run_dir, "tb"))
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # type: ignore

                self._wandb = wandb.init(
                    project=name, dir=self.run_dir, reinit=True
                )
            except Exception:  # wandb optional (not in the base image)
                self._logger.warning("wandb requested but unavailable; skipping")
                self._wandb = None

    def info(self, msg: str) -> None:
        self._logger.info(msg)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._scalars.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n"
        )
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        if self._wandb is not None:
            # no step= kwarg: phases restart their epoch counters (forward
            # pretrain then GAN), and wandb drops non-monotonic steps.
            # The phase-local epoch rides along as a plain field instead.
            self._wandb.log({tag: float(value), f"{tag}/epoch": int(step)})

    def add_scalars(self, scalars: Mapping[str, float], step: int, prefix: str = "") -> None:
        for k, v in scalars.items():
            self.add_scalar(f"{prefix}{k}", v, step)
        self._scalars.flush()
        if self._tb is not None:
            # killed runs are this repo's normal failure mode — keep the
            # tfevents stream current, not buffered until close()
            self._tb.flush()

    def close(self) -> None:
        self._scalars.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
        for h in list(self._logger.handlers):
            h.close()
            self._logger.removeHandler(h)
