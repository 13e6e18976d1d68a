"""``train --mode full`` as typed, one trio after another.

Each trio is a fresh ``Trainer`` on the benchmark's training set, driven as
the command drives it: ``pretrain_forward()`` (F through its training
kernel), ``init_pigan()``, ``train_pigan(settings)`` with the command's
settings (``detach_forward``, no EMA), both phases in the Trainer's chunks
of 25 epochs, one launch a chunk.  The command's file writes (the final
``.pth`` artifacts) are left out.

Set-up builds the first ``check_trios`` trios (3), the trainers that the
window starts with, copies the benchmark's weights (trio k's from the seed)
into each one's F, G and D, and trains one epoch of each phase through the
Trainer's own calls: ``train_pigan(epochs=1)`` first, so that its D-then-G
steps run against F as the seed made it, then ``pretrain_forward(epochs=1)``.
Each is one launch of 15 steps on the rows that the Trainer drew; the rows
are read back by replaying the draws from the generator's state before the
call (``program.replay_draws``).  The window trains each of these trios on
through the rest of both phases (499 epochs each, F first, as typed), then
fresh trios, until a trio ends past ``--seconds``.  The rate is the
optimiser steps of the window over its host time.

The check runs the reference over the same epochs from the same weights,
rows and dropout seeds, and compares each epoch's mean loss (by the median
trio), Adam's first moment after it and the parameters' change over it (the
leaves of the three trios together; ``reference/compare.py``).  Three
trajectories, not one: a pre-activation within rounding of a kink takes the
other slope on one side now and then, and 15 steps carry that on, so one
trio's numbers swing where the median over three does not.
"""

from __future__ import annotations

import statistics
import time

import torch

from .. import inputs, program
from ..reference import compare
from ..reference import models as M
from ..reference import steps as R
from ..tracing import Segment

# the numbers the check holds to limits (the others are printed by
# ``benchmark/calibrate.py`` beside them)
COMPARED = ("fwd.loss_gap", "fwd.moment_gap", "fwd.moment_median_gap", "fwd.change_gap",
            "gan.d_loss_gap", "gan.moment_gap", "gan.moment_median_gap", "gan.change_gap",
            "gan.change_median_gap", "draws.repeated_rows")


class ChunkHook:
    """A logger for the Trainer that starts and stops traced segments at
    epoch boundaries: its rows are recorded after each chunk's one host
    transfer, while the device is idle."""

    def __init__(self):
        self.plan: dict = {}          # prefix -> (first epoch, end epoch)
        self.segments: list = []
        self.outer_s = 0.0
        self._open = None

    def info(self, msg: str) -> None:
        pass

    def add_scalars(self, metrics, epoch: int, prefix: str) -> None:
        if prefix not in self.plan:
            return
        first, end = self.plan[prefix]
        if epoch == first - 1 and self._open is None:
            self._open = Segment(prefix.rstrip("/"))
            self._open.start()
        elif epoch == end - 1 and self._open is not None:
            self._open.stop()
            self.segments.append(self._open.summary)
            self.outer_s += self._open.outer_s
            self._open = None
            del self.plan[prefix]

    def close(self) -> None:
        pass


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.b = cfg["batch_size"]
        # the card's default; on the CPU the kernels' plain versions stand in
        self.engine = "auto" if self.device.type == "cuda" else "kernel"

    # ------------------------------------------------------------------
    def _trainer(self, hook=None):
        from pigan_thz_torch.train.trainer import Trainer

        return Trainer(self.pc, ds=self.ds, device=self.device, logger=hook or ChunkHook(),
                       engine=self.engine)

    def _trio(self, t) -> None:
        t.pretrain_forward()
        t.init_pigan()
        t.train_pigan(settings=self.settings)

    def _weights(self, k: int) -> dict:
        """Trio ``k``'s F, G and D from the seed."""
        dev, f, g, d = self.device, self.f_ops, self.g_ops, self.d_ops
        return {"f": inputs.make_weights(M.param_layout(f), self.seed, dev, "F", k),
                "g": inputs.make_weights(M.param_layout(g) + M.buffer_layout(g), self.seed,
                                         dev, "G", k),
                "d": inputs.make_weights(M.param_layout(d), self.seed, dev, "D", k)}

    def _first_epochs(self, t, w: dict) -> tuple:
        """Trio ``t``'s first GAN epoch, then its first F epoch, from the
        weights ``w``: (readings, draws) of each."""
        n, b, pc = self.cfg["num_samples"], self.b, self.pc
        t.pretrain_forward(epochs=0)                  # the state only
        program.load_(t.forward_state.f, w["f"], self.f_ops)
        # the GAN state copies F now, before F's own first epoch, so that
        # both checks start from the benchmark's weights alone
        ps = t.init_pigan()
        program.load_(ps.g, w["g"], self.g_ops)
        program.load_(ps.d, w["d"], self.d_ops)
        # train_pigan reseeds the state's generator with the run's seed + 3000
        before = torch.Generator(device=ps.generator.device).manual_seed(
            pc.train.seed + 3000).get_state()
        t.train_pigan(epochs=1, settings=self.settings)
        ps = t.pigan_state
        gan_rows, _ = program.replay_draws(before, ps.generator, n, b, 1)
        hist = t.train_history
        start = self._gd(ps, None, None, w["g"], w["d"])
        now = self._gd(ps, ps.g_params, ps.d_params)
        got_gan = {"loss": {"d_loss": hist["pigan/d_loss"][0], "g_loss": hist["pigan/g_loss"][0]},
                   "moment": self._gd(ps, ps.g_opt.m, ps.d_opt.m),
                   "change": {k: now[k] - start[k] for k in now}}

        before = t.forward_state.generator.get_state()
        t.pretrain_forward(epochs=1)
        fs = t.forward_state
        f_rows, f_seeds = program.replay_draws(before, fs.generator, n, b, 1)
        got_fwd = {"loss": {"loss": hist["forward/loss"][0]},
                   "moment": program.leaves(fs.f, fs.opt.m, self.f_ops),
                   "change": {k: v - w["f"][k] for k, v in
                              program.leaves(fs.f, fs.params, self.f_ops).items()}}
        return (got_fwd, got_gan), (f_rows, f_seeds, gan_rows)

    def setup(self) -> None:
        from pigan_thz_torch.train.steps import StepSettings

        cfg, dev = self.cfg, self.device
        self.pc = pc = program.port_config(cfg)
        self.train_set = inputs.training_set(cfg, self.seed, dev)
        self.ds = program.dataset(pc, self.train_set, dev)
        # the command's settings: train --mode full, no --fixed-physics, no EMA
        self.settings = StepSettings.from_config(pc, detach_forward=True, ema_decay=0.0)
        self.spe = max(1, cfg["num_samples"] // self.b)
        self.f_ops, self.g_ops = M.forward_layers(cfg), M.generator_layers(cfg)
        self.d_ops = M.discriminator_layers(cfg)
        self.hook = ChunkHook()
        self.w, self.got, self.draws, self.checked = [], [], [], []
        for k in range(self.traffic["check_trios"]):
            t = self._trainer(self.hook if k == 0 else None)
            self.w.append(self._weights(k))
            got, draws = self._first_epochs(t, self.w[k])
            self.got.append(got)
            self.draws.append(draws)
            self.checked.append(t)
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def _gd(self, ps, g_flat, d_flat, w_g=None, w_d=None) -> dict:
        """G's and D's leaves, "g:" / "d:" before each name."""
        out = {}
        for tag, module, flat, ops, w in (("g", ps.g, g_flat, self.g_ops, w_g),
                                          ("d", ps.d, d_flat, self.d_ops, w_d)):
            src = ({n: w[n] for n, _, _ in M.param_layout(ops)} if w is not None
                   else program.leaves(module, flat, ops))
            out.update({f"{tag}:{n}": t for n, t in src.items()})
        return out

    # ------------------------------------------------------------------
    def window(self, seconds: float, trace: bool) -> dict:
        if trace:
            first, end = self.traffic["trace_epochs"]
            self.hook.plan = {"forward/": (first, end), "pigan/": (first, end)}
        fwd, gan = self.cfg["train"]["forward_epochs"], self.cfg["train"]["gan_epochs"]
        trios, f_epochs, g_epochs = 0, 0, 0
        t_start = time.perf_counter()
        while True:
            if trios < len(self.checked):
                # a checked trio goes on from its first epochs: the rest of
                # F's phase, then the rest of the GAN's against the trained F
                t, self.checked[trios] = self.checked[trios], None
                t.pretrain_forward(epochs=fwd - 1)
                t.init_pigan()
                t.train_pigan(epochs=gan - 1, settings=self.settings, seed=1)
                f_epochs, g_epochs = f_epochs + fwd - 1, g_epochs + gan - 1
            else:
                t = self._trainer()
                self._trio(t)
                f_epochs, g_epochs = f_epochs + fwd, g_epochs + gan
            del t
            trios += 1
            if time.perf_counter() - t_start >= seconds:
                break
        window_s = time.perf_counter() - t_start
        self.checked = []
        per_phase = (self.traffic["trace_epochs"][1] - self.traffic["trace_epochs"][0]) * self.spe
        traced = per_phase if self.hook.segments else 0
        # the window without the traced segments, whose tracer slows the host
        return {"window_s": window_s, "steps": (f_epochs + g_epochs) * self.spe, "trios": trios,
                "segments": self.hook.segments, "traced_steps_per_phase": per_phase,
                "free_s": window_s - self.hook.outer_s,
                "free_fwd_steps": f_epochs * self.spe - traced,
                "free_gan_steps": g_epochs * self.spe - traced}

    def release(self) -> None:
        self.ds = None

    # ------------------------------------------------------------------
    def reference_readings(self, precision: str = "fp32", batch_cut: int | None = None) -> list:
        """Each checked trio's (F's readings, the GAN's readings) of the
        reference over its first epochs, computed in ``precision``;
        ``batch_cut`` keeps only the first rows of each batch (a planted
        fault)."""
        cfg, ts, spe, tc = self.cfg, self.train_set, self.spe, self.cfg["train"]
        params_norm = M.normalize_params(ts["params"], cfg)
        metrics_norm = M.normalize_metrics(ts["metrics"])
        out = []
        for w, (f_rows, f_seeds, gan_rows) in zip(self.w, self.draws):
            fwd = R.ForwardTrainer(cfg, w["f"], decay_steps=tc["forward_epochs"] * spe,
                                   precision=precision)
            for k in range(spe):
                r = f_rows[0, k].to(self.device)
                fwd.step(ts["spectra"][r], params_norm[r], metrics_norm[r], int(f_seeds[k]),
                         batch_cut=batch_cut)
            got_f = {"losses": {"loss": fwd.losses},
                     "moment": {n: v.clone() for n, v in fwd.opt.m.items()},
                     "first_grad": fwd.opt.first_grad,
                     "change": {n: v.detach() - w["f"][n] for n, v in fwd.params.items()}}
            gan = R.GanTrainer(cfg, w["g"], w["d"], w["f"],
                               g_decay_steps=tc["gan_epochs"] * spe,
                               d_every=max(1, int(tc["gan_epochs"] * 0.25) * spe),
                               precision=precision)
            for k in range(spe):
                r = gan_rows[0, k].to(self.device)
                gan.step(ts["spectra"][r], ts["params"][r], metrics_norm[r], batch_cut=batch_cut)
            tagged = (lambda g, d: {**{f"g:{n}": v for n, v in g.items()},
                                    **{f"d:{n}": v for n, v in d.items()}})
            got_g = {"losses": {"d_loss": gan.d_losses, "g_loss": gan.g_losses},
                     "moment": tagged(gan.g_opt.m, gan.d_opt.m),
                     "first_grad": tagged(gan.g_opt.first_grad, gan.d_opt.first_grad),
                     "change": tagged({n: v.detach() - w["g"][n] for n, v in gan.g.items()},
                                      {n: v.detach() - w["d"][n] for n, v in gan.d.items()})}
            for got in (got_f, got_g):
                got["loss"] = {k: sum(v) / len(v) for k, v in got["losses"].items()}
            out.append((got_f, got_g))
        return out

    def readings(self, prog: list, ref: list) -> dict:
        """Every number of the check, compared or not: each loss by the
        median trio, the leaves of every trio together."""
        out = {}
        for prefix, j in (("fwd", 0), ("gan", 1)):
            p, r = [x[j] for x in prog], [x[j] for x in ref]
            out.update({f"{prefix}.{k}_gap": statistics.median(
                compare.loss_gap(pt["loss"][k], rt["losses"][k]) for pt, rt in zip(p, r))
                for k in p[0]["loss"]})
            out.update(compare.leaf_readings(
                prefix, {k: compare.merged(p, k) for k in ("moment", "change")},
                {k: compare.merged(r, k) for k in ("moment", "change", "first_grad")}))
        n = self.cfg["num_samples"]
        out["draws.repeated_rows"] = sum(compare.repeated_rows(d, n) for draws in self.draws
                                         for d in (draws[0], draws[2]))
        return out

    def check(self, stand_in: list | None = None) -> dict:
        """The numbers of the program's checked epochs (or of ``stand_in``,
        readings put in the program's place) against the reference."""
        prog = stand_in if stand_in is not None else self.got
        every = self.readings(prog, self.reference_readings())
        return {k: every[k] for k in COMPARED}
