"""Seed ensembles on the member-packed GAN kernel, phase after phase.

A phase trains ``members`` fresh members for ``cfg.train.gan_epochs`` epochs
against one frozen F, the benchmark's, from the seed:
``parallel/ensemble_megakernel.py:train_seed_ensemble(..., packed=True)``,
one call of the packed multi-epoch function
(``ops/gan_train.py:make_gan_ensemble_fn``, one launch a chunk) per chunk of
25 epochs, then one host transfer of every member's rows and a finite check.

``train_seed_ensemble`` draws its members' weights inside and cannot take
others, so phase 0, whose members are checked, runs the same loop from
here: set-up builds its members (the program's initialisation, then the
benchmark's weights copied in) and trains them one epoch, one launch of 15
steps on the rows each member drew itself (read back by replaying its
generator, ``program.replay_draws``).  The window trains phase 0 on to its
end, chunk by chunk, then calls ``train_seed_ensemble`` itself for every
further phase until a phase ends past ``--seconds``; its rate is
member-steps over the window's host time.  The check follows each member's
checked epoch with the reference: each loss by the median member, the
leaves of the four members together.
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
COMPARED = ("ens.d_loss_gap", "ens.moment_median_gap", "ens.change_gap",
            "ens.change_median_gap", "draws.repeated_rows")


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.b, self.members = cfg["batch_size"], traffic["members"]

    def _seed_of(self, phase: int) -> int:
        return inputs.derive(self.seed, "phase", phase) % 2**62

    def _states(self, phase: int):
        """Phase ``phase``'s members as ``train_seed_ensemble`` builds them,
        with the benchmark's weights copied in."""
        from pigan_thz_torch.parallel.ensemble import init_ensemble_states, member_generator

        gens = [member_generator(self._seed_of(phase), i) for i in range(self.members)]
        states = init_ensemble_states(self.g_tmpl, self.d_tmpl, self.f_tmpl, self.g_tx,
                                      self.d_tx, gens, device=self.device)
        for m, st in enumerate(states):
            program.load_(st.g, self.w_g[m], self.g_ops)
            program.load_(st.d, self.w_d[m], self.d_ops)
        return states

    def _entry(self, phase: int, epochs: int) -> None:
        """One phase through the program's entry point."""
        from pigan_thz_torch.parallel.ensemble_megakernel import train_seed_ensemble

        train_seed_ensemble(self.pc, self.ds, self.members, settings=self.settings,
                            epochs=epochs, seed=self._seed_of(phase),
                            epochs_per_call=self.traffic["epochs_per_call"],
                            forward_model=self.f_tmpl, packed=True, devices=[self.device])

    def setup(self) -> None:
        from pigan_thz_torch.models.registry import build_trio
        from pigan_thz_torch.ops.gan_train import make_gan_ensemble_fn
        from pigan_thz_torch.train.state import make_optimizers
        from pigan_thz_torch.train.steps import StepSettings

        cfg, dev, b, n = self.cfg, self.device, self.b, self.members
        self.pc = pc = program.port_config(cfg)
        self.train_set = inputs.training_set(cfg, self.seed, dev)
        self.ds = program.dataset(pc, self.train_set, dev)
        self.spe = max(1, cfg["num_samples"] // b)
        self.settings = StepSettings.from_config(pc)          # train_seed_ensemble's default
        self.g_tmpl, self.d_tmpl, self.f_tmpl = build_trio(pc, device="cpu")
        self.g_tx, self.d_tx, _ = make_optimizers(pc, self.spe)
        self.f_ops, self.g_ops = M.forward_layers(cfg), M.generator_layers(cfg)
        self.d_ops = M.discriminator_layers(cfg)
        self.w_f = inputs.make_weights(M.param_layout(self.f_ops), self.seed, dev, "F")
        program.load_(self.f_tmpl, self.w_f, self.f_ops)
        self.w_g = [inputs.make_weights(M.param_layout(self.g_ops) + M.buffer_layout(self.g_ops),
                                        self.seed, dev, "G", m) for m in range(n)]
        self.w_d = [inputs.make_weights(M.param_layout(self.d_ops), self.seed, dev, "D", m)
                    for m in range(n)]
        self.fn = make_gan_ensemble_fn(pc, self.settings, n)
        self._entry(-1, 1)                                      # warm-up

        states = self._states(0)
        before = [states[m].generator.get_state() for m in range(n)]
        states, rows = self._chunk(states, 1)
        self.rows = [program.replay_draws(before[m], states[m].generator, cfg["num_samples"],
                                          b, 1)[0] for m in range(n)]
        got = []
        for m in range(n):
            st = states[m]
            moment = {**{f"g:{x}": t for x, t in program.leaves(
                st.g, st.g_opt.m, self.g_ops).items()},
                **{f"d:{x}": t for x, t in program.leaves(st.d, st.d_opt.m, self.d_ops).items()}}
            change = {**{f"g:{x}": t - self.w_g[m][x] for x, t in program.leaves(
                st.g, st.g_params, self.g_ops).items()},
                **{f"d:{x}": t - self.w_d[m][x] for x, t in program.leaves(
                    st.d, st.d_params, self.d_ops).items()}}
            got.append({"loss": {"d_loss": float(rows[m]["d_loss"][0]),
                                 "g_loss": float(rows[m]["g_loss"][0])},
                        "moment": moment, "change": change})
        self.got = got
        self.first = states
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def _chunk(self, states, epochs: int):
        """One chunk as ``train_seed_ensemble`` runs it: the packed launch,
        then one host transfer of every member's rows and the finite check."""
        states, rows = self.fn(states, self.ds, torch.ones(epochs))
        host = torch.cat([torch.stack(list(r.values())).reshape(-1).cpu() for r in rows])
        if not bool(torch.isfinite(host).all()) or not states.is_finite():
            raise FloatingPointError("non-finite rows or state after a chunk: training diverged")
        return states, rows

    # ------------------------------------------------------------------
    def window(self, seconds: float, trace: bool) -> dict:
        epochs, per_call = self.cfg["train"]["gan_epochs"], self.traffic["epochs_per_call"]
        first, end = self.traffic["trace_chunks"]
        seg, phases, done_epochs = None, 0, 0
        t_start = time.perf_counter()
        while True:
            if phases == 0:
                # phase 0 goes on from its checked epoch
                states, self.first = self.first, None
                done, c = 1, 0
                while done < epochs:
                    if trace and c == first:
                        seg = Segment("ensemble")
                        seg.start()
                    states, _ = self._chunk(states, min(per_call, epochs - done))
                    done += min(per_call, epochs - done)
                    if seg is not None and c == end - 1:
                        seg.stop()
                    c += 1
                del states
                done_epochs += epochs - 1
            else:
                self._entry(phases, epochs)
                done_epochs += epochs
            phases += 1
            if time.perf_counter() - t_start >= seconds:
                break
        window_s = time.perf_counter() - t_start
        per_phase = (end - first) * per_call * self.spe
        traced = per_phase if seg is not None else 0
        steps = done_epochs * self.spe
        return {"window_s": window_s, "steps": steps * self.members, "phases": phases,
                "members": self.members, "segments": [seg.summary] if seg else [],
                "traced_steps_per_phase": per_phase,
                "free_s": window_s - (seg.outer_s if seg else 0.0),
                "free_fwd_steps": 0, "free_gan_steps": steps - traced}

    def release(self) -> None:
        self.ds = self.fn = None

    # ------------------------------------------------------------------
    def reference_readings(self, precision: str = "fp32", batch_cut: int | None = None) -> list:
        """Each member's readings of the reference over its checked epoch."""
        cfg, ts, spe, tc = self.cfg, self.train_set, self.spe, self.cfg["train"]
        metrics_norm = M.normalize_metrics(ts["metrics"])
        out = []
        for m in range(self.members):
            gan = R.GanTrainer(cfg, self.w_g[m], self.w_d[m], self.w_f,
                               g_decay_steps=tc["gan_epochs"] * spe,
                               d_every=max(1, int(tc["gan_epochs"] * 0.25) * spe),
                               precision=precision)
            for k in range(spe):
                r = self.rows[m][0, k].to(self.device)
                gan.step(ts["spectra"][r], ts["params"][r], metrics_norm[r], batch_cut=batch_cut)
            tagged = (lambda g, d: {**{f"g:{x}": v for x, v in g.items()},
                                    **{f"d:{x}": v for x, v in d.items()}})
            losses = {"d_loss": gan.d_losses, "g_loss": gan.g_losses}
            out.append({"losses": losses,
                        "loss": {k: sum(v) / len(v) for k, v in losses.items()},
                        "moment": tagged(gan.g_opt.m, gan.d_opt.m),
                        "first_grad": tagged(gan.g_opt.first_grad, gan.d_opt.first_grad),
                        "change": tagged(
                            {x: v.detach() - self.w_g[m][x] for x, v in gan.g.items()},
                            {x: v.detach() - self.w_d[m][x] for x, v in gan.d.items()})})
        return out

    def readings(self, prog: list, ref: list) -> dict:
        """Every number of the check, compared or not: each loss by the
        median member, the leaves of every member together."""
        out = {f"ens.{k}_gap": statistics.median(compare.loss_gap(p["loss"][k], r["losses"][k])
                                                 for p, r in zip(prog, ref))
               for k in ("d_loss", "g_loss")}
        out.update(compare.leaf_readings(
            "ens", {k: compare.merged(prog, k) for k in ("moment", "change")},
            {k: compare.merged(ref, k) for k in ("moment", "change", "first_grad")}))
        out["draws.repeated_rows"] = sum(compare.repeated_rows(r, self.cfg["num_samples"])
                                         for r in self.rows)
        return out

    def check(self, stand_in: list | None = None) -> dict:
        prog = stand_in if stand_in is not None else self.got
        every = self.readings(prog, self.reference_readings())
        return {k: every[k] for k in COMPARED}
