"""Resumable full training pipeline (preemption-safe), on the port.

The counterpart of examples/full_pipeline.py.  Every stage saves its full
state after each chunk of epochs, and a rerun on the same ``--workdir``
resumes from the last completed chunk.  Run it under any supervisor that
restarts it on failure, e.g.:

    for i in $(seq 12); do timeout 600 python examples/torch_full_pipeline.py \\
        --workdir runs/pipeline && break; done
    python examples/torch_full_pipeline.py --device cpu --fwd-epochs 2 \\
        --gan-epochs 2 --ft-epochs 2 --chunk 1 \\
        --set data.num_samples=128 --set train.batch_size=32   # the CPU

Stages: forward pretraining (500 epochs) -> PI-GAN (500, physics gradients
through the frozen F) -> constraint repair (100, annealed constraint on the
raw output) -> the repair's acceptance gate -> evaluation -> final
artifacts.  ``progress.json`` counts each stage's completed epochs; a stage
with epochs done resumes the checkpoint of exactly that epoch, so a kill
between a checkpoint and its ``progress.json`` line costs one chunk, not the
run.  The forward chunks continue the state's generator, which the
checkpoint carries, so a resumed run is the uninterrupted one bit for bit.

The default device is cuda (the training kernels), and there is no fallback
to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from pigan_thz_torch import apply_overrides, default_config
from pigan_thz_torch.ops._cuda_build import launch_counts
from pigan_thz_torch.train import checkpoint as ckpt
from pigan_thz_torch.train.programs import _anneal, constraint_phase
from pigan_thz_torch.train.steps import StepSettings
from pigan_thz_torch.train.trainer import Trainer


def load_progress(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as fh:
            return json.load(fh)
    return {"fwd_epochs": 0, "gan_epochs": 0, "ft_epochs": 0}


def save_progress(path: str, prog: dict) -> None:
    tmp = path + ".partial"
    with open(tmp, "w") as fh:
        json.dump(prog, fh)
    os.replace(tmp, path)


def resume_or_die(trainer: Trainer, mgr, which: str, stage: str, done: int) -> None:
    """``progress.json`` says ``stage`` has completed ``done`` epochs: that
    epoch's checkpoint must exist.  Training on from a fresh random state (a
    GAN against an untrained surrogate) would be far worse than failing."""
    try:
        step = trainer.resume_from(mgr, which, epoch=done)
    except FileNotFoundError:
        step = None
    if step is None:
        raise RuntimeError(
            f"progress.json records {stage}={done} but the '{stage}' checkpoint of "
            f"epoch {done} is not in {mgr.directory}: an inconsistent workdir; delete it "
            "or repair progress.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default="runs/pigan_pipeline")
    ap.add_argument("--fwd-epochs", type=int, default=500)
    ap.add_argument("--gan-epochs", type=int, default=500)
    ap.add_argument("--ft-epochs", type=int, default=100)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override, e.g. data.num_samples=128")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here (pass --device cpu "
                         "to run on the CPU)")

    os.makedirs(args.workdir, exist_ok=True)
    prog_path = os.path.join(args.workdir, "progress.json")
    prog = load_progress(prog_path)
    t0 = time.time()
    print(f"resume state: {prog}", flush=True)

    cfg = apply_overrides(default_config(), args.set)
    trainer = Trainer(cfg, epochs_per_call=args.chunk, device=device)

    # ---- stage 1: forward pretraining (chunk-resumable) -------------------
    # The whole ForwardState (weights, Adam's moments and count, the
    # generator, the step) and the history ride in every checkpoint.
    fwd_mgr = ckpt.CheckpointManager(os.path.join(args.workdir, "fwd"),
                                     max_to_keep=2, save_interval=1)
    if prog["fwd_epochs"] > 0:
        trainer.pretrain_forward(epochs=0)          # the state, to restore into
        resume_or_die(trainer, fwd_mgr, "forward", "fwd_epochs", prog["fwd_epochs"])
    while prog["fwd_epochs"] < args.fwd_epochs:
        n = min(args.chunk, args.fwd_epochs - prog["fwd_epochs"])
        trainer.pretrain_forward(epochs=n, log_every=10**9, seed=prog["fwd_epochs"])
        prog["fwd_epochs"] += n
        fwd_mgr.save(prog["fwd_epochs"], trainer.forward_state,
                     history=trainer.train_history, config=cfg)
        save_progress(prog_path, prog)
        print(f"fwd {prog['fwd_epochs']}/{args.fwd_epochs} ({time.time() - t0:.0f}s)",
              flush=True)
    fwd_mgr.close()

    # ---- stage 2: PI-GAN ----------------------------------------------------
    settings = StepSettings.from_config(cfg, detach_forward=False)
    mgr = ckpt.CheckpointManager(os.path.join(args.workdir, "gan"),
                                 max_to_keep=2, save_interval=1)
    trainer.init_pigan()
    if prog["gan_epochs"] > 0:
        resume_or_die(trainer, mgr, "pigan", "gan_epochs", prog["gan_epochs"])
    while prog["gan_epochs"] < args.gan_epochs:
        n = min(args.chunk, args.gan_epochs - prog["gan_epochs"])
        trainer.train_pigan(epochs=n, log_every=10**9, settings=settings,
                            seed=prog["gan_epochs"])
        prog["gan_epochs"] += n
        mgr.save(prog["gan_epochs"], trainer.pigan_state,
                 history=trainer.train_history, config=cfg)
        save_progress(prog_path, prog)
        print(f"gan {prog['gan_epochs']}/{args.gan_epochs} ({time.time() - t0:.0f}s)",
              flush=True)

    # ---- stage 3: constraint repair ----------------------------------------
    # The unified constraint trainer's repair (an annealed enhanced
    # constraint on the raw output), not the sigmoid-squash fine-tune:
    # training through a sigmoid while evaluating the raw generator is
    # incoherent (constraint_optimizer.py:38).
    ft_settings = constraint_phase(args.ft_epochs).gan_settings
    anneal = _anneal(0.5, 2.0, args.ft_epochs)
    ft_mgr = ckpt.CheckpointManager(os.path.join(args.workdir, "ft"),
                                    max_to_keep=2, save_interval=1)
    if prog["ft_epochs"] > 0:
        resume_or_die(trainer, ft_mgr, "pigan", "ft_epochs", prog["ft_epochs"])
    while prog["ft_epochs"] < args.ft_epochs:
        n = min(args.chunk, args.ft_epochs - prog["ft_epochs"])
        base = prog["ft_epochs"]
        trainer.train_pigan(
            epochs=n, log_every=10**9, settings=ft_settings,
            constraint_schedule=lambda e, base=base: anneal(base + e),
            snapshot_metric="violation_rate", snapshot_mode="min",
            seed=10_000 + prog["ft_epochs"])
        prog["ft_epochs"] += n
        ft_mgr.save(prog["ft_epochs"], trainer.pigan_state,
                    history=trainer.train_history, config=cfg)
        save_progress(prog_path, prog)
        print(f"ft {prog['ft_epochs']}/{args.ft_epochs} ({time.time() - t0:.0f}s)",
              flush=True)
    ft_mgr.close()

    # ---- the repair's acceptance gate ---------------------------------------
    # In parity mode the [0, 1] window is statistically unsatisfiable for a
    # healthy tanh generator (RESULTS.md), so the repair can buy violation
    # points only by wrecking the inverse map: accept the repaired model only
    # if its param R2 stays within 0.02 of the pre-repair one.
    ev_ft = trainer.evaluate()
    ft_r2 = ev_ft["pigan_evaluation"]["parameter_prediction"]["r2"]
    ft_viol = ev_ft["structural_prediction_evaluation"]["param_range_violation_rate"]
    ft_state = trainer.pigan_state.clone()
    trainer.resume_from(mgr, "pigan", epoch=prog["gan_epochs"])   # pre-repair
    ev_pre = trainer.evaluate()
    pre_r2 = ev_pre["pigan_evaluation"]["parameter_prediction"]["r2"]
    repair_accepted = ft_r2 >= pre_r2 - 0.02
    if repair_accepted:
        trainer.pigan_state = ft_state
        ev = ev_ft
    else:
        ev = ev_pre
        print(f"constraint repair REJECTED: param R2 {pre_r2:.4f} -> {ft_r2:.4f} "
              f"(violation {ft_viol:.3f}); shipping the pre-repair model", flush=True)
    mgr.close()

    # ---- evaluation and the finals -------------------------------------------
    summary = {
        "param_r2": ev["pigan_evaluation"]["parameter_prediction"]["r2"],
        "violation": ev["structural_prediction_evaluation"]["param_range_violation_rate"],
        "cycle": ev["model_validation"]["cycle_consistency_error_mean"],
        "plausibility": ev["model_validation"]["physical_plausibility_mean"],
        "consistency": ev["structural_prediction_evaluation"]["consistency_score_mean"],
        "d_acc": ev["pigan_evaluation"]["discriminator_performance"]["overall_accuracy"],
        "stability": ev["model_validation"]["prediction_stability_mean"],
        "metrics_r2": ev["forward_network_evaluation"]["metrics_prediction"]["r2"],
        "spectrum_r2": ev["forward_network_evaluation"]["spectrum_prediction"]["r2"],
        "repair_accepted": repair_accepted,
        "repair_param_r2": ft_r2,
        "repair_violation": ft_viol,
        "wall_s": time.time() - t0,
    }
    print(json.dumps(summary, indent=2), flush=True)
    with open(os.path.join(args.workdir, "final_eval.json"), "w") as fh:
        json.dump(ev, fh, indent=2)
    trainer.save_final(os.path.join(args.workdir, "saved_models"))
    with open(os.path.join(args.workdir, "DONE"), "w") as fh:
        fh.write("ok\n")
    print(f"kernel launches: {launch_counts()}")
    print("pipeline complete", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
