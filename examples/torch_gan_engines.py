"""One PI-GAN run through three engines from one state (pigan_thz_torch):
the GAN-training kernel, its plain PyTorch version and the eager autograd
step.

Two float32 implementations of a GAN step drift apart within tens of steps
(chip_smoke.py holds them over 30).  This script asks what that drift is
worth at the end of a run: it pretrains F once through the Trainer, then
from one initial state and one shuffle sequence trains the reference
workload's GAN phase (``train --mode full --fixed-physics``: gradients
through the frozen F, 500 epochs of 15 steps) three times, and prints each
engine's final losses and the evaluator's param R², violation rate and
cycle error as one JSON line.

    python examples/torch_gan_engines.py                      # on the card
    python examples/torch_gan_engines.py --device cpu --epochs 2 \
        --fwd-epochs 2 --set data.num_samples=128   # plain version and eager step

The default device is cuda, and there is no fallback to the CPU, where
there is no kernel: the "kernel" entry then is the plain version too.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from pigan_thz_torch import apply_overrides, default_config
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.evaluate import Evaluator
from pigan_thz_torch.ops import gan_train as gt
from pigan_thz_torch.ops._cuda_build import LAUNCHES
from pigan_thz_torch.train.steps import StepSettings, make_multi_epoch_fn, make_pigan_step
from pigan_thz_torch.train.trainer import Trainer


def plain_epoch_fn(cfg, settings):
    """``make_gan_epoch_fn``'s contract through the kernel's plain version,
    whatever the device: the same draws, streams and counts."""
    from pigan_thz_torch.train.schedules import cosine_schedule, step_schedule

    spec = gt.gan_train_spec(cfg, settings)
    batch = cfg.train.batch_size

    def multi_epoch(state, ds, scales):
        scales = torch.as_tensor(scales, dtype=torch.float32).reshape(-1)
        epochs = int(scales.numel())
        spe = max(1, ds.num_samples // batch)
        indices, seeds = gt.resolve_draws(state.generator, ds.num_samples, batch, epochs)
        streams = gt.build_streams(
            ds, indices, scales, state.step, state.g_opt.count, state.d_opt.count,
            int(settings.d_update_every),
            cosine_schedule(cfg.train.lr_g, cfg.train.num_epochs, spe, 0.01),
            step_schedule(cfg.train.lr_d, cfg.train.num_epochs, spe, 0.5, 0.25),
            settings=settings, seeds=seeds)
        for bn in state.batch_norms():
            bn.num_batches_tracked += epochs * spe
        rows = gt.gan_train_plain(gt.state_buffers(state), streams, spec)
        state.step += epochs * spe
        state.g_opt.count += epochs * spe
        state.d_opt.count += int(streams.sched[:, 6].sum())
        return state, gt.epoch_means(rows, epochs, bool(settings.constraint_w))

    return multi_epoch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--fwd-epochs", type=int, default=500)
    ap.add_argument("--epochs-per-call", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=3000)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    args = ap.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu to compare the plain version with the "
              "eager step there", file=sys.stderr)
        return 1
    card = "cpu"
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    cfg = apply_overrides(default_config(), args.set)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, num_epochs=args.epochs))
    ds = synthetic_dataset(cfg.data, device=device)
    trainer = Trainer(cfg, ds=ds, epochs_per_call=args.epochs_per_call, device=device,
                      engine="auto" if device.type == "cuda" else "kernel")
    trainer.pretrain_forward(epochs=args.fwd_epochs, log_every=10**9)
    start = trainer.init_pigan()
    settings = StepSettings.from_config(cfg, detach_forward=False)
    engines = {
        "kernel": gt.make_gan_epoch_fn(cfg, settings),
        "plain": plain_epoch_fn(cfg, settings),
        "eager": make_multi_epoch_fn(
            make_pigan_step(trainer.g_tx, trainer.d_tx, settings, ds.param_lo, ds.param_hi),
            cfg.train.batch_size),
    }
    out = {"card": card, "epochs": args.epochs, "fwd_epochs": args.fwd_epochs,
           "steps": args.epochs * trainer.steps_per_epoch, "engines": {}}
    for name, fn in engines.items():
        state = start.clone()
        state.generator.manual_seed(args.seed)           # one shuffle sequence for all
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        last = {}
        for done in range(0, args.epochs, args.epochs_per_call):
            chunk = min(args.epochs_per_call, args.epochs - done)
            state, rows = fn(state, ds, torch.ones(chunk))
            last = {k: float(v[-1]) for k, v in rows.items()}
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not state.is_finite():
            print(f"{name}: non-finite state", file=sys.stderr)
            return 1
        ev = Evaluator(state.g, state.d, state.f).run_comprehensive_evaluation(ds)
        out["engines"][name] = {
            "wall_s": wall,
            "gan_train_launches": LAUNCHES["gan_train"] - before["gan_train"],
            "param_r2": ev["pigan_evaluation"]["parameter_prediction"]["r2"],
            "violation_rate":
                ev["structural_prediction_evaluation"]["param_range_violation_rate"],
            "cycle_error": ev["model_validation"]["cycle_consistency_error_mean"],
            "final_recon_spec_loss": last["recon_spec_loss"],
            "final_g_loss": last["g_loss"], "final_d_loss": last["d_loss"],
            "steps": state.step,
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
