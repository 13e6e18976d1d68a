"""Seed-ensemble training through the port's GAN-training kernels
(pigan_thz_torch): the counterpart of examples/ensemble_megakernel_probe.py.

Pretrains the forward surrogate F through the Trainer (the forward-training
kernel), trains N independent GAN members against it with gradients through
the frozen F and the cosine horizon set to the budget, all members in ONE
member-packed kernel launch per chunk (or, with --unpacked, one solo launch
per member and chunk), scores every member and the ensemble mean, and prints
one JSON line.  With --holdout the members train on an 800-cell split
(validation fraction 0.2, split seed 9, the port's ``split_dataset``) and the
held-out 200 cells are scored too: the honest protocol of
examples/seed_search.py --holdout (its split is the JAX package's own, not
this one).

    python examples/torch_seed_ensemble.py --members 4 --epochs 500
    python examples/torch_seed_ensemble.py --members 4 --epochs 500 --holdout
    python examples/torch_seed_ensemble.py --device cpu --members 2 \
        --epochs 2 --fwd-epochs 2        # the kernels' plain versions

The default device is cuda, and there is no fallback to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from pigan_thz_torch import apply_overrides, default_config
from pigan_thz_torch.data import split_dataset, synthetic_dataset
from pigan_thz_torch.ops._cuda_build import launch_counts
from pigan_thz_torch.parallel.ensemble import evaluate_ensemble, evaluate_ensemble_mean
from pigan_thz_torch.parallel.ensemble_megakernel import train_seed_ensemble
from pigan_thz_torch.train.steps import StepSettings
from pigan_thz_torch.train.trainer import Trainer


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--fwd-epochs", type=int, default=500)
    ap.add_argument("--epochs-per-call", type=int, default=25)
    ap.add_argument("--unpacked", action="store_true",
                    help="one solo launch per member and chunk instead of one packed launch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override, e.g. data.num_samples=128")
    ap.add_argument("--save", metavar="PATH",
                    help="write the members' stacked buffers and the frozen F (torch.save)")
    ap.add_argument("--holdout", action="store_true",
                    help="train on an 800-cell split; also score the held-out cells")
    args = ap.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: this example trains on the card; --device cpu runs the "
              "kernels' plain versions", file=sys.stderr)
        return 1
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    cfg = apply_overrides(default_config(), args.set)
    # the learning-rate horizon is the budget: the default 500-epoch cosine
    # would stop a longer run's members short, or never decay a shorter one's
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, num_epochs=args.epochs))
    ds = synthetic_dataset(cfg.data, device=device)
    heldout = None
    if args.holdout:
        ds, heldout = split_dataset(ds, val_frac=0.2,
                                    generator=torch.Generator().manual_seed(9))
    engine = "auto" if device.type == "cuda" else "kernel"
    trainer = Trainer(cfg, ds=ds, epochs_per_call=args.epochs_per_call, engine=engine,
                      device=device)
    trainer.pretrain_forward(epochs=args.fwd_epochs, log_every=10**9)

    settings = StepSettings.from_config(cfg, detach_forward=False)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, metrics = train_seed_ensemble(
        cfg, ds, args.members, settings=settings, epochs=args.epochs, seed=args.seed,
        devices=[device], epochs_per_call=args.epochs_per_call,
        forward_model=trainer.forward_state.f, packed=not args.unpacked)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    spe = max(1, ds.num_samples // cfg.train.batch_size)
    ev = {k: v.tolist() for k, v in evaluate_ensemble(states, ds).items()}
    mean_ev = {k: float(v) for k, v in evaluate_ensemble_mean(states, ds).items()}
    scores = {}
    if heldout is not None:
        scores = {
            "heldout_cells": heldout.num_samples,
            "heldout_member_r2": evaluate_ensemble(states, heldout)["param_r2"].tolist(),
            "heldout_ensemble_mean_r2": float(
                evaluate_ensemble_mean(states, heldout)["param_r2"]),
        }
    if args.save:
        torch.save({"g": states.g_params.cpu(), "d": states.d_params.cpu(),
                    "bn": [t.cpu() for t in states.bn], "f": states.f_params.cpu(),
                    "g_m": states.g_m.cpu(), "g_v": states.g_v.cpu(),
                    "d_m": states.d_m.cpu(), "d_v": states.d_v.cpu()}, args.save)
    print(json.dumps({
        "members": args.members,
        "epochs": args.epochs,
        "train_cells": ds.num_samples,
        "steps_per_epoch": spe,
        "packed": not args.unpacked,
        "device": str(device),
        "launches": launch_counts(),
        "wall_s": wall,
        "member_steps_per_s": args.members * args.epochs * spe / wall,
        "first_recon_spec_loss": metrics["recon_spec_loss"][:, 0].tolist(),
        "final_recon_spec_loss": metrics["recon_spec_loss"][:, -1].tolist(),
        "final_g_loss": metrics["g_loss"][:, -1].tolist(),
        "all_rows_finite": bool(all(bool((v == v).all()) and abs(v).max() != float("inf")
                                    for v in metrics.values())),
        "member_r2": ev["param_r2"],
        "member_recon_mse": ev["recon_mse"],
        "ensemble_mean_r2": mean_ev["param_r2"],
        "ensemble_mean_recon_mse": mean_ev["recon_mse"],
        "member_spread": mean_ev["member_spread"],
        **scores,
        "ok": bool(all(x > 0.5 for x in ev["param_r2"])),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
