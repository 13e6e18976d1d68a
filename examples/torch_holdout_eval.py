"""Held-out evaluation protocol through the port (pigan_thz_torch): the
counterpart of examples/holdout_eval.py, with its arguments, horizons and
JSON keys.

Trains on an 800-sample split through the Trainer (on the card: the peaks
kernel K4 for the dataset, the forward-training kernel K1, the GAN-training
kernel K2, whose EMA path is there), then evaluates all four suites on the
200 unseen cells, the honest protocol the reference lacks (it evaluates on
its training CSV), and prints the statistical ceilings implied by the noise
level: with draw-to-draw R² c, the best score a model can reach against a
noisy target is (1 + c) / 2 (``evaluate/ceilings.py``).

    python examples/torch_holdout_eval.py --gan-epochs 1000
    python examples/torch_holdout_eval.py --gan-epochs 1000 --ema-decay 0.999
    python examples/torch_holdout_eval.py --device cpu --gan-epochs 2 \
        --fwd-epochs 2 --chunk 1 --set data.num_samples=128

The split is the port's ``split_dataset`` with split seed 9, not the JAX
package's split for that seed.  The default device is cuda, with no
fallback to the CPU; on the CPU the kernels' plain versions run.
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
from pigan_thz_torch.evaluate.ceilings import noise_ceilings
from pigan_thz_torch.ops._cuda_build import launch_counts
from pigan_thz_torch.train.steps import StepSettings
from pigan_thz_torch.train.trainer import Trainer


def row(ev: dict) -> dict:
    return {
        "param_r2": round(ev["pigan_evaluation"]["parameter_prediction"]["r2"], 4),
        "spectrum_r2": round(ev["forward_network_evaluation"]["spectrum_prediction"]["r2"], 4),
        "metrics_r2": round(ev["forward_network_evaluation"]["metrics_prediction"]["r2"], 4),
        "cycle": round(ev["model_validation"]["cycle_consistency_error_mean"], 6),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gan-epochs", type=int, default=1000)
    ap.add_argument("--fwd-epochs", type=int, default=500)
    ap.add_argument("--val-frac", type=float, default=0.2)
    ap.add_argument("--ema-decay", type=float, default=0.0,
                    help="also train and evaluate a generator EMA track")
    ap.add_argument("--chunk", type=int, default=50, help="epochs per launch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override, e.g. data.num_samples=128")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: this example trains on the card; --device cpu runs the "
              "kernels' plain versions", file=sys.stderr)
        return 1
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.time()
    cfg = apply_overrides(default_config(), args.set)
    # the schedules' horizons are the budgets: a mismatched cosine horizon
    # caps quality
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, num_epochs=args.gan_epochs, fwd_pretrain_epochs=args.fwd_epochs))
    full = synthetic_dataset(cfg.data, device=device)
    train_ds, val_ds = split_dataset(full, val_frac=args.val_frac,
                                     generator=torch.Generator().manual_seed(9))
    engine = "auto" if device.type == "cuda" else "kernel"
    trainer = Trainer(cfg, ds=train_ds, epochs_per_call=args.chunk, engine=engine,
                      device=device)
    trainer.pretrain_forward(epochs=args.fwd_epochs, log_every=10**9)
    trainer.init_pigan()
    trainer.train_pigan(
        epochs=args.gan_epochs, log_every=10**9,
        settings=StepSettings.from_config(cfg, detach_forward=False,
                                          ema_decay=args.ema_decay))

    out = {
        "ceilings": {k: round(v, 4) for k, v in noise_ceilings(cfg.data,
                                                               device=device).items()},
        "train": row(trainer.evaluate()),
        "heldout": row(trainer.evaluator().run_comprehensive_evaluation(val_ds)),
    }
    if args.ema_decay > 0.0:
        out["heldout_ema"] = row(
            trainer.evaluator(use_ema=True).run_comprehensive_evaluation(val_ds))
    out["wall_s"] = round(time.time() - t0, 1)
    print(f"kernel launches: {launch_counts()}", file=sys.stderr)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
