"""The seed search through the port's member-packed GAN-training kernel
(pigan_thz_torch): the counterpart of examples/seed_search.py, with its
arguments, its recipe and its JSON rows.

N PI-GAN trainings from different initial seeds against one pretrained
frozen F, on the same batches, with gradients through F and the cosine
horizon set to the budget, all members in one K3 launch per 25 epochs
(``--engine eager``: the λ-ensemble step with the default loss weights, one
member at a time).  Every ``--eval-every`` epochs it prints one JSON row,
each member's param R² on the training cells (and, with ``--holdout``, on the
200 held-out cells) and the ensemble mean's on the scored split, and keeps
the best member or mean.  The last line is the best.

    python examples/torch_seed_search.py --epochs 24000
    python examples/torch_seed_search.py --epochs 8000 --holdout --save-best runs/search
    python -m pigan_thz_torch export --artifact ensemble --ensemble-members 4 \
        --models runs/search          # when the ensemble mean won
    python examples/torch_seed_search.py --device cpu --members 2 --epochs 2 \
        --fwd-epochs 2 --eval-every 1 --set data.num_samples=128

``--holdout`` splits with the port's ``split_dataset`` (validation fraction
0.2, split seed 9), not the JAX package's split for that seed.
``--save-best DIR`` writes the winning member as the final trio, or, when
the ensemble mean wins, every member as ``DIR/ensemble_best.pt``, and
``model_config.json`` beside either.  The default device is cuda, with no
fallback to the CPU; on the CPU the kernel engine runs K3's plain version.
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
from pigan_thz_torch.parallel.ensemble_megakernel import (SEARCH_ENGINES, save_ensemble_best,
                                                          seed_search)
from pigan_thz_torch.parallel.state_utils import tree_unstack
from pigan_thz_torch.train import checkpoint as ckpt
from pigan_thz_torch.train.trainer import Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=24000)
    ap.add_argument("--fwd-epochs", type=int, default=500)
    ap.add_argument("--eval-every", type=int, default=2000)
    ap.add_argument("--holdout", action="store_true",
                    help="train on an 800-cell split; report held-out scores")
    ap.add_argument("--save-best", metavar="DIR", default=None,
                    help="persist the best snapshot: the winning member as the final trio, "
                         "or every member (ensemble_best.pt) when the ensemble mean wins")
    ap.add_argument("--engine", choices=SEARCH_ENGINES, default="kernel")
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
    # the learning-rate horizon is the budget: the default 500-epoch cosine
    # caps the members' param R2 near 0.984
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, num_epochs=args.epochs))
    train_ds = synthetic_dataset(cfg.data, device=device)
    heldout = None
    if args.holdout:
        train_ds, heldout = split_dataset(train_ds, val_frac=0.2,
                                          generator=torch.Generator().manual_seed(9))
    f_engine = "auto" if device.type == "cuda" else "kernel"
    trainer = Trainer(cfg, ds=train_ds, epochs_per_call=50, engine=f_engine, device=device,
                      shadow_parity="off")
    trainer.pretrain_forward(epochs=args.fwd_epochs, log_every=10**9)

    def on_row(row):
        print(json.dumps({**row, "wall_s": round(time.time() - t0, 1)}), flush=True)

    _, best, _ = seed_search(
        cfg, train_ds, args.members, forward_model=trainer.forward_state.f,
        epochs=args.epochs, eval_every=args.eval_every, heldout=heldout, engine=args.engine,
        keep_snapshot=bool(args.save_best), on_row=on_row)

    out = {"best_param_r2": round(best.r2, 5), "best_epoch": best.epoch,
           "member": best.member, "protocol": "heldout" if args.holdout else "trainset",
           "wall_s": round(time.time() - t0, 1)}
    if args.save_best and best.snapshot is not None:
        if isinstance(best.member, int):
            ckpt.save_final_trio(args.save_best, tree_unstack(best.snapshot)[best.member])
        else:        # the mean won: the predictor is every member together
            save_ensemble_best(args.save_best, best.snapshot)
        # the widths and physical bounds ride with the snapshot, so that
        # export and evaluate rebuild and denormalise as trained
        ckpt.save_model_config(args.save_best, cfg)
        out["saved_to"] = os.path.abspath(args.save_best)
    print(f"kernel launches: {launch_counts()}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
