"""Physics-loss λ-ablation sweep through the port (pigan_thz_torch): the
counterpart of examples/ablation_sweep.py (BASELINE config #3).

Pretrains one forward surrogate F through the Trainer (the forward-training
kernel on the card), then trains N PI-GAN members against it, each with its
own (maxwell, lc, range) loss weights from an 8-point grid and gradients
through the frozen F, on the same batches (``parallel/ensemble.py``: the
runtime-weights step, eager), scores every member (``evaluate_ensemble``)
and prints the ranking by param R² as one JSON line.

    python examples/torch_ablation_sweep.py --members 8 --epochs 100
    python examples/torch_ablation_sweep.py --members 8 --epochs 20 --world 2 \\
        --backend gloo                    # two ranks on one card, 4 members each
    python examples/torch_ablation_sweep.py --device cpu --members 2 --epochs 2 \\
        --forward-epochs 2 --set data.num_samples=128

With ``--world W`` the command spawns W ranks on this host (rank r on
``cuda:r mod <devices>``, or the CPU under ``--device cpu``): rank 0
pretrains F and broadcasts it, the members are split over the ranks
(``shard_ensemble``: W dividing N, else every rank trains all N) and
gathered back for the ranking, which is then the one-rank run's bit for
bit.  Ranks that share a CUDA device need ``--backend gloo``.  The default
device is cuda, and there is no fallback to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from pigan_thz_torch import apply_overrides, default_config  # noqa: E402
from pigan_thz_torch.data import synthetic_dataset  # noqa: E402
from pigan_thz_torch.ops._cuda_build import launch_counts  # noqa: E402
from pigan_thz_torch.parallel import (  # noqa: E402
    EnsembleSettings,
    evaluate_ensemble,
    gather_ensemble,
    init_ensemble_states,
    initialize_distributed,
    make_ensemble_multi_epoch_fn,
    make_ensemble_pigan_step,
    make_mesh,
    member_generator,
    shard_ensemble,
    weight_vector,
)
from pigan_thz_torch.parallel.mesh import spawn_ranks  # noqa: E402
from pigan_thz_torch.train.trainer import Trainer  # noqa: E402

# the (maxwell, lc, range) grid of examples/ablation_sweep.py
GRID = [(0.0, 0.0, 0.0), (1.0, 1.0, 0.1), (5.0, 1.0, 0.1), (1.0, 5.0, 0.1),
        (10.0, 10.0, 0.1), (1.0, 1.0, 1.0), (0.1, 0.1, 0.01), (2.0, 2.0, 0.5)]


def sweep(rank: int, world: int, address: str | None, args: argparse.Namespace) -> None:
    """One rank's share of the sweep (world 1: the whole of it); rank 0
    prints the result."""
    mesh = None
    device = torch.device(args.device)
    if world > 1:
        if device.type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
        initialize_distributed(address, world, rank, backend=args.backend, device=device)
        mesh = make_mesh(data=world)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = apply_overrides(default_config(), args.set)
    ds = synthetic_dataset(cfg.data, device=device)

    # one shared pretrained surrogate: rank 0 trains it, the others take it
    trainer = Trainer(cfg, ds=ds, device=device)
    trainer.pretrain_forward(epochs=args.forward_epochs if rank == 0 else 0,
                             log_every=10**9)
    f_state = trainer.forward_state
    if mesh is not None:
        mesh.broadcast_(f_state.params)

    grid = GRID[:args.members]
    weights = torch.stack([weight_vector(maxwell=m, lc=lc, range_=r) for m, lc, r in grid])
    states = init_ensemble_states(
        trainer.generator, trainer.discriminator, f_state.f, trainer.g_tx, trainer.d_tx,
        [member_generator(1, m) for m in range(len(grid))], device=device)
    if mesh is not None:
        states = shard_ensemble(states, mesh)
    step = make_ensemble_pigan_step(trainer.g_tx, trainer.d_tx,
                                    EnsembleSettings(detach_forward=False),
                                    ds.param_lo, ds.param_hi)
    multi_epoch = make_ensemble_multi_epoch_fn(step, cfg.train.batch_size)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if mesh is not None:
        mesh.barrier()
    t0 = time.perf_counter()
    states, rows = multi_epoch(states, ds, torch.Generator().manual_seed(1000), weights,
                               args.epochs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if mesh is not None:
        mesh.barrier()          # the slowest rank's wall
    wall = time.perf_counter() - t0

    local = len(states)
    states = gather_ensemble(states)
    ev = {k: v.tolist() for k, v in evaluate_ensemble(states, ds).items()}
    launches = launch_counts()
    if mesh is not None:
        import torch.distributed as dist

        every = [None] * world
        dist.all_gather_object(every, launches)
        launches = every
    if rank != 0:
        return
    ranking = sorted(({"member": i, "maxwell": mw, "lc": lw, "range": rw,
                       "param_r2": ev["param_r2"][i], "recon_mse": ev["recon_mse"][i],
                       "violation_rate": ev["violation_rate"][i]}
                      for i, (mw, lw, rw) in enumerate(grid)), key=lambda r: -r["param_r2"])
    spe = max(1, ds.num_samples // cfg.train.batch_size)
    result = {
        "members": len(grid), "epochs": args.epochs, "forward_epochs": args.forward_epochs,
        "world": world, "members_a_rank": local, "device": str(device),
        "launches": launches if mesh is not None else [launches],
        "wall_s": wall, "member_steps_per_s": len(grid) * args.epochs * spe / wall,
        "all_rows_finite": bool(all(bool(torch.isfinite(v).all()) for v in rows.values())),
        "final_g_loss": rows["g_loss"][-1].tolist(),
        "ranking": ranking,
    }
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--members", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--forward-epochs", type=int, default=200)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=1, help="ranks to spawn on this host")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default: nccl for CUDA ranks, gloo on the CPU")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override, e.g. data.num_samples=128")
    args = ap.parse_args()
    if not 1 <= args.members <= len(GRID):
        ap.error(f"--members: 1 to {len(GRID)} (the grid's points)")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: this example trains on the card; --device cpu runs on the "
              "CPU", file=sys.stderr)
        return 1
    if args.world == 1:
        sweep(0, 1, None, args)
    else:
        spawn_ranks(sweep, args.world, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
