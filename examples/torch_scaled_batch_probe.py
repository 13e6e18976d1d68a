"""Scaled-batch throughput and quality through the port (pigan_thz_torch):
the counterpart of examples/scaled_batch_probe.py, with its modes, arms and
JSON lines.

--throughput  steps/s, samples/s, TFLOP/s and MFU (``ops/costs.py``: the
              reference shapes' FLOPs over the card's fp32 peak) for batch
              in {64 ... 1024} x {kernel (K2), eager}, spe fixed at 15 (the
              dataset scales with the batch: "more data per step", not
              "fewer steps per epoch").  The GAN-training kernel takes any
              batch; a launch that fails at some batch is a row with its
              error, not a skipped row.

--quality     the recipe on the 1000-sample dataset: each arm B:lr_scale[:w]
              [:N] (w = the warmup_cosine schedule on both optimisers, N the
              dataset size) at the SAME total sample budget as the batch-64
              baseline (--budget-epochs x 15 steps x 64), with gradients
              through F (detach_forward=False) and the pretrained F shared by
              the arms of one dataset; param R² from the evaluator.

    python examples/torch_scaled_batch_probe.py --throughput
    python examples/torch_scaled_batch_probe.py --quality --matrix 64:1,512:2:w
    python examples/torch_scaled_batch_probe.py --device cpu --throughput \
        --batches 8,16 --spe 2 --chunk 1 --chain 1 --meas 1

Prints one JSON line per mode.  The default device is cuda, with no
fallback to the CPU; on the CPU the "kernel" engine is K2's plain version.
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from pigan_thz_torch import apply_overrides, default_config
from pigan_thz_torch.ops._cuda_build import launch_counts
from pigan_thz_torch.ops.costs import device_peak_flops, pigan_step_costs
from pigan_thz_torch.ops.gan_train import make_gan_epoch_fn, supports_gan_kernel
from pigan_thz_torch.train.state import init_pigan_state, make_optimizers
from pigan_thz_torch.train.steps import StepSettings, make_multi_epoch_fn, make_pigan_step
from pigan_thz_torch.train.trainer import Trainer


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def throughput(args, base_cfg, device, peak) -> dict:
    rows = []
    for B in [int(b) for b in args.batches.split(",")]:
        cfg = base_cfg.replace(data=dc.replace(base_cfg.data, num_samples=B * args.spe),
                               train=dc.replace(base_cfg.train, batch_size=B))
        engine = "auto" if device.type == "cuda" else "kernel"
        trainer = Trainer(cfg, device=device, engine=engine, shadow_parity="off")
        trainer.pretrain_forward(epochs=3, log_every=10**9)
        ds = trainer.ds
        settings = StepSettings.from_config(cfg)
        costs = pigan_step_costs(cfg, settings)
        g_tx, d_tx, _ = make_optimizers(cfg, args.spe)
        for backend in ("kernel", "eager"):
            state = init_pigan_state(trainer.generator, trainer.discriminator,
                                     trainer.forward_state.f, g_tx, d_tx, 1, device=device)
            if backend == "kernel":
                reason = supports_gan_kernel(cfg, settings)
                if reason is not None:
                    rows.append({"batch": B, "backend": backend, "error": reason})
                    continue
                me, chunk, chain = make_gan_epoch_fn(cfg, settings), args.chunk, args.chain
            else:
                me = make_multi_epoch_fn(make_pigan_step(g_tx, d_tx, settings, ds.param_lo,
                                                         ds.param_hi), B)
                chunk, chain = args.eager_chunk, 1
            ones = torch.ones(chunk)
            try:
                for _ in range(2):
                    state, m = me(state, ds, ones)
                finite = all(math.isfinite(float(x)) for v in m.values() for x in v)
            except Exception as exc:   # a launch that fails is a row, not a skip
                rows.append({"batch": B, "backend": backend,
                             "error": f"{type(exc).__name__}: {exc}"[:300]})
                continue
            if not finite:
                rows.append({"batch": B, "backend": backend,
                             "error": "non-finite warmup metrics"})
                continue
            rates = []
            for _ in range(args.meas):
                _sync(device)
                t0 = time.perf_counter()
                for _ in range(chain):
                    state, m = me(state, ds, ones)
                float(m["d_loss"][-1])
                _sync(device)
                rates.append(chain * chunk * args.spe / (time.perf_counter() - t0))
            best = max(rates)
            tflops = costs.model_flops * best / 1e12
            row = {"batch": B, "backend": backend, "steps_per_sec": round(best, 1),
                   "samples_per_sec": round(best * B, 1), "flops_per_step": costs.model_flops,
                   "kernel_flops_per_step": costs.padded_flops,
                   "tflops_per_sec": round(tflops, 4)}
            if peak:
                row["mfu_pct"] = round(100.0 * tflops * 1e12 / peak, 3)
            rows.append(row)
            print(f"[throughput] {row}", file=sys.stderr, flush=True)
    return {"mode": "throughput", "spe": args.spe, "rows": rows}


def quality(args, base_cfg, device) -> dict:
    base_samples = args.budget_epochs * (1000 // 64) * 64
    arms_spec = []
    for item in args.matrix.split(","):
        parts = item.strip().split(":")
        arms_spec.append((int(parts[0]), float(parts[1]), len(parts) > 2 and parts[2] == "w",
                          int(parts[3]) if len(parts) > 3 else base_cfg.data.num_samples))
    engine = "auto" if device.type == "cuda" else "kernel"
    trainers: dict = {}

    def base_for(n_samples: int) -> Trainer:
        # one pretrained surrogate a dataset (the 500-epoch recipe)
        if n_samples not in trainers:
            c = base_cfg.replace(data=dc.replace(base_cfg.data, num_samples=n_samples))
            t0 = time.perf_counter()
            b = Trainer(c, device=device, engine=engine)
            b.pretrain_forward(epochs=args.fwd_epochs, log_every=10**9)
            print(f"[quality] F pretrain N={n_samples}: {time.perf_counter() - t0:.1f}s",
                  file=sys.stderr, flush=True)
            trainers[n_samples] = b
        return trainers[n_samples]

    out = {"mode": "quality", "sample_budget": base_samples, "arms": {}}
    best_r2, best_arm = -1e9, None
    for B, s, warm, N in arms_spec:
        base = base_for(N)
        spe_scaled = max(1, N // B)
        epochs_scaled = max(1, base_samples // (spe_scaled * B))
        cfg = base_cfg.replace(
            data=dc.replace(base_cfg.data, num_samples=N),
            train=dc.replace(base_cfg.train, batch_size=B, num_epochs=epochs_scaled))
        t = Trainer(cfg, ds=base.ds, device=device, engine=engine,
                    epochs_per_call=min(1000, epochs_scaled))
        t.forward_state = base.forward_state.clone()
        t.init_pigan()
        _sync(device)
        t0 = time.perf_counter()
        # the quality recipe: gradients through the frozen F, on every arm
        settings = StepSettings.from_config(cfg, detach_forward=False)
        override = dict(
            lr_g=base_cfg.train.lr_g * s, lr_d=base_cfg.train.lr_d * s,
            schedule_g="warmup_cosine" if warm else "cosine",
            schedule_d="warmup_cosine" if warm else "step",
        ) if (s != 1.0 or warm) else {}
        t.train_pigan(epochs=epochs_scaled, log_every=10**9, settings=settings, **override)
        _sync(device)
        wall = round(time.perf_counter() - t0, 1)
        ev = t.evaluate()
        r2 = float(ev["pigan_evaluation"]["parameter_prediction"]["r2"])
        cyc = float(ev["model_validation"]["cycle_consistency_error_mean"])
        name = f"B{B}x{s:g}{'w' if warm else ''}" + (f"N{N}" if N != 1000 else "")
        arm = {"batch": B, "lr_scale": round(s, 3), "warmup": warm, "dataset": N,
               "epochs": epochs_scaled, "r2": round(r2, 4), "cycle": round(cyc, 4),
               "wall_s": wall}
        out["arms"][name] = arm
        if r2 > best_r2:
            best_r2, best_arm = r2, name
        print(f"[quality] {name} {arm}", file=sys.stderr, flush=True)
    out["best_r2"] = round(best_r2, 4)
    out["best_arm"] = best_arm
    out["ok"] = bool(best_r2 >= args.done_bar)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--throughput", action="store_true")
    ap.add_argument("--quality", action="store_true")
    ap.add_argument("--batches", default="64,128,256,512,1024")
    ap.add_argument("--spe", type=int, default=15)
    ap.add_argument("--chunk", type=int, default=100, help="epochs a kernel launch")
    ap.add_argument("--chain", type=int, default=10, help="launches a measurement")
    ap.add_argument("--eager-chunk", type=int, default=2,
                    help="epochs a measurement of the eager step")
    ap.add_argument("--meas", type=int, default=3)
    ap.add_argument("--budget-epochs", type=int, default=3000,
                    help="batch-64-equivalent epoch budget for --quality")
    ap.add_argument("--fwd-epochs", type=int, default=None,
                    help="F pretraining epochs for --quality (default the config's 500)")
    ap.add_argument("--matrix", default="128:2:w,256:2:w,256:4:w,512:2.83:w,512:4:w",
                    help="quality arms as B:lr_scale[:w][:N]")
    ap.add_argument("--done-bar", type=float, default=0.979,
                    help="--quality exits 1 when the best arm's param R2 is below")
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
        kind = torch.cuda.get_device_name(device)
    else:
        kind = "cpu"
    base_cfg = apply_overrides(default_config(), args.set)
    if args.throughput:
        out = throughput(args, base_cfg, device, device_peak_flops(kind))
        print(f"kernel launches: {launch_counts()}", file=sys.stderr)
        print(json.dumps({**out, "device": kind}))
        return 0
    if args.quality:
        out = quality(args, base_cfg, device)
        print(f"kernel launches: {launch_counts()}", file=sys.stderr)
        print(json.dumps({**out, "device": kind}))
        return 0 if out["ok"] else 1
    print("pass --throughput or --quality", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
