"""The enhanced model variants on the card: eager steps/s and quality
(pigan_thz_torch; the torch twin of examples/enhanced_variants_probe.py).

No TPU kernel covers the enhanced variants, so the eager step is their
training path here, as XLA is the JAX package's.  This probe measures:

- ``--speed``: eager PI-GAN steps/s of each variant swapped alone into the
  baseline trio (the baseline trio's eager step too), at the reference
  workload (1000 samples, B = 64, 15 steps an epoch), beside the baseline
  trio's epoch through the GAN-training kernel (K2) timed in the same call;
- ``--quality --epochs 500``: per trio, forward pretraining for ``epochs``
  (K1 for the baseline F, the eager step for an enhanced one), then
  ``epochs`` GAN epochs with gradients through F (K2 for the baseline trio,
  the eager step otherwise: the Trainer's engine rule), then the evaluator's
  param R² and forward spectrum R².

    python examples/torch_enhanced_variants_probe.py --speed
    python examples/torch_enhanced_variants_probe.py --quality --epochs 500
    python examples/torch_enhanced_variants_probe.py --speed --device cpu \\
        --set data.num_samples=128 --chunk 1 --chain 1    # a check on the CPU

One JSON line a trio, then ``RESULT {...}``.  Times are host wall clock
around synchronised chunks; the card's name and power limit lead the
output.
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
from pigan_thz_torch.models import build_trio
from pigan_thz_torch.ops._cuda_build import launch_counts
from pigan_thz_torch.ops.gan_train import make_gan_epoch_fn
from pigan_thz_torch.train.state import init_pigan_state, make_optimizers
from pigan_thz_torch.train.steps import StepSettings, make_multi_epoch_fn, make_pigan_step
from pigan_thz_torch.train.trainer import Trainer

# (label, generator, discriminator, forward model): the JAX probe's trios
TRIOS = [
    ("baseline_mlp", "mlp", "mlp", "mlp"),
    ("conv_attn_G", "conv_attn", "mlp", "mlp"),
    ("residual_G", "residual", "mlp", "mlp"),
    ("dual_encoder_D", "mlp", "dual_encoder", "mlp"),
    ("conv_D", "mlp", "conv", "mlp"),
    ("multi_scale_D", "mlp", "multi_scale", "mlp"),
    ("branched_F", "mlp", "mlp", "branched"),
    ("physics_F", "mlp", "mlp", "physics"),
    ("uncertainty_F", "mlp", "mlp", "uncertainty"),
]


def cfg_for(base, g: str, d: str, f: str, epochs: int):
    return base.replace(
        generator=dataclasses.replace(base.generator, name=g),
        discriminator=dataclasses.replace(base.discriminator, name=d),
        forward_model=dataclasses.replace(base.forward_model, name=f),
        train=dataclasses.replace(base.train, num_epochs=epochs),
    )


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rate(fn, state, ds, chunk: int, chain: int, n_meas: int, spe: int, device):
    """Best and median steps/s over ``n_meas`` chains of ``chain`` chunks of
    ``chunk`` epochs, after two warm chunks."""
    ones = torch.ones(chunk)
    for _ in range(2):
        state, m = fn(state, ds, ones)
    _sync(device)
    rates = []
    for _ in range(n_meas):
        t0 = time.perf_counter()
        for _ in range(chain):
            state, m = fn(state, ds, ones)
        _sync(device)
        rates.append(chain * chunk * spe / (time.perf_counter() - t0))
    finite = all(bool(torch.isfinite(v).all()) for v in m.values()) and state.is_finite()
    rates.sort()
    return rates[-1], rates[len(rates) // 2], finite


def run_speed(base, ds, labels, chunk, chain, n_meas, epochs, device):
    spe = ds.num_samples // base.train.batch_size
    rows = []
    for label, g_n, d_n, f_n in labels:
        cfg = cfg_for(base, g_n, d_n, f_n, epochs)
        g, d, f = build_trio(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        g_tx, d_tx, _ = make_optimizers(cfg, spe)
        settings = StepSettings.from_config(cfg)
        engines = {"eager": make_multi_epoch_fn(
            make_pigan_step(g_tx, d_tx, settings, ds.param_lo, ds.param_hi),
            cfg.train.batch_size)}
        if label == "baseline_mlp" and device.type == "cuda":
            engines["kernel_k2"] = make_gan_epoch_fn(cfg, settings)
        row = {"trio": label}
        for engine, fn in engines.items():
            state = init_pigan_state(g, d, f, g_tx, d_tx, 0, device=device)
            best, median, finite = _rate(fn, state, ds, chunk, chain, n_meas, spe, device)
            row[f"{engine}_steps_per_s"] = round(best, 1)
            row[f"{engine}_median_steps_per_s"] = round(median, 1)
            row[f"{engine}_ms_per_epoch"] = round(1e3 * spe / best, 3)
            row[f"{engine}_finite"] = finite
        row["params"] = sum(p.numel() for m in (g, d, f) for p in m.parameters())
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def run_quality(base, ds, labels, epochs, device):
    rows = []
    for label, g_n, d_n, f_n in labels:
        cfg = cfg_for(base, g_n, d_n, f_n, epochs)
        t0 = time.perf_counter()
        before = launch_counts()
        tr = Trainer(cfg, ds=ds, device=device, epochs_per_call=25, shadow_parity="off")
        tr.pretrain_forward(epochs=epochs, log_every=10**9)
        tr.init_pigan()
        tr.train_pigan(epochs=epochs, log_every=10**9,
                       settings=StepSettings.from_config(cfg, detach_forward=False))
        res = tr.evaluate()
        after = launch_counts()
        rows.append({
            "trio": label, "epochs": epochs,
            "param_r2": round(float(res["pigan_evaluation"]["parameter_prediction"]["r2"]), 4),
            "fwd_spec_r2": round(float(
                res["forward_network_evaluation"]["spectrum_prediction"]["r2"]), 4),
            "wall_s": round(time.perf_counter() - t0, 1),
            "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]},
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--speed", action="store_true")
    ap.add_argument("--quality", action="store_true")
    ap.add_argument("--trios", type=str, default="", help="comma-separated labels")
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--chunk", type=int, default=5, help="epochs a timed call")
    ap.add_argument("--chain", type=int, default=4, help="calls a measurement")
    ap.add_argument("--n-meas", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    args = ap.parse_args()

    device = torch.device(args.device)
    base = apply_overrides(default_config(), args.set)
    ds = synthetic_dataset(base.data, device=device)
    labels = TRIOS
    if args.trios:
        wanted = set(args.trios.split(","))
        labels = [t for t in TRIOS if t[0] in wanted]
    print(json.dumps({"card": card(), "device": str(device), "torch": torch.__version__}),
          flush=True)
    out = {}
    if args.speed:
        out["speed"] = run_speed(base, ds, labels, args.chunk, args.chain, args.n_meas,
                                 args.epochs, device)
    if args.quality:
        out["quality"] = run_quality(base, ds, labels, args.epochs, device)
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
