"""How far a float32 GAN step may lie from a float64 one, and why
(pigan_thz_torch, on the card).

The GAN-training kernel's first step is held against the plain version in
float64 (``chip_smoke.py``).  On most seeds the kernel is as close to float64
as the float32 plain version is; on some it is tens of times further.  This
script says where that distance comes from.  For each of ``--members`` seeds
it takes one step through the kernel from a fresh state (F pretrained for
``--fwd-epochs``), reads the kernel's own intermediates from its scratch
buffer, and prints three distances of the seed of G's backward, dz3 =
dL/d(G's output) x tanh', in relative L2:

- ``kernel_vs_f64``: the kernel against float64 autograd from the float64
  forward: what a state comparison sees;
- ``f64_at_kernel_output_vs_f64``: float64 autograd evaluated at the kernel's
  float32 G output against the same at the float64 G output: how steep the
  gradient is in G's output (F's LeakyReLUs make it piecewise, and a
  pre-activation within rounding of zero puts the two evaluations on
  different pieces);
- ``kernel_vs_f64_at_kernel_output``: the kernel's backward arithmetic alone.

    python examples/torch_gan_step_conditioning.py --members 6
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from pigan_thz_torch import default_config
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.models import build_trio
from pigan_thz_torch.ops import gan_train as gt
from pigan_thz_torch.ops.forward_train import resolve_draws
from pigan_thz_torch.train.schedules import cosine_schedule, step_schedule
from pigan_thz_torch.train.state import init_pigan_state, make_optimizers
from pigan_thz_torch.train.steps import StepSettings
from pigan_thz_torch.train.trainer import Trainer


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a.double() - b) / torch.linalg.norm(b))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--members", type=int, default=6)
    ap.add_argument("--fwd-epochs", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this script reads the CUDA kernel's scratch", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())

    cfg = default_config()
    ds = synthetic_dataset(cfg.data, device=dev)
    trainer = Trainer(cfg, ds=ds, device=dev)
    trainer.pretrain_forward(epochs=args.fwd_epochs, log_every=10**9)
    f = trainer.forward_state.f
    f64 = copy.deepcopy(f).double().eval()
    batch, s_dim = cfg.train.batch_size, cfg.data.spectrum_dim
    spe = ds.num_samples // batch
    settings = StepSettings.from_config(cfg, detach_forward=False)
    spec = gt.gan_train_spec(cfg, settings)
    gtx, dtx, _ = make_optimizers(cfg, spe)
    g, d, _ = build_trio(cfg, device="cpu")

    def leaky(x):
        return torch.where(x >= 0, x, 0.2 * x)

    for seed in range(args.members):
        state = init_pigan_state(g, d, f, gtx, dtx, seed, device=dev)
        idx = resolve_draws(torch.Generator().manual_seed(seed), ds.num_samples, batch, 1)[0]
        streams = gt.build_streams(
            ds, idx[:, :1], torch.ones(1), 0, 0, 0, 1,
            cosine_schedule(cfg.train.lr_g, cfg.train.num_epochs, spe, 0.01),
            step_schedule(cfg.train.lr_d, cfg.train.num_epochs, spe, 0.5, 0.25))
        spectra, met = streams.spectra[0].double(), streams.metrics_norm[0].double()
        g64 = copy.deepcopy(state.g).double().train()
        with torch.no_grad():
            out64 = g64(spectra)                          # G's output in float64
        exact = gt.to_double(gt.state_buffers(state.clone()))
        gt.gan_train_plain(exact, gt.to_double(streams), spec)    # leaves the updated D
        work = torch.empty(gt.workspace_floats(spec, batch), device=dev)
        gt.gan_train(gt.state_buffers(state), streams, spec, work=work)
        torch.cuda.synchronize()
        views = gt.workspace_views(work, spec, batch)
        out32 = views["tn"].view(batch, 4).double()
        dz3 = views["dpn"].view(batch, 4)

        dw1, db1, dw2, db2, dw3, db3 = spec.d_views(exact.d)
        lo, hi = streams.param_lo.to(dev).double(), streams.param_hi.to(dev).double()

        def g_loss(pn):
            phys = (pn + 1) * 0.5 * (hi - lo) + lo
            z = leaky(leaky(torch.cat([spectra, phys], 1) @ dw1.T + db1) @ dw2.T + db2) @ dw3.T
            recon, pmet = f64(pn)
            d2 = recon[:, 2:] - 2 * recon[:, 1:-1] + recon[:, :-2]
            th1 = 0.4 * pn[:, 0] + 0.6 * pn[:, 2]
            th2 = 0.3 * pn[:, 1] + 0.7 * pn[:, 3]
            lc = ((pmet[:, 0] - th1) ** 2).mean() + ((pmet[:, 1] - th2) ** 2).mean()
            rng = (torch.relu(spec.range_lo - pn) ** 2 + torch.relu(pn - spec.range_hi) ** 2)
            return (spec.adv_w * torch.nn.functional.softplus(-(z + db3)).mean()
                    + spec.recon_w * ((recon - spectra) ** 2).mean()
                    + spec.pmet_w * ((pmet - met) ** 2).mean()
                    + spec.maxwell_w * (d2 ** 2).mean() + spec.lc_w * lc
                    + spec.range_w * rng.mean())

        def seed_at(out):
            leaf = out.clone().requires_grad_(True)
            grad, = torch.autograd.grad(g_loss(leaf), leaf)
            return grad * (1 - out ** 2)

        at64, at32 = seed_at(out64), seed_at(out32)
        print(json.dumps({
            "seed": seed, "g_output_rel_err": rel(out32, out64),
            "kernel_vs_f64": rel(dz3, at64),
            "f64_at_kernel_output_vs_f64": rel(at32, at64),
            "kernel_vs_f64_at_kernel_output": rel(dz3, at32)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
