"""The GAN-training kernels of pigan_thz_torch, K2 and K3, timed on the card.

K2's epoch (15 steps, B = 64, a launch a call) through F, detached, with
bfloat16 operands and with WGAN-GP; K3's epoch through F at M = 1, 2, 4 and
8 members; and one K2 launch of 5 epochs under ``torch.profiler``: its
kernel time, idle share and device time by kernel (the batch-row products
of ``csrc/brow_gemm.cuh``, the tiled SGEMM, the rest).  Seeded full-width
G, D and F, flax's initialisation, on a synthetic 1000-sample dataset.
``--root`` imports the package from another checkout (an unpacked ``git
archive`` of a parent commit, say), so two versions can be timed in turns
within one call: run it for parent, change, change, parent.  Prints the
card's name and power limit and, last, one JSON line.

    python examples/torch_gan_times.py
    python examples/torch_gan_times.py --root build/parent
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
from chip_smoke import card_line, cuda_median_ms  # noqa: E402  (the timing helpers)

K2_VARIANTS = {"through F": ("float32", dict(detach_forward=False)),
               "detached": ("float32", dict(detach_forward=True)),
               "bf16": ("bfloat16", dict(detach_forward=False)),
               "wgan_gp": ("float32", dict(detach_forward=False, gan_loss="wgan_gp"))}
MEMBERS = (1, 2, 4, 8)


def setup(ds, dtype: str, knobs: dict, members: int, epochs: int, dev):
    """``members`` seeded states (seed m each; F shared), their stacked
    buffers (or one state's for members == 0), the kernel's spec and the
    streams of ``epochs`` epochs."""
    import torch
    from pigan_thz_torch import default_config
    from pigan_thz_torch.models import build_trio
    from pigan_thz_torch.ops import forward_train as ft
    from pigan_thz_torch.ops import gan_train as gt
    from pigan_thz_torch.parallel.state_utils import tree_stack
    from pigan_thz_torch.train.schedules import cosine_schedule, step_schedule
    from pigan_thz_torch.train.state import init_pigan_state, make_optimizers
    from pigan_thz_torch.train.steps import StepSettings

    cfg = default_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype=dtype))
    b = cfg.train.batch_size
    spe = ds.num_samples // b
    settings = StepSettings.from_config(cfg, **knobs)
    gtx, dtx, _ = make_optimizers(cfg, spe)
    g, d, f = build_trio(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    states, idx, seeds = [], [], []
    for m in range(max(members, 1)):
        states.append(init_pigan_state(g, d, f, gtx, dtx, m, device=dev))
        drawn = ft.resolve_draws(torch.Generator().manual_seed(m), ds.num_samples, b, epochs)
        idx.append(drawn[0])
        seeds.append(drawn[1])
    stack = members > 0
    streams = gt.build_streams(
        ds, torch.stack(idx) if stack else idx[0], torch.linspace(1.0, 0.5, epochs), 0, 0, 0,
        settings.d_update_every,
        cosine_schedule(cfg.train.lr_g, cfg.train.num_epochs, spe, 0.01),
        step_schedule(cfg.train.lr_d, cfg.train.num_epochs, spe, 0.5, 0.25),
        settings=settings, seeds=torch.stack(seeds) if stack else seeds[0])
    bufs = (gt.ensemble_buffers(tree_stack(states)) if stack
            else gt.state_buffers(states[0]))
    return bufs, gt.gan_train_spec(cfg, settings), streams


def profile_k2(ds, dev) -> dict:
    """One K2 launch of 5 epochs through F after 2 warm-up launches."""
    import torch
    from pigan_thz_torch.ops import gan_train as gt
    from torch.profiler import ProfilerActivity, profile

    bufs, spec, streams = setup(ds, "float32", dict(detach_forward=False), 0, 5, dev)
    for _ in range(2):
        gt.gan_train(bufs, streams, spec)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gt.gan_train(bufs, streams, spec)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = {"brow_gemm": [0.0, 0], "sgemm": [0.0, 0], "other": [0.0, 0]}
    top = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) is None or "cuda" not in str(
                ev.device_type).lower():
            continue
        t = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0)) / 1e3
        kind = ("brow_gemm" if "brow_gemm_kernel" in ev.key else
                "sgemm" if "namespace)::sgemm<" in ev.key else "other")
        kinds[kind][0] += t
        kinds[kind][1] += ev.count
        top.append((t, ev.count, ev.key[:90]))
    busy = sum(v[0] for v in kinds.values())
    steps = streams.spectra.shape[0]
    return {"steps": steps, "wall_ms": wall_ms, "kernel_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "by_kind_ms": {k: v[0] for k, v in kinds.items()},
            "by_kind_calls_a_step": {k: v[1] / steps for k, v in kinds.items()},
            "top": [list(x) for x in sorted(top, reverse=True)[:8]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(HERE),
                    help="checkout whose pigan_thz_torch is timed (default: this one)")
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch

    import pigan_thz_torch
    if not os.path.abspath(pigan_thz_torch.__file__).startswith(root + os.sep):
        print(f"torch_gan_times: FAIL: imported {pigan_thz_torch.__file__}, "
              f"not the package under {root}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("torch_gan_times: FAIL: needs a CUDA device", file=sys.stderr)
        return 1
    from pigan_thz_torch import default_config
    from pigan_thz_torch.data import synthetic_dataset
    from pigan_thz_torch.ops import gan_train as gt

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    ds = synthetic_dataset(default_config().data, device=dev)
    result = {"root": root, "card": card, "k2_epoch_ms": {}, "k3_epoch_ms": {}}
    for name, (dtype, knobs) in K2_VARIANTS.items():
        bufs, spec, streams = setup(ds, dtype, knobs, 0, 1, dev)
        ms = cuda_median_ms(lambda: gt.gan_train(bufs, streams, spec), warmup=3, reps=a.reps)
        result["k2_epoch_ms"][name] = ms
        print(f"K2 one epoch, {name}: {ms:.4f} ms (CUDA-event median of {a.reps})",
              flush=True)
    for members in MEMBERS:
        bufs, spec, streams = setup(ds, "float32", dict(detach_forward=False), members, 1,
                                    dev)
        ms = cuda_median_ms(lambda: gt.gan_ensemble_train(bufs, streams, spec), warmup=3,
                            reps=a.reps)
        result["k3_epoch_ms"][str(members)] = ms
        print(f"K3 one epoch, through F, M = {members}: {ms:.4f} ms", flush=True)
    result["k2_profile"] = profile_k2(ds, dev)
    p = result["k2_profile"]
    print(f"K2 launch of {p['steps']} steps: {p['wall_ms']:.3f} ms wall, {p['kernel_ms']:.3f} "
          f"ms of kernel time, idle share {p['idle_share']:.3f}; by kind (ms) "
          f"{ {k: round(v, 3) for k, v in p['by_kind_ms'].items()} }, calls a step "
          f"{p['by_kind_calls_a_step']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
