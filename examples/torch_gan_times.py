"""The GAN-training kernels of pigan_thz_torch, K2 and K3, timed on the card.

K2's epoch (15 steps, B = 64, a launch a call) through F, detached, with
bfloat16 operands and with WGAN-GP; K3's epoch through F at M = 1, 2, 4 and
8 members; K1's epoch; and one K2 launch of 5 epochs through F and one
detached under ``torch.profiler``: kernel time, idle share and device time
by kind (the batch-row products of ``csrc/brow_gemm.cuh``, the deep narrow
and batch-depth kernels and the tiled SGEMM of ``csrc/train_common.cuh``,
the rest), calls and us a call.  Seeded full-width G, D and F, flax's
initialisation, on a synthetic 1000-sample dataset.  ``--root`` imports the
package from another checkout (an unpacked ``git archive`` of a parent
commit, say), so two versions can be timed in turns within one call: run
it for parent, change, change, parent.

``--products`` times instead each product that a detached K2 step, a
through-F one and a K1 step launch through ``train_common.cuh``'s dispatch
(``gemm_products``), at M = 1 and 4 members: us a launch of the route its
shape takes and of the tiled SGEMM on the same operands (back to back in a
CUDA graph), the route's result against its plain version and float64,
and the batch-depth kernel bit for bit against the SGEMM.  Prints the
card's name and power limit and, last, one JSON line.

    python examples/torch_gan_times.py
    python examples/torch_gan_times.py --root build/parent
    python examples/torch_gan_times.py --products
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
from chip_smoke import card_line, cuda_median_ms, graph_us  # noqa: E402  (timing helpers)

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


KINDS = (("brow_gemm", "brow_gemm_kernel"), ("deep_narrow", "deep_narrow_gemm<"),
         ("batch_depth", "batch_depth_gemm<"), ("sgemm", "namespace)::sgemm<"))


def profile_k2(ds, dev, knobs: dict) -> dict:
    """One K2 launch of 5 epochs after 2 warm-up launches."""
    import torch
    from pigan_thz_torch.ops import gan_train as gt
    from torch.profiler import ProfilerActivity, profile

    bufs, spec, streams = setup(ds, "float32", knobs, 0, 5, dev)
    for _ in range(2):
        gt.gan_train(bufs, streams, spec)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gt.gan_train(bufs, streams, spec)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = {k: [0.0, 0] for k, _ in KINDS + (("other", ""),)}
    top = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) is None or "cuda" not in str(
                ev.device_type).lower():
            continue
        t = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0)) / 1e3
        kind = next((k for k, mark in KINDS if mark in ev.key), "other")
        kinds[kind][0] += t
        kinds[kind][1] += ev.count
        top.append((t, ev.count, ev.key[:90]))
    busy = sum(v[0] for v in kinds.values())
    steps = streams.spectra.shape[0]
    return {"steps": steps, "wall_ms": wall_ms, "kernel_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "by_kind_ms": {k: v[0] for k, v in kinds.items()},
            "by_kind_calls_a_step": {k: v[1] / steps for k, v in kinds.items()},
            "by_kind_us_a_call": {k: 1e3 * v[0] / v[1] if v[1] else 0.0
                                  for k, v in kinds.items()},
            "top": [list(x) for x in sorted(top, reverse=True)[:8]]}


def step_gemm_products() -> dict:
    """{(m, n, k, ak, bnc, rnd, acc, bias): (name, {path: launches a step})}
    over the dispatch's products of a detached K2 step, a through-F one (D
    updated) and a K1 step, at the published widths."""
    from pigan_thz_torch import default_config
    from pigan_thz_torch.ops import forward_train as ft
    from pigan_thz_torch.ops import gan_train as gt
    from pigan_thz_torch.train.steps import ForwardStepSettings, StepSettings

    cfg = default_config()
    b = cfg.train.batch_size
    lists = {path: gt.gemm_products(gt.gan_train_spec(
        cfg, StepSettings.from_config(cfg, detach_forward=detach)), b)
        for path, detach in (("K2 detached", True), ("K2 through F", False))}
    lists["K1"] = ft.gemm_products(ft.forward_train_spec(cfg, ForwardStepSettings()), b)
    out = {}
    for path, prods in lists.items():
        for p in prods:
            name, a_step = out.setdefault(p[1:], (f"{path}: {p.name}", {}))
            a_step[path] = a_step.get(path, 0) + 1
    return out


def time_products(dev) -> list:
    """Each dispatch product of the steps at M = 1 and 4: us a launch on its
    route and on the tiled SGEMM, its errors, the batch-depth kernel against
    the SGEMM bit for bit."""
    import torch
    from pigan_thz_torch.ops import products as pr

    rows = []
    for key, (name, a_step) in sorted(step_gemm_products().items()):
        p = pr.GemmProduct(name, *key)
        for members in (1, 4):
            a, b, bias, c = pr.step_operands(p, members, seed=sum(key[:3]), device=dev)
            out = torch.zeros((members, p.m, p.n) if members > 1 else (p.m, p.n), device=dev)

            def run(route):
                if c is not None:
                    out.copy_(c)
                return pr.product_gemm(a, b, bias, out=out, acc=p.acc, rnd=p.rnd, route=route)

            got = run(None).clone()
            old = run("sgemm").clone()
            again = run(None).clone()
            plain = pr.product_gemm_plain(a, b, bias, c, p.rnd)
            rd = (lambda t: t.bfloat16().double()) if p.rnd else (lambda t: t.double())
            exact = rd(a) @ rd(b)
            mag = rd(a).abs() @ rd(b).abs()
            if c is not None:
                exact, mag = exact + c.double(), mag + c.double().abs()
            if bias is not None:
                bb = bias.double().unsqueeze(-2) if members > 1 else bias.double()
                exact, mag = exact + bb, mag + bb.abs()
            row = {"name": name, "shape": list(key[:3]), "flags": list(key[3:]),
                   "route": p.route, "members": members, "a_step": a_step,
                   "us": graph_us(lambda: run(None)), "sgemm_us": graph_us(lambda: run("sgemm")),
                   "rerun_equal": bool(torch.equal(got, again)),
                   "equal_to_sgemm": bool(torch.equal(got, old)),
                   "max_rel_vs_plain": float(((got.double() - plain.double()).abs()
                                              / mag.clamp_min(1e-30)).max()),
                   "max_rel_vs_float64": float(((got.double() - exact).abs()
                                                / mag.clamp_min(1e-30)).max())}
            if p.route == "sgemm" and p.k <= pr.DEPTH_MAX_K:    # kept there: the numbers
                row["batch_depth_us"] = graph_us(lambda: run("batch_depth"))
            rows.append(row)
            print(f"product {name} {key[:3]} {p.route}, M = {members}: {row['us']:.2f} us "
                  f"(sgemm {row['sgemm_us']:.2f}, batch depth "
                  f"{row.get('batch_depth_us', float('nan')):.2f}); rerun equal {row['rerun_equal']}, equal to "
                  f"the sgemm {row['equal_to_sgemm']}; |err| / sum|ab| vs plain "
                  f"{row['max_rel_vs_plain']:.2e}, vs float64 {row['max_rel_vs_float64']:.2e}",
                  flush=True)
    for path in ("K2 detached", "K2 through F", "K1"):
        for members in (1, 4):
            sel = [r for r in rows if r["members"] == members and path in r["a_step"]]
            us = sum(r["us"] * r["a_step"][path] for r in sel)
            old = sum(r["sgemm_us"] * r["a_step"][path] for r in sel)
            print(f"{path}, M = {members}: the dispatch's products of a step {us:.2f} us, all "
                  f"on the sgemm {old:.2f} us", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(HERE),
                    help="checkout whose pigan_thz_torch is timed (default: this one)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--products", action="store_true",
                    help="time the dispatch's products of a step alone instead")
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch

    # chip_smoke's import loaded this checkout's package: load root's instead
    for name in [m for m in sys.modules if m.split(".")[0] == "pigan_thz_torch"]:
        del sys.modules[name]
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
    if a.products:
        print(json.dumps({"root": root, "card": card, "products": time_products(dev)}))
        return 0
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
    for name in ("through F", "detached"):
        p = result[f"k2_profile {name}"] = profile_k2(ds, dev, K2_VARIANTS[name][1])
        print(f"K2 launch of {p['steps']} steps {name}: {p['wall_ms']:.3f} ms wall, "
              f"{p['kernel_ms']:.3f} ms of kernel time, idle share {p['idle_share']:.3f}; by "
              f"kind (ms) { {k: round(v, 3) for k, v in p['by_kind_ms'].items()} }, calls a "
              f"step {p['by_kind_calls_a_step']}, us a call "
              f"{ {k: round(v, 2) for k, v in p['by_kind_us_a_call'].items()} }")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
