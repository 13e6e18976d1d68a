"""The serving kernels K5 (``fused_mlp_forward``) and K6
(``fused_dense_chain``) of pigan_thz_torch in every launch shape, on the card.

Seeded full-width F (4->256->512->1024->512->256->258) and G
(250->512->256->4, BatchNorm stats non-trivial, folded) as ``chip_smoke.py``
builds them.  For each checked batch and each cluster size (1 is the
row-tile shape), and for K5 the wgmma shape, the kernel is held against its
plain fp32 version (K5 1e-4, K6 2e-5) and beside its 3xTF32 twin; a rerun
must give the same bits, and every ``mma.sync`` shape the row-tile shape's
bits (the wgmma shape sums in another order).  Then a sweep over batches
times each shape beside the module's eval forward (cuBLAS, fp32) with CUDA
events, in turns (every shape, then every shape again in reverse order; the
median of both runs): a call on its own (its median, the wrapper's host
time included, as chip_smoke.py times it) and back to back (``burst_ms``:
the kernel's device time), which is where ``launch_shape``'s crossovers
come from.  Prints ptxas's report for the kernels, the card's name and power
limit, and one JSON line; exits 1 on any failed check.

    python examples/torch_serving_tiles.py            # on the card
    python examples/torch_serving_tiles.py --sweep 64 8192 --reps 20
    python examples/torch_serving_tiles.py --sweep 4096 8192 --clusters 1 wgmma
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from pigan_thz_torch import default_config
from pigan_thz_torch.models import build_forward_model, build_generator
from pigan_thz_torch.ops import _cuda_build
from pigan_thz_torch.ops import fused_kernels as fk

K5_TOL = 1e-4
K6_TOL = 2e-5
CHECK_BATCHES = (1, 19, 64, 77, 257, 8192, 8192 + 37)   # and each crossover's two sides
SWEEP_BATCHES = (1, 64, 256, 512, 1024, 2048, 3072, 4096, 4224, 4225, 6144, 8192, 65536)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def median_ms(fn, reps: int, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def burst_ms(fn, reps: int, n: int = 20) -> float:
    """A launch's device time: ``n`` launches back to back between two
    events (the host enqueues ahead of the card, so the wrapper's host time
    drops out), the median over ``reps`` such bursts, over ``n``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(max(3, reps // 4)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def models(dev):
    cfg = default_config()
    gen = torch.Generator().manual_seed(0)
    G = build_generator(cfg.generator, cfg.data.spectrum_dim, device=dev, generator=gen)
    with torch.no_grad():
        for m in G.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                for stat in (m.running_mean, m.running_var):
                    stat += (0.1 * torch.randn(m.num_features, generator=gen) ** 2).to(dev)
    F = build_forward_model(cfg.forward_model, cfg.data.spectrum_dim, cfg.data.metrics_dim,
                            device=dev, generator=gen)
    return G.eval(), F.eval()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", type=int, nargs="*", default=list(SWEEP_BATCHES))
    ap.add_argument("--clusters", nargs="*", default=[*map(str, fk.CLUSTER_SIZES), fk.WGMMA],
                    help="cluster sizes and 'wgmma' (K5's wgmma shape)")
    ap.add_argument("--reps", type=int, default=30)
    a = ap.parse_args()
    shapes = [s if s == fk.WGMMA else int(s) for s in a.clusters]
    if not torch.cuda.is_available():
        print("torch_serving_tiles: FAIL: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    lib = _cuda_build.build()
    _cuda_build.load_library()
    log = (lib.parent / "nvcc.log").read_text().splitlines()
    for i, line in enumerate(log):
        if "ptxas" in line and "chain_kernel" in line:
            print("  " + line.strip())
            for nxt in log[i + 1:i + 3]:
                print("    " + nxt.strip())

    G, F = models(dev)
    g_packed, f_packed = fk.pack_generator(G, dev), fk.pack_forward_model(F, dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    failures = []
    kernels = {
        "fused_mlp_forward": (fk.fused_mlp_forward, fk.fused_mlp_forward_plain,
                              fk.fused_mlp_forward_tf32, f_packed, 4, K5_TOL),
        "fused_dense_chain": (fk.fused_dense_chain, fk.fused_dense_chain_plain,
                              fk.fused_dense_chain_tf32, g_packed, 250, K6_TOL),
    }
    crossovers = {fk.crossover_for(p) for p in (f_packed, g_packed)}
    wg_cross = fk.wgmma_crossover(sms)
    print(f"clusters resident at once: K5 {fk.chain_limits(f_packed)[1]}, "
          f"K6 {fk.chain_limits(g_packed)[1]}; the row-tile shape from B = {sorted(crossovers)}, "
          f"K5's wgmma shape from B = {wg_cross}")
    crossovers.add(wg_cross)
    with torch.inference_mode():
        for b in sorted({*CHECK_BATCHES, *(c - 1 for c in crossovers), *crossovers}):
            for name, (kern, plain, twin, packed, din, tol) in kernels.items():
                x = (torch.rand((b, din), generator=gen, device=dev) * 2 - 1 if din == 4
                     else torch.randn((b, din), generator=gen, device=dev))
                want = plain(x, packed)
                tw = twin(x, packed)
                ref = None
                for c in shapes:
                    if c == fk.WGMMA and packed.wgmma is None:
                        continue
                    before = fk.LAUNCHES[name]
                    try:
                        got = kern(x, packed, cluster=c)
                        again = kern(x, packed, cluster=c)
                        torch.cuda.synchronize()
                    except RuntimeError as e:
                        failures.append(f"{name} B={b} cluster={c}: {e}")
                        continue
                    err = float((got - want).abs().max())
                    row = {"kernel": name, "batch": b, "cluster": c, "max_abs_err": err,
                           "vs_3xtf32_twin": float((got - tw).abs().max()),
                           "rerun_equal": bool(torch.equal(got, again)),
                           "launches": fk.LAUNCHES[name] - before}
                    if c != fk.WGMMA:
                        if ref is None:
                            ref = got
                        row["equal_to_first_shape"] = bool(torch.equal(got, ref))
                    print(json.dumps(row))
                    if not (err <= tol and row["rerun_equal"] and row["launches"] == 2
                            and row.get("equal_to_first_shape", True)):
                        failures.append(f"{name} B={b} cluster={c}: {row}")
        # the odd chain through the padding
        g1 = torch.Generator().manual_seed(1)
        layer = (torch.randn(7, 33, generator=g1), *torch.randn(3, 33, generator=g1))
        head = (torch.randn(33, 5, generator=g1), torch.randn(5, generator=g1))
        odd = fk.pack_chain([layer], head, dev)
        xo = torch.randn((19, 7), generator=gen, device=dev)
        want = fk.fused_mlp_forward_plain(xo, odd)
        for c in shapes:
            if c == fk.WGMMA:
                continue          # the wgmma shape does not take this chain
            try:
                err = float((fk.fused_mlp_forward(xo, odd, cluster=c) - want).abs().max())
            except RuntimeError as e:
                failures.append(f"odd chain cluster={c}: {e}")
                continue
            print(f"odd chain 7->33->5 B=19 cluster={c}: max|err| {err:.3e}")
            if not err <= K5_TOL:
                failures.append(f"odd chain cluster={c}: {err}")

        sweep = []
        for b in a.sweep:
            x = torch.rand((b, 4), generator=gen, device=dev) * 2 - 1
            s = torch.randn((b, 250), generator=gen, device=dev)
            row = {"batch": b,
                   "chosen": {"fused_mlp_forward": fk.chosen_shape(x, f_packed),
                              "fused_dense_chain": fk.chosen_shape(s, g_packed)},
                   "library_ms": {"fused_mlp_forward": median_ms(lambda: F(x), a.reps),
                                  "fused_dense_chain": median_ms(lambda: G(s), a.reps)}}
            for name, inp, packed, kern in (
                    ("fused_mlp_forward", x, f_packed, fk.fused_mlp_forward),
                    ("fused_dense_chain", s, g_packed, fk.fused_dense_chain)):
                row[name] = {}
                timed = [c for c in shapes
                         if (c == fk.WGMMA and packed.wgmma is not None)
                         or (c != fk.WGMMA and (c == 1 or -(-b // fk.ROW_TILE) * c <= 8 * sms))]
                runs: dict = {}
                for c in timed + timed[::-1]:       # in turns: A B B A
                    if isinstance(runs.get(str(c)), str):
                        continue
                    try:
                        fn = lambda: kern(inp, packed, cluster=c)   # noqa: E731
                        runs.setdefault(str(c), []).append(
                            (median_ms(fn, a.reps), burst_ms(fn, a.reps)))
                    except RuntimeError as e:
                        runs[str(c)] = f"refused: {e}"
                row[name + ".burst"] = {}
                for c, v in runs.items():
                    if isinstance(v, str):
                        row[name][c] = v
                        continue
                    row[name][c] = statistics.median(t for t, _ in v)
                    row[name + ".burst"][c] = statistics.median(t for _, t in v)
            sweep.append(row)
            print(json.dumps(row))
    print(f"card: {card}")
    print(json.dumps({"sm_count": sms, "failures": failures, "sweep": sweep}))
    if failures:
        print("torch_serving_tiles: FAIL:\n" + "\n".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
