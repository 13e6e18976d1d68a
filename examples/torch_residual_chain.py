"""The residual generator's fused chain kernel (``fused_residual_chain``) on
the card, beside the module stage it replaces above its crossover.

A seeded full-width ``ResidualGenerator`` (250 -> 512, three residual blocks
of 512, 256, 128 -> 4; BatchNorm stats non-trivial, folded at packing).  For
each checked batch the kernel is held against the module's eval forward in
fp32 (TF32 off): the widest gap over the module's RMS within ``TOL`` (the
design cells' ``params_gap`` limit), and beside its 3xTF32 twin; a rerun
must give the same bits and each call be one launch.  Then a sweep over
batches times, with CUDA events and in turns (each in order, then in
reverse; the median of both): the kernel, a call on its own and back to
back (``burst``: its device time), the residual stage's module path as the
designer runs it (a CUDA graph replayed: ``serve.ModuleStage``) likewise,
and the plain version (cuBLAS on the folded chain) a call.  The kernel's
crossover (``fused_kernels.RESIDUAL_CROSSOVER``) comes from this sweep: the
last line's ``crossing`` is the smallest swept batch from which the kernel,
a call, beats the graph at every larger swept batch.
Prints ptxas's report for the kernel, the card's name and power limit, and
one JSON line; exits 1 on any failed check.

    python examples/torch_residual_chain.py            # on the card
    python examples/torch_residual_chain.py --sweep 1024 8192 --reps 20
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from pigan_thz_torch import serve
from pigan_thz_torch.config import GeneratorConfig
from pigan_thz_torch.models import build_generator
from pigan_thz_torch.ops import _cuda_build
from pigan_thz_torch.ops import fused_kernels as fk
from torch_serving_tiles import burst_ms, card_line, median_ms

TOL = 3e-5                      # of the module's RMS: the design cells' params_gap limit
CHECK_BATCHES = (1, 77, 128, 4096, 8192, 8192 + 37, 65536)   # and the crossover's two sides
SWEEP_BATCHES = (64, 128, 256, 512, 1024, 1536, 2048, 2560, 3072, 3584, 4096, 6144, 8192,
                 65536)


def residual_generator(dev):
    gen = torch.Generator().manual_seed(0)
    G = build_generator(GeneratorConfig(name="residual"), device="cpu", generator=gen)
    with torch.no_grad():
        for m in G.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean += 0.1 * torch.randn(m.num_features, generator=gen)
                m.running_var += (0.1 * torch.randn(m.num_features, generator=gen)) ** 2
                m.weight += 0.1 * torch.randn(m.num_features, generator=gen)
                m.bias += 0.1 * torch.randn(m.num_features, generator=gen)
    return G.to(dev).eval().requires_grad_(False)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", type=int, nargs="*", default=list(SWEEP_BATCHES))
    ap.add_argument("--reps", type=int, default=30)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_residual_chain: FAIL: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    lib = _cuda_build.build()
    _cuda_build.load_library()
    log = (lib.parent / "nvcc.log").read_text().splitlines()
    for i, line in enumerate(log):
        if "ptxas" in line and "residual_chain_kernel" in line:
            print("  " + line.strip())
            for nxt in log[i + 1:i + 3]:
                print("    " + nxt.strip())

    G = residual_generator(dev)
    packed = fk.pack_residual(G, dev)
    cross = fk.RESIDUAL_CROSSOVER
    print(f"the residual chain kernel serves from B = {cross}")
    gen = torch.Generator(device=dev).manual_seed(0)
    failures = []
    with torch.inference_mode():
        for b in sorted({*CHECK_BATCHES, cross - 1, cross}):
            x = torch.randn((b, 250), generator=gen, device=dev)
            want = G(x)
            before = fk.LAUNCHES["fused_residual_chain"]
            got = fk.fused_residual_chain(x, packed)
            again = fk.fused_residual_chain(x, packed)
            torch.cuda.synchronize()
            rms = float(want.pow(2).mean().sqrt())
            row = {"batch": b, "gap": float((got - want).abs().max()) / rms,
                   "vs_3xtf32_twin": float((got - fk.fused_residual_chain_tf32(x, packed))
                                           .abs().max()) / rms,
                   "vs_plain": float((got - fk.fused_residual_chain_plain(x, packed))
                                     .abs().max()) / rms,
                   "rerun_equal": bool(torch.equal(got, again)),
                   "launches": fk.LAUNCHES["fused_residual_chain"] - before}
            print(json.dumps(row))
            if not (row["gap"] <= TOL and row["rerun_equal"] and row["launches"] == 2):
                failures.append(f"B={b}: {row}")

        sweep = []
        for b in a.sweep:
            x = torch.randn((b, 250), generator=gen, device=dev)
            stage = serve.ModuleStage(copy.deepcopy(G))
            stage(x)
            stage(x)                                    # captured: later calls replay
            runs = {"kernel": lambda: fk.fused_residual_chain(x, packed),   # noqa: E731
                    "module_graph": lambda: stage(x)}                       # noqa: E731
            times: dict = {}
            for name in [*runs, *reversed(runs)]:       # in turns: A B C C B A
                times.setdefault(name, []).append((median_ms(runs[name], a.reps),
                                                   burst_ms(runs[name], a.reps)))
            row = {"batch": b, "replayed": stage.replayed,
                   "plain_ms": median_ms(lambda: fk.fused_residual_chain_plain(x, packed),
                                         a.reps)}
            for name, v in times.items():
                row[name + "_ms"] = statistics.median(t for t, _ in v)
                row[name + "_burst_ms"] = statistics.median(t for _, t in v)
            sweep.append(row)
            print(json.dumps(row))
    print(f"card: {card}")
    rows = sorted(sweep, key=lambda r: r["batch"])
    wins = [r["kernel_ms"] < r["module_graph_ms"] for r in rows]
    crossing = next((r["batch"] for i, r in enumerate(rows) if all(wins[i:])), None)
    print(json.dumps({"crossover": cross, "crossing": crossing, "failures": failures,
                      "sweep": sweep}))
    if failures:
        print("torch_residual_chain: FAIL:\n" + "\n".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
