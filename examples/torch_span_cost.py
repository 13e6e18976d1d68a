"""What the port's spans and counters cost on the card, off and on.

Off: the host time of the serving callable, from the call to its return
(the device synchronised after each call, outside the timed part), over
``--calls`` requests of the base designer at B = 8192 and at B = 1 and of
the optimized preset's designer at B = 8192; then, in one process, the
callable in turns with its designer's stages called bare (no span site:
the request path without its two flag checks), ``--calls`` each, in ten
rounds, and the median of the rounds' differences.  On: ``--traced`` requests
untraced, then the same under ``torch.profiler`` (CPU and CUDA activity),
and a Trainer's 25-epoch chunks of F pretraining and of PI-GAN training
(the kernels' engine, shadow replay off) untraced, then traced: the wall
time a chunk.  Where the package has spans, the traced parts' span table
and counters are printed too.  Seeded full-width models, flax's
initialisation, on a synthetic 1000-sample dataset.

``--root`` imports the package from another checkout (an unpacked ``git
archive`` of a parent commit, say), so two versions can be timed in turns
within one call: run it for parent, change, change, parent.  Prints the
card's name and power limit and, last, one JSON line.

    python examples/torch_span_cost.py
    python examples/torch_span_cost.py --root build/parent
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

DESIGNS = (("base", 8192), ("base", 1), ("optimized", 8192))


def card_line() -> str:
    """The card's name and power limit (``chip_smoke.py`` imports the
    package, which ``--root`` must import first)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def _config(preset: str):
    from pigan_thz_torch import default_config

    cfg = default_config()
    if preset == "optimized":
        from pigan_thz_torch.config_presets import apply_optimization_config

        cfg = apply_optimization_config(cfg)
    return cfg


def designer(preset: str, ds, dev):
    """The serving callable of a seeded trio of ``preset``."""
    import torch
    from pigan_thz_torch.models import build_trio
    from pigan_thz_torch.serve import make_inverse_design_fn

    g, _, f = build_trio(_config(preset), device=dev,
                         generator=torch.Generator().manual_seed(0))
    return make_inverse_design_fn(g.eval(), f.eval(), ds)


def host_us(fn, x, calls: int) -> dict:
    """Per call, the host µs from the call to its return (synchronised
    after each call, outside the timed part): mean and median."""
    import torch

    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn(x)
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return {"mean_us": sum(times) / calls * 1e6, "median_us": statistics.median(times) * 1e6}


def bare(fn):
    """The designer inside the serving callable ``fn``, its two stages
    called directly under ``inference_mode``: the request without a span
    site."""
    import torch
    from pigan_thz_torch.data.dataset import denormalize_params

    module = next(c.cell_contents for c in fn.__wrapped__.__closure__
                  if isinstance(c.cell_contents, torch.nn.Module))

    @torch.inference_mode()
    def call(spectra):
        pn = module.generator.forward(spectra)
        spec, met = module.surrogate.forward(pn)
        return denormalize_params(pn, module.lo, module.hi), spec, met

    return call


def in_turns(fn, x, calls: int, rounds: int = 10) -> dict:
    """``fn`` and its bare stages in turns, ``calls`` requests each: the
    medians of the rounds' mean host µs and of their differences."""
    other = bare(fn)
    a, b = [], []
    for _ in range(rounds):
        a.append(host_us(fn, x, calls // rounds)["mean_us"])
        b.append(host_us(other, x, calls // rounds)["mean_us"])
    return {"callable_us": statistics.median(a), "bare_us": statistics.median(b),
            "callable_minus_bare_us": statistics.median(p - q for p, q in zip(a, b))}


def traced(work):
    """``work()`` under ``torch.profiler``: its result, the seconds it took
    inside the profiler (its set-up and stop left out)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        t0 = time.perf_counter()
        out = work()
        seconds = time.perf_counter() - t0
    return out, seconds


def spans_of(profiling):
    """The span table and counters recorded so far, or None without spans."""
    if profiling is None:
        return None
    snap = profiling.snapshot()
    profiling.reset()
    return {"spans": snap["spans"], "counters": snap["counters"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(HERE),
                    help="checkout whose pigan_thz_torch is timed (default: this one)")
    ap.add_argument("--calls", type=int, default=10000)
    ap.add_argument("--traced", type=int, default=300)
    ap.add_argument("--chunks", type=int, default=4)
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch

    import pigan_thz_torch
    if not os.path.abspath(pigan_thz_torch.__file__).startswith(root + os.sep):
        print(f"torch_span_cost: FAIL: imported {pigan_thz_torch.__file__}, "
              f"not the package under {root}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("torch_span_cost: FAIL: needs a CUDA device", file=sys.stderr)
        return 1
    from pigan_thz_torch.data import synthetic_dataset
    from pigan_thz_torch.train.trainer import Trainer
    from pigan_thz_torch.utils import profiling

    if not hasattr(profiling, "snapshot"):
        profiling = None
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    ds = synthetic_dataset(_config("base").data, device=dev)
    result = {"root": root, "card": card, "design": {}, "train": {}}

    for preset, batch in DESIGNS:
        fn = designer(preset, ds, dev)
        x = torch.randn((batch, ds.spectrum_dim), generator=torch.Generator().manual_seed(1)
                        ).to(dev)
        host_us(fn, x, 50)                                   # warm-up
        off = host_us(fn, x, a.calls)
        turns = in_turns(fn, x, a.calls)
        untraced = host_us(fn, x, a.traced)
        on, _ = traced(lambda: host_us(fn, x, a.traced))
        result["design"][f"{preset}@{batch}"] = {
            "off": off, "off_in_turns": turns, "untraced": untraced, "traced": on,
            "traced_minus_untraced_us": on["mean_us"] - untraced["mean_us"],
            "spans": spans_of(profiling)}
        print(preset, batch, json.dumps(result["design"][f"{preset}@{batch}"]), flush=True)

    epochs = 25 * a.chunks
    t = Trainer(_config("base"), ds=ds, device=dev, shadow_parity="off")
    t.pretrain_forward(epochs=25)                            # builds and warms the kernels
    t.init_pigan()
    t.train_pigan(epochs=25)
    torch.cuda.synchronize()
    phases = {"forward": lambda: t.pretrain_forward(epochs=epochs),
              "pigan": lambda: t.train_pigan(epochs=epochs)}
    for name, work in phases.items():
        t0 = time.perf_counter()
        work()
        untraced = time.perf_counter() - t0
        _, on = traced(work)
        result["train"][name] = {
            "chunks": a.chunks, "untraced_ms_a_chunk": untraced / a.chunks * 1e3,
            "traced_ms_a_chunk": on / a.chunks * 1e3,
            "traced_minus_untraced_ms_a_chunk": (on - untraced) / a.chunks * 1e3,
            "spans": spans_of(profiling)}
        print(name, json.dumps(result["train"][name]), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
