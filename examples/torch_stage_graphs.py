"""What a module stage's CUDA graphs (``serve.py:ModuleStage``) cost and
save on the card, for one checkout.

- Capture: a fresh module stage (the residual and conv-attention
  generators, the uncertainty surrogate; fp32, B = 1 and 8192) called six
  times with one input, each call timed on the host clock from the call
  to its synchronisation: where the stage graphs, the first call is eager,
  the second captures and the rest replay; beside them the mean of 20
  eager forwards.
- Rotation: the optimized preset's designer (residual G as a module
  stage, K5 for F) fed requests of 3 and of 6 batch sizes in turn (8192,
  8128, ...), ``--rounds`` rounds: the mean ms a request over every round
  and over the rounds from the third on, and the captures and replays the
  port counts, where it counts them.
- Dtypes: the base designer through the fused kernels (fp32), through its
  modules (``use_pallas=False``) and as its bf16 twins at B = 1, 64, 8192
  and 65536: CUDA-event medians of 50 requests after 10 warm-up.
- Traced launch: the residual G's forward at B = 8192 captured in a graph
  by this script, and the same G as a module stage of the checkout, each
  called ``--traced`` times, host µs from the call to its return
  (synchronised after, outside the timed part), untraced and under
  ``torch.profiler`` (CPU and CUDA activity).

Seeded full-width models, flax's initialisation, on a synthetic dataset.
``--root`` imports the package from another checkout (an unpacked ``git
archive`` of a parent commit), so two versions can be compared in turns
within one call.  Prints the card's name and power limit and, last, one
JSON line.

    python examples/torch_stage_graphs.py
    python examples/torch_stage_graphs.py --root build/parent
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from torch_span_cost import _config, card_line, designer, host_us, traced  # noqa: E402

CAPTURED = (("generator", "residual"), ("generator", "conv_attn"),
            ("forward_model", "uncertainty"))
ROTATIONS = (3, 6)
DTYPE_BATCHES = (1, 64, 8192, 65536)


def synced_ms(fn, x) -> float:
    import torch

    t0 = time.perf_counter()
    fn(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def module(kind: str, name: str):
    import torch
    from pigan_thz_torch.config import ForwardModelConfig, GeneratorConfig
    from pigan_thz_torch.models import build_forward_model, build_generator

    gen = torch.Generator().manual_seed(0)
    if kind == "generator":
        return build_generator(GeneratorConfig(name=name), generator=gen, device="cpu")
    return build_forward_model(ForwardModelConfig(name=name), generator=gen, device="cpu")


def capture_costs(dev) -> dict:
    import torch
    from pigan_thz_torch import serve

    out = {}
    for kind, name in CAPTURED:
        width = 250 if kind == "generator" else 4
        for batch in (1, 8192):
            stage = serve._stage(module(kind, name), dev, "float32", fused=False)
            x = torch.rand((batch, width), generator=torch.Generator().manual_seed(1)).to(dev)
            with torch.inference_mode():
                calls = [synced_ms(stage, x) for _ in range(6)]
                eager = statistics.mean(synced_ms(stage.module, x) for _ in range(20))
            out[f"{name}@{batch}"] = {"calls_ms": calls, "eager_ms": eager}
            print("capture", name, batch, json.dumps(out[f"{name}@{batch}"]), flush=True)
    return out


def rotation(ds, dev, rounds: int, profiling) -> dict:
    import torch

    out = {}
    for n in ROTATIONS:
        fn = designer("optimized", ds, dev)
        xs = [torch.randn((8192 - 64 * i, ds.spectrum_dim),
                          generator=torch.Generator().manual_seed(i)).to(dev) for i in range(n)]
        profiling.reset()
        with profiling.recording():
            times = [[synced_ms(fn, x) for x in xs] for _ in range(rounds)]
        counters = profiling.snapshot()["counters"]
        out[str(n)] = {
            "mean_ms": statistics.mean(t for r in times for t in r),
            "steady_mean_ms": statistics.mean(t for r in times[2:] for t in r),
            "requests": rounds * n,
            "captures": counters.get("serve_graph_captures", 0),
            "replays": counters.get("serve_graph_replays", 0)}
        print("rotation", n, json.dumps(out[str(n)]), flush=True)
    return out


def dtypes(ds, dev) -> dict:
    import torch
    from pigan_thz_torch.models import build_trio
    from pigan_thz_torch.serve import make_inverse_design_fn

    g, _, f = build_trio(_config("base"), device=dev,
                         generator=torch.Generator().manual_seed(0))
    fns = {"fp32_kernels": make_inverse_design_fn(g.eval(), f.eval(), ds),
           "fp32_modules": make_inverse_design_fn(g, f, ds, use_pallas=False),
           "bf16": make_inverse_design_fn(g, f, ds, compute_dtype=torch.bfloat16)}
    out = {}
    for batch in DTYPE_BATCHES:
        x = torch.randn((batch, ds.spectrum_dim), generator=torch.Generator().manual_seed(2)
                        ).to(dev)
        out[str(batch)] = {name: event_median_ms(fn, x) for name, fn in fns.items()}
        print("dtypes", batch, json.dumps(out[str(batch)]), flush=True)
    return out


def event_median_ms(fn, x, warmup: int = 10, reps: int = 50) -> float:
    import torch

    for _ in range(warmup):
        fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def traced_launch(dev, calls: int) -> dict:
    import torch
    from pigan_thz_torch import serve

    g = module("generator", "residual").to(dev).eval().requires_grad_(False)
    x = torch.randn((8192, 250), generator=torch.Generator().manual_seed(3)).to(dev)
    stage = serve._stage(g, dev, "float32", fused=False)
    with torch.inference_mode():
        static = x.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                g(static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            g(static)
        stage(x)
        stage(x)
    out = {}
    for name, fn in (("bare_replay", lambda _: graph.replay()), ("stage", stage)):
        call = torch.inference_mode()(fn)
        host_us(call, x, 20)
        untraced = host_us(call, x, calls)
        on, _ = traced(lambda: host_us(call, x, calls))
        out[name] = {"untraced": untraced, "traced": on,
                     "traced_minus_untraced_us": on["mean_us"] - untraced["mean_us"]}
        print("traced", name, json.dumps(out[name]), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(HERE),
                    help="checkout whose pigan_thz_torch is measured (default: this one)")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--traced", type=int, default=300)
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch

    import pigan_thz_torch
    if not os.path.abspath(pigan_thz_torch.__file__).startswith(root + os.sep):
        print(f"torch_stage_graphs: FAIL: imported {pigan_thz_torch.__file__}, "
              f"not the package under {root}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("torch_stage_graphs: FAIL: needs a CUDA device", file=sys.stderr)
        return 1
    from pigan_thz_torch.data import synthetic_dataset
    from pigan_thz_torch.utils import profiling

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    ds = synthetic_dataset(_config("base").data, device=dev)
    result = {"root": root, "card": card, "capture": capture_costs(dev),
              "rotation": rotation(ds, dev, a.rounds, profiling), "dtypes": dtypes(ds, dev),
              "traced": traced_launch(dev, a.traced)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
