"""Serving-cycle throughput and latency of pigan_thz_torch across the dtype
ladder, on the card: the port of ``examples/serving_bench.py``.

The paths (``serve.make_inverse_design_fn``): fp32 through the fused kernels
(K6, then K5; the default), fp32 through the modules' eval forward (cuBLAS;
``use_pallas=False``), bf16 (the models' bf16 twins) and int8 (the
post-training-quantized cycle, ``torch._int_mm``).

- Throughput at B = 8192 and 65536: a stream of ``--stream`` distinct
  batches staged on the card beforehand, each path called on every batch
  back to back with one synchronisation at the end; the best of
  ``--repeats`` such streams, as ms a batch and spectra/s.  Beside it each
  path's distance from the fp32 kernel path on the first batch (params as a
  fraction of the range, spectrum in dB).
- Latency at B = 1, 4, 16, 64, 256, 1024 and 4096: ``--requests`` requests
  one after another, each timed on the host clock from the call to its
  synchronisation (what an in-process caller waits), cycling over 16
  distinct staged inputs; the median and p99.

Weights are seeded (flax's initialisation, G's BatchNorm stats perturbed):
the times do not depend on the values.  Prints the card's name and power
limit and one JSON line; fails without a CUDA device.

    python examples/torch_serving_bench.py
    python examples/torch_serving_bench.py --batches 8192 --latency 1 64 --requests 1000
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

THROUGHPUT_BATCHES = (8192, 65536)
LATENCY_BATCHES = (1, 4, 16, 64, 256, 1024, 4096)
PATHS = {"fp32_kernels": {}, "fp32_modules": {"use_pallas": False},
         "bf16": {"compute_dtype": torch.bfloat16}, "int8": {"compute_dtype": "int8"}}


def stream_seconds(fn, batches, repeats: int) -> float:
    """Best host seconds to push every batch through ``fn`` with one sync."""
    fn(batches[0])
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for x in batches:
            fn(x)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def latencies_ms(fn, inputs, requests: int) -> np.ndarray:
    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    out = np.empty(requests)
    for i in range(requests):
        x = inputs[i % len(inputs)]
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        out[i] = (time.perf_counter() - t0) * 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="*", default=list(THROUGHPUT_BATCHES))
    ap.add_argument("--latency", type=int, nargs="*", default=list(LATENCY_BATCHES))
    ap.add_argument("--stream", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--requests", type=int, default=1000)
    ap.add_argument("--paths", nargs="*", default=list(PATHS), choices=list(PATHS))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serving_bench: FAIL: needs a CUDA device", file=sys.stderr)
        return 1
    from pigan_thz_torch import default_config
    from pigan_thz_torch.data import build_dataset, generate_dataset
    from pigan_thz_torch.serve import make_inverse_design_fn

    sys.path.insert(1, HERE)
    from torch_serving_tiles import card_line, models

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    cfg = default_config()
    G, F = models(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    raw = generate_dataset(gen, 64, cfg.data, device=dev)
    ds = build_dataset(raw.spectra, raw.params, raw.metrics, cfg.data, device=dev)
    fns = {name: make_inverse_design_fn(G, F, ds, **kw) for name, kw in PATHS.items()
           if name in a.paths}
    span = (ds.param_hi - ds.param_lo)[None, :]
    result = {"card": card, "device": torch.cuda.get_device_name(0), "throughput": {},
              "latency": {}}
    for b in a.batches:
        batches = [torch.rand((b, cfg.data.spectrum_dim), generator=gen, device=dev) * -20.0
                   for _ in range(a.stream)]
        ref = fns["fp32_kernels"](batches[0]) if "fp32_kernels" in fns else None
        row = {}
        for name, fn in fns.items():
            sec = stream_seconds(fn, batches, a.repeats)
            ms = sec / a.stream * 1e3
            row[name] = {"ms_a_batch": ms, "spectra_per_s": b / (ms / 1e3)}
            if ref is not None:
                out = fn(batches[0])
                row[name]["params_err_of_range"] = float(((out[0] - ref[0]).abs() / span).max())
                row[name]["spectrum_max_abs_err"] = float((out[1] - ref[1]).abs().max())
            print(f"B={b} {name}: {ms:.4f} ms a batch, {b / ms * 1e3 / 1e6:.3f} M spectra/s"
                  + (f", params {row[name]['params_err_of_range']:.2e} of the range and "
                     f"spectrum {row[name]['spectrum_max_abs_err']:.2e} from fp32 kernels"
                     if ref is not None else ""), flush=True)
        result["throughput"][str(b)] = row
        del batches
    for b in a.latency:
        inputs = [torch.rand((b, cfg.data.spectrum_dim), generator=gen, device=dev) * -20.0
                  for _ in range(16)]
        row = {}
        for name, fn in fns.items():
            t = latencies_ms(fn, inputs, a.requests)
            row[name] = {"median_ms": float(np.median(t)), "p99_ms": float(np.percentile(t, 99)),
                         "requests": a.requests}
            print(f"latency B={b} {name}: median {row[name]['median_ms']:.4f} ms, p99 "
                  f"{row[name]['p99_ms']:.4f} ms over {a.requests} requests", flush=True)
        result["latency"][str(b)] = row
    print(f"card: {card}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
