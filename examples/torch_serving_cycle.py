"""The serving cycle of pigan_thz_torch (``serve.make_inverse_design_fn``:
K6, then K5, and a few small PyTorch kernels) timed at small batches, on
the card.

Two clocks, since at B = 1 the host's work per call sets the pace: the
CUDA-event median of one call (the card waits for the host between the
call's launches, and that wait counts), and the host's wall time per call
over a run of back-to-back calls with one synchronisation at the end.
``--root`` imports the package from another checkout (an unpacked ``git
archive`` of a parent commit, say), so two versions can be timed in turns
within one call: run it for parent, change, change, parent.  Prints the
card's name and power limit and one JSON line.

    python examples/torch_serving_cycle.py
    python examples/torch_serving_cycle.py --root build/parent --batches 1 64
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(HERE),
                    help="checkout whose pigan_thz_torch is timed (default: this one)")
    ap.add_argument("--batches", type=int, nargs="*", default=[1, 64])
    ap.add_argument("--reps", type=int, default=200)
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch

    import pigan_thz_torch
    if not os.path.abspath(pigan_thz_torch.__file__).startswith(root + os.sep):
        print(f"torch_serving_cycle: FAIL: imported {pigan_thz_torch.__file__}, "
              f"not the package under {root}", file=sys.stderr)
        return 1
    from pigan_thz_torch import default_config
    from pigan_thz_torch.data import build_dataset, generate_dataset, synthesize_spectra
    from pigan_thz_torch.data import sample_params
    from pigan_thz_torch.serve import make_inverse_design_fn

    sys.path.insert(1, HERE)
    from torch_serving_tiles import card_line, median_ms, models

    if not torch.cuda.is_available():
        print("torch_serving_cycle: FAIL: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    cfg = default_config()
    G, F = models(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    raw = generate_dataset(gen, 64, cfg.data, device=dev)
    ds = build_dataset(raw.spectra, raw.params, raw.metrics, cfg.data, device=dev)
    fn = make_inverse_design_fn(G, F, ds)
    result = {"root": root, "cycle": {}}
    for b in a.batches:
        p = sample_params(gen, b, cfg.data, device=dev)
        s = synthesize_spectra(cfg.data.frequencies, p, gen, cfg.data.noise_level)
        event_ms = median_ms(lambda: fn(s), a.reps, warmup=20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(a.reps):
            fn(s)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / a.reps
        result["cycle"][str(b)] = {"event_median_ms": event_ms, "host_wall_ms": wall_ms}
        print(f"B={b}: CUDA-event median {event_ms:.4f} ms, host wall {wall_ms:.4f} ms a call "
              f"({a.reps} calls)", flush=True)
    print(f"card: {card}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
