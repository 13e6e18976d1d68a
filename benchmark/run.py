"""Run one cell of the benchmark of ``pigan_thz_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for.  The run makes its inputs and weights from ``--seed``, sets the program
up and warms it (``setup_s``: from the process's start), measures for
``--seconds``, then checks what the timed path produced against the plain
reference (``correct``).  With ``--trace 0`` it reports the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a traced
part of the window.  The numbers the check compared go to the last lines
of standard error, each beside its limit, and under ``checks`` as the last
key of the result, which is the last line of standard output.

Without a CUDA card (or with fewer than the cell asks for) the run exits 2
and prints no result; with ``jax``, ``jaxlib``, ``flax``, ``optax`` or
``pigan_thz_tpu`` loaded after set-up or after the window it exits 3.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def tracing_merge(record: dict):
    from benchmark import tracing

    return tracing.merge(record.get("segments", []))


def _exit_if_forbidden(when: str) -> None:
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded {when}: {', '.join(found)}", file=sys.stderr)
        raise SystemExit(3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.cache_environment()
    c = harness.cell(args.workload)
    import torch

    marks = [("torch imported", harness.process_age_s())]
    need = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {need} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2

    from benchmark.reference import compare
    from benchmark.reference.models import fp32_only

    torch.cuda.init()
    marks.append(("CUDA context", harness.process_age_s()))
    drv = harness.driver(c["traffic"])(c["config"], c["traffic"], args.seed, "cuda")
    drv.setup()
    torch.cuda.synchronize()
    setup_s = harness.process_age_s()
    marks.append(("the cell's set-up", setup_s))
    print("set-up: " + ", ".join(f"{name} at {t:.2f} s" for name, t in marks), file=sys.stderr)
    _exit_if_forbidden("after set-up")

    record = drv.window(args.seconds, bool(args.trace))
    torch.cuda.synchronize()
    memory_peak = torch.cuda.max_memory_allocated()
    _exit_if_forbidden("after the window")

    drv.release()
    gc.collect()
    torch.cuda.empty_cache()
    fp32_only()
    numbers = drv.check()
    correct, rows = compare.verdict(numbers, c["limits"])

    trace = tracing_merge(record) if args.trace else None
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": need,
              "memory_peak_bytes": int(memory_peak), "power_limit_w": harness.power_limit_w()}
    run = {"cfg": c["config"], "traffic": c["traffic"], "record": record, "trace": trace,
           "setup_s": setup_s, "device": device}
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = harness.read_metrics(harness.metrics_of(c["manifest"], args.workload, kind), run)
    result = harness.result(correct, rows, record, metrics, device, trace)
    sys.stdout.flush()
    for name, v, lim in rows:
        print(f"check {name}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
