"""The readings a cell's limits are set from, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \
        [--seconds 2] [--out FILE]

For each of ``--seeds`` seeds: set-up and a short window of the cell (a
training cell's checked epochs are trained in set-up, so it needs no
window), then every number its check reads, compared or not: the
program's readings, whose largest is each limit's lower end.  On the first
``--control-seeds`` of them, the same numbers of stand-ins put in the
program's place: the control (the reference computed with TF32 products,
the precision below the float32 that the configurations state) and each
planted fault the cell can have (training: a step that leaves its state
unchanged, half of each batch left out with the mean over the rest, the
epoch's first step's losses altered by 1 %; design: one answer altered by 1 % of the
parameter range).  The smallest control or fault reading that is at least
three (a state left unchanged) or ten times the lower end is the upper end.
Prints a JSON record and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))

from benchmark import harness, inputs  # noqa: E402


def _altered(readings: dict, key: str) -> dict:
    """``readings`` with the epoch's first step's ``key`` loss 1 % off."""
    steps = readings["losses"][key]
    losses = dict(readings["losses"], **{key: [steps[0] * 1.01] + steps[1:]})
    return dict(readings, losses=losses,
                loss={k: sum(v) / len(v) for k, v in losses.items()})


def _still(readings: dict) -> dict:
    """``readings`` of steps that left the state unchanged."""
    return dict(readings, moment={k: v * 0 for k, v in readings["moment"].items()},
                change={k: v * 0 for k, v in readings["change"].items()})


def stand_ins(drv, kind: str, ref) -> dict:
    """{name: every number} of the control and the planted faults, against
    the reference's readings ``ref`` (training)."""
    if kind in ("train_full", "seed_ensemble"):
        half = drv.reference_readings(batch_cut=drv.cfg["batch_size"] // 2)
        # a fault of the kernel shows in every trio or member it trains
        if kind == "train_full":
            still = [tuple(_still(x) for x in r) for r in ref]
            altered = [(_altered(r[0], "loss"), _altered(_altered(r[1], "d_loss"), "g_loss"))
                       for r in ref]
        else:
            still = [_still(r) for r in ref]
            altered = [_altered(_altered(r, "d_loss"), "g_loss") for r in ref]
        return {"control_tf32": drv.readings(drv.reference_readings("tf32"), ref),
                "fault_state_unchanged": drv.readings(still, ref),
                "fault_half_batch": drv.readings(half, ref),
                "fault_answer_altered": drv.readings(altered, ref)}
    cfg = drv.cfg

    def altered_answer(x):
        params, spec, met = drv.answers_of_reference(x, "fp32")
        params = params.clone()
        params[0, 0] += 0.01 * (cfg["param_max"] - cfg["param_min"])
        return params, spec, met

    return {"control_tf32": drv.check(lambda x: drv.answers_of_reference(x, "tf32")),
            "fault_answer_altered": drv.check(altered_answer)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--base-seed", type=int, default=7_000_000_001)
    ap.add_argument("--extra-seeds", type=int, nargs="*", default=[],
                    help="seeds read besides the derived ones (one that read high before)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    harness.cache_environment()
    c = harness.cell(args.workload)
    import torch

    from benchmark.reference.models import fp32_only

    kind = c["traffic"]["driver"]
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
           "power_limit_w": harness.power_limit_w(), "program": [], "stand_ins": []}
    seeds = [inputs.derive(args.base_seed, "calibrate", i) + 2**31 for i in range(args.seeds)]
    for i, seed in enumerate(seeds + args.extra_seeds):
        drv = harness.driver(c["traffic"])(c["config"], c["traffic"], seed, "cuda")
        t0 = time.perf_counter()
        drv.setup()
        if kind == "design":
            drv.window(args.seconds, False)
        drv.release()
        gc.collect()
        torch.cuda.empty_cache()
        fp32_only()
        ref = drv.reference_readings() if kind != "design" else None
        numbers = drv.readings(drv.got, ref) if ref is not None else drv.check()
        row = {"seed": seed, "numbers": numbers, "s": time.perf_counter() - t0}
        out["program"].append(row)
        print(json.dumps(row), flush=True)
        if i < args.control_seeds:
            s = {"seed": seed, **stand_ins(drv, kind, ref)}
            out["stand_ins"].append(s)
            print(json.dumps(s), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        del drv
        gc.collect()
    lower = {k: max(r["numbers"][k] for r in out["program"]) for k in out["program"][0]["numbers"]}
    out["lower"] = lower
    print(json.dumps({"lower": lower}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
