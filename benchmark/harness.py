"""What every run of every cell shares: the manifest and the files it names,
the device checks, the forbidden-module check and the result line.

The harness is driven by data.  A cell of ``BENCHMARK.json`` names a
configuration and a traffic mix; the harness finds:

- the configuration at the ``file`` its ``configs`` entry names
  (``benchmark/configs/<config>.json``);
- the traffic mix at ``benchmark/traffic/<traffic>.json``, whose ``driver``
  names the general generator that runs it (``benchmark/drivers/<driver>.py``);
- the limits of the numbers its check compares at
  ``benchmark/limits/<cell>.json``;
- each metric's reader at ``benchmark/metrics/<metric>.py``, a function
  ``read(run) -> float | None`` (None: nothing to read, the metric is left
  out of the line).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pigan_thz_tpu")


def cache_environment(root: Path = ROOT) -> None:
    """Point every build and kernel cache at fixed directories inside the
    checkout.  The kernel library builds under ``build/kernels/`` by itself;
    these are for the Triton, extension and compiler caches that a later
    version of the program may use, since this file cannot change then."""
    cache = root / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell(workload: str, root: Path = ROOT) -> dict:
    """{"manifest", "workload", "config", "traffic", "limits"} of a cell."""
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: one of {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{workload}.json")
    return {"manifest": manifest, "workload": w, "config": config, "traffic": traffic,
            "limits": limits}


def metrics_of(manifest: dict, workload: str, kind: str) -> list:
    """The ``kind`` ("end_to_end" / "per_layer") metrics a cell reports."""
    return [m for m in manifest[kind] if workload in m.get("workloads", [workload])]


def driver(traffic: dict):
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}").Driver


def reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that a run must not load, compared
    whole (``pigan_thz_torch`` begins with ``pigan_thz_t`` too)."""
    tops = {name.partition(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat)."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rpartition(")")[2].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def read_metrics(metrics: list, run: dict) -> dict:
    """{name: {"value", "unit"}} of the metrics whose readers found something."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _number(v):
    return v if v == v and abs(v) != float("inf") else repr(v)


def result(correct: bool, rows: list, record: dict, metrics: dict, device: dict,
           trace: dict | None) -> dict:
    """The result line: ``attempted`` is the window's requests or optimiser
    steps, ``failed`` the compared numbers over their limits; ``checks``, the
    numbers beside their limits, comes last."""
    out = {"correct": correct, "attempted": record.get("requests", record.get("steps", 0)),
           "failed": sum(1 for _, v, lim in rows if lim is None or not v <= lim),
           "metrics": metrics, "device": device}
    if trace is not None:
        device.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        from benchmark import tracing

        out["breakdown"] = tracing.breakdown(trace)
    out["checks"] = {name: {"value": _number(v), "limit": lim} for name, v, lim in rows}
    return out
