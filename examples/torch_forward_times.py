"""The forward-training kernel of pigan_thz_torch, K1, timed on the card.

K1's epoch (15 steps, B = 64, a launch a call) in float32 at dropout 0.2 and
with bfloat16 operands; one K1 launch of 5 epochs under ``torch.profiler``
(kernel time, idle share, device time of the batch-row products of
``csrc/brow_gemm.cuh``, of the tiled SGEMM and of the rest); K1's first
float32 step against its plain version run in float64 (rows and Adam's
first moments tensor by tensor, the float32 plain version's distance
beside: the gate of ``chip_smoke.py`` phase 10, measured without failing);
and with ``--pretrain`` the wall time of ``python -m pigan_thz_torch
pretrain-forward --epochs 500`` at the reference workload.  Seeded
full-width F, flax's initialisation, a synthetic 1000-sample dataset.
``--root`` imports the package from another checkout (an unpacked ``git
archive`` of a parent commit, say), so two versions can be timed in turns
within one call: run it for parent, change, change, parent.  Prints the
card's name and power limit and, last, one JSON line.

    python examples/torch_forward_times.py --pretrain
    python examples/torch_forward_times.py --root build/parent --pretrain
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
from chip_smoke import (  # noqa: E402  (the timing and checking helpers)
    card_line, cuda_median_ms, k1_first_step_distances, k1_setup, profile_launch)

PRETRAIN_EPOCHS = 500


def pretrain_wall(root: str) -> dict:
    """``pretrain-forward --epochs 500`` from ``root`` in a subprocess: its
    wall time and the launch counts it printed."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "pigan_thz_torch", "pretrain-forward", "--epochs",
               str(PRETRAIN_EPOCHS), "--workdir", tmp, "--out", os.path.join(tmp, "out"),
               "--no-tensorboard"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"pretrain-forward exited {proc.returncode}: {proc.stderr[-2000:]}")
    counts = [ln.split("kernel launches: ", 1)[1] for ln in proc.stdout.splitlines()
              if "kernel launches: " in ln]
    return {"wall_s": wall, "launches": counts[-1] if counts else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(HERE),
                    help="checkout whose pigan_thz_torch is timed (default: this one)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--pretrain", action="store_true",
                    help=f"also time pretrain-forward --epochs {PRETRAIN_EPOCHS}")
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch

    # chip_smoke's import loaded this checkout's package: load root's instead
    for name in [m for m in sys.modules if m.split(".")[0] == "pigan_thz_torch"]:
        del sys.modules[name]
    import pigan_thz_torch
    if not os.path.abspath(pigan_thz_torch.__file__).startswith(root + os.sep):
        print(f"torch_forward_times: FAIL: imported {pigan_thz_torch.__file__}, "
              f"not the package under {root}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("torch_forward_times: FAIL: needs a CUDA device", file=sys.stderr)
        return 1
    from pigan_thz_torch import default_config
    from pigan_thz_torch.data import synthetic_dataset
    from pigan_thz_torch.ops import forward_train as ft
    from pigan_thz_torch.train.steps import ForwardStepSettings

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    cfg = default_config()
    ds = synthetic_dataset(cfg.data, device=dev)
    result = {"root": root, "card": card, "k1_epoch_ms": {}}
    for name, dtype in (("float32", "float32"), ("bf16", "bfloat16")):
        c = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype=dtype))
        spec = ft.forward_train_spec(c, ForwardStepSettings())
        state, _, _, _, streams = k1_setup(c, dev, ds, 1)
        bufs = [state.params, state.opt.m, state.opt.v]
        ms = cuda_median_ms(lambda: ft.forward_train(*bufs, streams, spec), warmup=3,
                            reps=a.reps)
        result["k1_epoch_ms"][name] = ms
        print(f"K1 one epoch, {name}, dropout {c.forward_model.dropout_rate}: {ms:.4f} ms "
              f"(CUDA-event median of {a.reps})", flush=True)

    spec = ft.forward_train_spec(cfg, ForwardStepSettings())
    state, _, _, _, streams = k1_setup(cfg, dev, ds, 5)
    bufs = [state.params, state.opt.m, state.opt.v]
    result["k1_profile"] = profile_launch(
        f"one K1 launch of 5 epochs, dropout {cfg.forward_model.dropout_rate}",
        lambda: ft.forward_train(*bufs, streams, spec), streams.params_norm.shape[0])

    state, _, _, _, streams = k1_setup(cfg, dev, ds, 1)
    d = k1_first_step_distances(spec, (state.params, state.opt.m, state.opt.v), streams)
    e_k, e_p = d["moments"]["kernel"], d["moments"]["plain"]
    worst = max(e_k, key=e_k.get)
    over = max(e_k[k] / max(8.0 * e_p[k], 1e-6) for k in e_k)
    result["k1_first_step"] = {"rows": d["rows"], "worst": worst, "kernel": e_k[worst],
                               "plain": e_p[worst], "of_gate": over,
                               "moments": d["moments"]}
    print(f"K1 first float32 step against float64: rows kernel {d['rows']['kernel']:.3e} "
          f"(float32 plain {d['rows']['plain']:.3e}); first moments, worst {worst} kernel "
          f"{e_k[worst]:.3e} (float32 plain {e_p[worst]:.3e}); the nearest tensor at "
          f"{over:.3f} of its gate (8x the float32 plain version or 1e-6)", flush=True)
    if a.pretrain:
        result["pretrain_forward"] = pretrain_wall(root)
        print(f"pretrain-forward --epochs {PRETRAIN_EPOCHS}: "
              f"{result['pretrain_forward']['wall_s']:.3f} s wall; launches "
              f"{result['pretrain_forward']['launches']}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
