"""The held-out and scaled-batch examples of the port on the CPU, at a tiny
size: ``examples/torch_holdout_eval.py`` (the keys of the JAX package's
``examples/holdout_eval.py``, the ceilings equal to ``evaluate/ceilings.py``'s)
and ``examples/torch_scaled_batch_probe.py`` (both modes' JSON lines, the
FLOPs a step from ``ops/costs.py``; the kernels' plain versions run here).
"""

import importlib.util
import json
import os

import pytest
import torch

from pigan_thz_torch import apply_overrides, default_config
from pigan_thz_torch.evaluate.ceilings import noise_ceilings
from pigan_thz_torch.ops.costs import pigan_step_costs
from pigan_thz_torch.train.steps import StepSettings

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--set", "data.num_samples=128", "--set", "train.batch_size=32"]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("ema", [False, True])
def test_holdout_eval_on_the_cpu(ema, capsys):
    args = ["--device", "cpu", "--gan-epochs", "2", "--fwd-epochs", "2", "--chunk", "1",
            *TINY] + (["--ema-decay", "0.9"] if ema else [])
    assert _example("torch_holdout_eval").main(args) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"ceilings", "train", "heldout", "wall_s"} | (
        {"heldout_ema"} if ema else set())
    for part in ("train", "heldout") + (("heldout_ema",) if ema else ()):
        assert set(out[part]) == {"param_r2", "spectrum_r2", "metrics_r2", "cycle"}
        assert all(v == v for v in out[part].values())
    cfg = apply_overrides(default_config(), TINY[1::2])
    want = {k: round(v, 4) for k, v in noise_ceilings(cfg.data, device="cpu").items()}
    assert out["ceilings"] == want


def test_scaled_batch_throughput_on_the_cpu(capsys):
    args = ["--device", "cpu", "--throughput", "--batches", "8,16", "--spe", "2", "--chunk",
            "1", "--chain", "1", "--meas", "1"]
    assert _example("torch_scaled_batch_probe").main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mode"] == "throughput" and out["device"] == "cpu"
    rows = out["rows"]
    assert [(r["batch"], r["backend"]) for r in rows] == [
        (8, "kernel"), (8, "eager"), (16, "kernel"), (16, "eager")]
    for r in rows:
        cfg = apply_overrides(default_config(), [f"train.batch_size={r['batch']}"])
        costs = pigan_step_costs(cfg, StepSettings.from_config(cfg))
        assert r["flops_per_step"] == costs.model_flops
        assert r["kernel_flops_per_step"] == costs.padded_flops
        assert "mfu_pct" not in r             # no peak for the CPU
        assert r["steps_per_sec"] > 0


def test_scaled_batch_quality_on_the_cpu(capsys):
    args = ["--device", "cpu", "--quality", "--matrix", "32:1,64:2:w", "--budget-epochs", "1",
            "--fwd-epochs", "1", "--done-bar=-1e9", *TINY]
    assert _example("torch_scaled_batch_probe").main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mode"] == "quality" and out["sample_budget"] == 15 * 64
    assert set(out["arms"]) == {"B32x1N128", "B64x2wN128"}
    assert out["arms"]["B64x2wN128"]["epochs"] == 15 * 64 // 128
    assert out["best_arm"] in out["arms"] and out["ok"]
