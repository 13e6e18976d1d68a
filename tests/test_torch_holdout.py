"""The held-out protocol of the port's CLI and seed-ensemble example, on the
CPU, and the evaluate command's guards.

``train --holdout F --holdout-seed N`` trains on the (1 - F) split and
writes ``holdout_eval.json``; ``evaluate --holdout F --holdout-seed N``
scores the same held-out cells with the saved models and reproduces its
held-out row field by field (the port of tests/test_cli_viz.py:171-210).
The port's split for a seed is its own (``torch.randperm``), not the JAX
package's; across packages, tests pass the JAX permutation.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config
from pigan_thz_torch.cli import _holdout_row, _split_holdout
from pigan_thz_torch.cli import main as cli_main
from pigan_thz_torch.config import apply_overrides
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.data.dataset import ThzDataset
from pigan_thz_torch.train.trainer import Trainer
from pigan_thz_tpu import cli as j_cli
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.data import split_dataset as j_split_dataset
from pigan_thz_tpu.data.dataset import build_dataset as j_build_dataset
from pigan_thz_tpu.train.trainer import Trainer as JTrainer
from test_torch_evaluator import carry_over

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B = 128, 32
COMMON = ["--device", "cpu", "--set", f"data.num_samples={N}", "--set",
          f"train.batch_size={B}"]
NARROW = ["--set", "generator.hidden_dims=48,24", "--set", "discriminator.hidden_dims=40,20",
          "--set", "forward_model.hidden_dims=16,32,48,32,16"]


def _cfg():
    return apply_overrides(default_config(), [f"data.num_samples={N}"])


@pytest.fixture(scope="module")
def held_out_run(tmp_path_factory):
    """``train --holdout 0.25 --holdout-seed 4 --plot`` on a tiny trio."""
    runs = tmp_path_factory.mktemp("holdout") / "runs"
    assert cli_main(["train", "--mode", "full", "--epochs", "2", "--forward-epochs", "2",
                     "--fixed-physics", "--workdir", str(runs), "--no-tensorboard",
                     "--holdout", "0.25", "--holdout-seed", "4", "--plot",
                     *COMMON, *NARROW]) == 0
    (run_dir,) = [runs / d for d in os.listdir(runs) if d.startswith("train_full")]
    return runs, run_dir


def test_train_holdout_then_evaluate_scores_the_same_cells(held_out_run, tmp_path, capsys):
    runs, run_dir = held_out_run
    summary = json.loads((run_dir / "holdout_eval.json").read_text())
    assert set(summary) == {"holdout_frac", "holdout_seed", "train", "heldout"}
    assert summary["holdout_frac"] == 0.25 and summary["holdout_seed"] == 4
    capsys.readouterr()
    out = tmp_path / "eval_holdout.json"
    assert cli_main(["evaluate", "--models", str(runs / "saved_models"), "--json", str(out),
                     "--holdout", "0.25", "--holdout-seed", "4", *COMMON]) == 0
    said = capsys.readouterr().out
    results = json.loads(out.read_text())
    comp = results["holdout_comparison"]
    # the same split and the same models: every field of both rows, exactly
    assert comp["heldout"] == summary["heldout"]
    assert comp["train"] == summary["train"]
    assert results["total_samples"] == round(N * 0.25)
    assert "holdout comparison (train split vs held-out split)" in said
    # the main report scores the held-out cells
    assert f"Parameter Prediction R2: {results['pigan_evaluation']['parameter_prediction']['r2']:.4f}" in said


def test_train_plot_writes_the_curves(held_out_run):
    _, run_dir = held_out_run
    pytest.importorskip("matplotlib")
    path = run_dir / "training_curves.png"
    assert path.is_file() and path.stat().st_size > 10_000


def test_another_seed_scores_other_cells(held_out_run, tmp_path):
    runs, run_dir = held_out_run
    summary = json.loads((run_dir / "holdout_eval.json").read_text())
    out = tmp_path / "other.json"
    assert cli_main(["evaluate", "--models", str(runs / "saved_models"), "--json", str(out),
                     "--holdout", "0.25", "--holdout-seed", "5", *COMMON]) == 0
    assert json.loads(out.read_text())["holdout_comparison"]["heldout"] != summary["heldout"]


@pytest.mark.parametrize("frac, seed", [(0.25, 4), (0.2, 9), (0.5, 0)])
def test_split_is_reproduced_and_keeps_the_full_scale(frac, seed):
    cfg = _cfg()
    full = synthetic_dataset(cfg.data, device="cpu")
    train, held = _split_holdout(cfg, None, frac, seed, "cpu")
    again_train, again_held = _split_holdout(cfg, None, frac, seed, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(held, again_held))
    assert all(torch.equal(a, b) for a, b in zip(train, again_train))
    assert held.num_samples == round(N * frac) and train.num_samples == N - held.num_samples
    # the two splits partition the cells, and keep the full set's scales
    rows = torch.cat([train.params, held.params])
    assert torch.equal(rows[torch.argsort(rows[:, 0])], full.params[torch.argsort(
        full.params[:, 0])])
    for k in ("param_lo", "param_hi", "metric_lo", "metric_hi", "frequencies"):
        assert torch.equal(getattr(held, k), getattr(full, k)), k
    other = _split_holdout(cfg, None, frac, seed + 1, "cpu")[1]
    assert not torch.equal(other.params, held.params)


@pytest.fixture(scope="module")
def jax_pair():
    """A JAX trainer after a short run, the port's evaluator on its carried
    weights, and one dataset in both packages."""
    sets = [f"data.num_samples={N}", f"train.batch_size={B}", "train.num_epochs=2",
            "train.fwd_pretrain_epochs=2", "generator.hidden_dims=48,24",
            "discriminator.hidden_dims=40,20", "forward_model.hidden_dims=16,32,48,32,16"]
    from pigan_thz_tpu.config import apply_overrides as j_apply

    tcfg, jcfg = apply_overrides(default_config(), sets), j_apply(j_default_config(), sets)
    raw = synthetic_dataset(tcfg.data, device="cpu")
    jds = j_build_dataset(raw.spectra.numpy(), raw.params.numpy(), raw.metrics.numpy(),
                          jcfg.data)
    tds = ThzDataset(*(torch.from_numpy(np.array(x, np.float32)) for x in jds))
    jtr = JTrainer(jcfg, ds=jds, epochs_per_call=1, megakernel="off")
    jtr.train(mode="full", forward_epochs=2, gan_epochs=2)
    ttr = Trainer(tcfg, ds=tds, device="cpu")
    ttr.init_pigan()
    carry_over(jtr.pigan_state, ttr.pigan_state)
    return jtr, ttr, jds, tds


@pytest.mark.parametrize("frac, seed", [(0.2, 9), (0.25, 4)])
def test_heldout_row_on_the_jax_split(frac, seed, jax_pair):
    """The JAX package's split (its permutation passed to the port) scored by
    both packages: the rows agree to their rounding."""
    jtr, ttr, jds, tds = jax_pair
    j_train, j_held = j_split_dataset(jds, val_frac=frac, key=jax.random.PRNGKey(seed))
    perm = np.array(jax.random.permutation(jax.random.PRNGKey(seed), N))
    n_val = j_held.num_samples
    t_held = tds._replace(**{k: getattr(tds, k)[torch.from_numpy(perm[:n_val])]
                             for k in ("spectra", "params", "params_norm", "metrics",
                                       "metrics_norm")})
    assert np.array_equal(t_held.spectra.numpy(), np.asarray(j_held.spectra))
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0), j_held.spectra.shape))
    want = jtr.evaluator().run_comprehensive_evaluation(j_held, jax.random.PRNGKey(0))
    got = ttr.evaluator().run_comprehensive_evaluation(t_held, noise)
    j_row, t_row = j_cli._holdout_row(want), _holdout_row(got)
    assert set(t_row) == set(j_row)
    for k in j_row:
        # the evaluators agree within 1e-5 relative (tests/test_torch_evaluator.py);
        # rounded to 4 (cycle: 6) places, the rows may differ by one unit more
        unit = 1e-6 if k == "cycle" else 1e-4
        assert abs(t_row[k] - j_row[k]) <= 1.01 * unit + 1e-5 * abs(j_row[k]), k


def test_holdout_row_is_the_jax_function(jax_pair):
    jtr, *_ = jax_pair
    res = jtr.evaluate(jax.random.PRNGKey(1))
    assert _holdout_row(res) == j_cli._holdout_row(res)


def test_pigan_only_rebuilds_the_saved_forward_architecture(tmp_path):
    """``train --mode pigan_only --forward-model`` overlays the
    model_config.json saved beside the artifact: a narrow F loads without
    repeating its widths."""
    fwd = tmp_path / "fwd"
    assert cli_main(["pretrain-forward", "--epochs", "1", "--out", str(fwd), "--workdir",
                     str(tmp_path), "--no-tensorboard", *COMMON, *NARROW]) == 0
    out = tmp_path / "gan"
    assert cli_main(["train", "--mode", "pigan_only", "--epochs", "1", "--forward-model",
                     str(fwd / "forward_model_pretrained"), "--out", str(out), "--workdir",
                     str(tmp_path), "--no-tensorboard", *COMMON]) == 0
    a = torch.load(fwd / "forward_model_pretrained.pth", weights_only=True)
    b = torch.load(out / "forward_model_final.pth", weights_only=True)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert b["model.0.weight"].shape == (16, 4)          # the saved narrow F, not 256 wide
    saved = json.loads((out / "model_config.json").read_text())
    assert saved["forward_model"]["hidden_dims"] == [16, 32, 48, 32, 16]


def test_evaluate_without_a_card_does_not_fall_back(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli_main(["evaluate", "--models", str(tmp_path), "--set", f"data.num_samples={N}"])


def test_evaluate_use_ema_needs_the_artifact(held_out_run):
    runs, _ = held_out_run
    with pytest.raises(SystemExit, match="generator_ema"):
        cli_main(["evaluate", "--models", str(runs / "saved_models"), "--use-ema", *COMMON])


def test_seed_ensemble_example_holdout_on_the_cpu():
    cmd = [sys.executable, os.path.join("examples", "torch_seed_ensemble.py"), "--device",
           "cpu", "--members", "2", "--epochs", "2", "--fwd-epochs", "2", "--holdout",
           "--set", f"data.num_samples={N}", "--set", f"train.batch_size={B}"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    n_val = round(N * 0.2)
    assert out["train_cells"] == N - n_val and out["heldout_cells"] == n_val
    assert out["steps_per_epoch"] == (N - n_val) // B
    assert len(out["heldout_member_r2"]) == 2
    assert out["heldout_member_r2"] != out["member_r2"]
    assert out["heldout_ensemble_mean_r2"] == out["heldout_ensemble_mean_r2"]


@pytest.mark.parametrize("command", ["train", "evaluate"])
def test_plot_without_matplotlib_stops_before_any_work(command, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)       # import fails
    args = ["--models", str(tmp_path)] if command == "evaluate" else []
    with pytest.raises(SystemExit, match="--plot needs matplotlib"):
        cli_main([command, "--plot", "--workdir", str(tmp_path), *args, *COMMON])
    assert not any(tmp_path.iterdir())
