"""The port's operational commands and the resumable pipeline on the CPU:
``train --checkpoint-dir``, ``examples/torch_full_pipeline.py`` killed and
rerun, ``profile`` (``utils/profiling.py``), ``cache-data``
(``data/native_io.py``) and ``doctor``, each against the JAX package where
it has a counterpart: ``StepTimer``'s arithmetic on a patched clock, the
``.thzb`` cache crossing between the packages with identical arrays, the
native CSV parser's arrays.  Without ``--device cpu`` each new entry point
raises on a machine without a card."""

import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config
from pigan_thz_torch.cli import main as cli_main
from pigan_thz_torch.data import native_io, save_csv, synthetic_dataset
from pigan_thz_torch.data.dataset import load_csv
from pigan_thz_torch.train import checkpoint as ckpt
from pigan_thz_torch.train.trainer import Trainer
from pigan_thz_torch.utils import profiling
from pigan_thz_tpu.config import DataConfig as JDataConfig
from pigan_thz_tpu.data import native_io as j_native_io
from pigan_thz_tpu.data.dataset import build_dataset as j_build_dataset
from pigan_thz_tpu.utils import profiling as j_profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B = 128, 32
SMALL = ["--set", f"data.num_samples={N}", "--set", f"train.batch_size={B}"]


def _env_without_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


# ---------------------------------------------------------------------------
# train --checkpoint-dir
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["full", "forward_only"])
def test_train_checkpoint_dir_writes_checkpoints_that_restore(mode, tmp_path):
    """One step an epoch, two 25-epoch chunks at interval 25: the checkpoints
    of epochs 25 and 50 are kept, and the latest restored into a fresh
    trainer is the saved final model."""
    ck = tmp_path / "ckpt"
    rc = cli_main(["train", "--device", "cpu", "--set", f"data.num_samples={B}", "--set",
                   f"train.batch_size={B}", "--workdir", str(tmp_path), "--no-tensorboard",
                   "--mode", mode, "--epochs", "50", "--forward-epochs", "1", "--set",
                   "train.save_interval=25", "--checkpoint-dir", str(ck)])
    assert rc == 0
    mgr = ckpt.CheckpointManager(str(ck))
    assert mgr.all_epochs() == [25, 50] and mgr.latest_epoch() == 50
    c = default_config()
    cfg = c.replace(data=dataclasses.replace(c.data, num_samples=B),
                    train=dataclasses.replace(c.train, batch_size=B))
    t = Trainer(cfg, device="cpu", engine="eager")
    out = tmp_path / "saved_models"
    if mode == "full":
        assert t.resume_from(mgr, "pigan") == 50
        assert len(t.train_history["pigan/g_loss"]) == 50
        finals = (("generator_final", t.pigan_state.g), ("discriminator_final", t.pigan_state.d),
                  ("forward_model_final", t.pigan_state.f))
    else:
        assert t.resume_from(mgr, "forward") == 50
        finals = (("forward_model_pretrained", t.forward_state.f),)
    for name, module in finals:
        saved = torch.load(out / f"{name}.pth", weights_only=True)
        for k, v in module.state_dict().items():
            assert torch.equal(v, saved[k]), (name, k)


# ---------------------------------------------------------------------------
# The resumable pipeline
# ---------------------------------------------------------------------------


def _pipeline():
    spec = importlib.util.spec_from_file_location(
        "torch_full_pipeline", os.path.join(REPO, "examples", "torch_full_pipeline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Killed(Exception):
    pass


def test_pipeline_killed_and_rerun_equals_the_uninterrupted_run(tmp_path, monkeypatch):
    mod = _pipeline()
    args = ["--device", "cpu", "--fwd-epochs", "4", "--gan-epochs", "4", "--ft-epochs", "2",
            "--chunk", "2", *SMALL]
    assert mod.main(["--workdir", str(tmp_path / "a"), *args]) == 0

    real = mod.save_progress

    def killed_after_the_first_gan_chunk(path, prog):
        real(path, prog)
        if prog["gan_epochs"] == 2:
            raise _Killed()

    monkeypatch.setattr(mod, "save_progress", killed_after_the_first_gan_chunk)
    with pytest.raises(_Killed):
        mod.main(["--workdir", str(tmp_path / "b"), *args])
    assert not (tmp_path / "b" / "DONE").exists()
    monkeypatch.setattr(mod, "save_progress", real)
    assert mod.main(["--workdir", str(tmp_path / "b"), *args]) == 0

    a, b = tmp_path / "a", tmp_path / "b"
    assert (b / "DONE").exists()
    assert json.loads((b / "progress.json").read_text()) == {
        "fwd_epochs": 4, "gan_epochs": 4, "ft_epochs": 2}
    names = sorted(os.listdir(a / "saved_models"))
    assert names == sorted(os.listdir(b / "saved_models"))
    assert "generator_final.pth" in names
    for name in names:
        assert (a / "saved_models" / name).read_bytes() == (
            b / "saved_models" / name).read_bytes(), name
    assert (a / "final_eval.json").read_bytes() == (b / "final_eval.json").read_bytes()


def test_pipeline_refuses_a_workdir_without_its_checkpoint(tmp_path):
    mod = _pipeline()
    (tmp_path / "progress.json").write_text(json.dumps(
        {"fwd_epochs": 2, "gan_epochs": 0, "ft_epochs": 0}))
    with pytest.raises(RuntimeError, match="fwd_epochs=2 but"):
        mod.main(["--workdir", str(tmp_path), "--device", "cpu", *SMALL])


# ---------------------------------------------------------------------------
# profile and utils/profiling.py
# ---------------------------------------------------------------------------


def test_profile_prints_its_report(tmp_path, capsys):
    trace_dir = tmp_path / "trace"
    rc = cli_main(["profile", "--device", "cpu", "--engine", "kernel", *SMALL,
                   "--epochs", "1", "--repeats", "3", "--trace-dir", str(trace_dir)])
    assert rc == 0
    text = capsys.readouterr().out
    report = json.loads(text[: text.rindex("}") + 1])
    assert set(report) == {"trace_dir", "epochs_per_call", "calls_per_sec",
                           "train_steps_per_sec", "device_memory", "launches"}
    assert report["epochs_per_call"] == 1 and report["calls_per_sec"] > 0
    assert report["train_steps_per_sec"] == pytest.approx(
        report["calls_per_sec"] * N // B, rel=1e-2)
    assert report["launches"] == {} and report["device_memory"] == {}   # the CPU
    assert json.loads((trace_dir / profiling.TRACE_FILE).read_text())["traceEvents"]


@pytest.mark.parametrize("warmup", [0, 1, 2, 3])
def test_step_timer_is_the_jax_packages(warmup, monkeypatch):
    ticks = [10.0, 10.5, 11.25, 12.0, 13.5, 13.75]
    rates = []
    for module in (j_profiling, profiling):
        clock = iter(ticks)
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
        timer = module.StepTimer(warmup=warmup)
        for _ in ticks:
            timer.tick()
        rates.append((timer.steps_per_sec(), timer.mean_step_ms()))
        monkeypatch.undo()
    assert rates[0] == rates[1]
    assert rates[1][0] > 0


# ---------------------------------------------------------------------------
# cache-data and data/native_io.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_ds():
    return synthetic_dataset(default_config().data.__class__(num_samples=64), device="cpu")


def test_native_path_taken_where_gpp_exists():
    assert native_io.native_available() == (shutil.which("g++") is not None)
    if native_io.native_available():
        assert native_io.build_error() is None
        assert os.path.dirname(native_io._so_path()) == os.path.join(REPO, "build", "native")


def _j_dataset(ds):
    return j_build_dataset(*(t.numpy() for t in (ds.spectra, ds.params, ds.metrics)),
                           JDataConfig(num_samples=ds.num_samples))


def _same_raw(a, b):
    for name in ("spectra", "params", "metrics"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)))


def test_a_cache_crosses_between_the_packages(small_ds, tmp_path):
    cfg = default_config().data
    torch_file, jax_file = str(tmp_path / "t.thzb"), str(tmp_path / "j.thzb")
    native_io.cache_dataset(small_ds, torch_file)
    j_native_io.cache_dataset(_j_dataset(small_ds), jax_file)
    suffix = "" if native_io.native_available() else ".npy"
    assert open(torch_file + suffix, "rb").read() == open(jax_file + suffix, "rb").read()
    _same_raw(j_native_io.load_cached(torch_file, JDataConfig()), small_ds)
    got = native_io.load_cached(jax_file, cfg, device="cpu")
    _same_raw(got, small_ds)
    for name in ("params_norm", "metrics_norm", "frequencies"):
        assert torch.equal(getattr(got, name), getattr(small_ds, name)), name


def test_load_csv_native_is_the_jax_packages(small_ds, tmp_path):
    path = str(tmp_path / "d.csv")
    save_csv(small_ds, path)
    got = native_io.load_csv_native(path, default_config().data, device="cpu")
    want = j_native_io.load_csv_native(path, JDataConfig())
    _same_raw(got, want)
    np.testing.assert_array_equal(got.frequencies.numpy(), np.asarray(want.frequencies))
    ref = load_csv(path, default_config().data, device="cpu")
    for name in ref._fields:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_cache_data_round_trips(tmp_path, capsys):
    out = tmp_path / "c.thzb"
    assert cli_main(["cache-data", "--device", "cpu", "--set", "data.num_samples=64",
                     "--out", str(out)]) == 0
    assert "cached 64 samples" in capsys.readouterr().out
    assert out.exists() == native_io.native_available()


# ---------------------------------------------------------------------------
# doctor, and the entry points without a card
# ---------------------------------------------------------------------------


def test_doctor_exits_1_without_a_card_and_says_why(tmp_path):
    report = tmp_path / "doctor.json"
    proc = subprocess.run([sys.executable, "-m", "pigan_thz_torch", "doctor", "--json",
                           str(report), "--timeout", "60"], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=_env_without_card())
    assert proc.returncode == 1, proc.stderr[-2000:]
    checks = {c["check"]: c for c in json.loads(report.read_text())}
    assert not checks["CUDA device"]["ok"]
    assert "torch.cuda.is_available() is False" in checks["CUDA device"]["detail"]
    assert not checks["device round trip"]["ok"]
    assert checks["torch"]["ok"] and checks["forward-training kernel"]["ok"]
    assert checks["native IO extension"]["ok"] == native_io.native_available()
    assert "[FAIL] CUDA device" in proc.stdout


def _without_card_argv(name, tmp):
    cli = ["-m", "pigan_thz_torch"]
    return {
        "profile": [*cli, "profile", "--epochs", "1", "--repeats", "2", "--workdir",
                    f"{tmp}/w", *SMALL],
        "cache-data": [*cli, "cache-data", "--out", f"{tmp}/x.thzb", *SMALL],
        "train-checkpoint-dir": [*cli, "train", "--epochs", "1", "--forward-epochs", "1",
                                 "--checkpoint-dir", f"{tmp}/ck", "--workdir", f"{tmp}/w",
                                 *SMALL],
        "full-pipeline": [os.path.join("examples", "torch_full_pipeline.py"), "--workdir",
                          f"{tmp}/pipe", "--fwd-epochs", "1", *SMALL],
    }[name]


@pytest.mark.parametrize("name", ["profile", "cache-data", "train-checkpoint-dir",
                                  "full-pipeline"])
def test_new_entry_points_without_a_card_do_not_fall_back(name, tmp_path):
    proc = subprocess.run([sys.executable, *_without_card_argv(name, tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=_env_without_card())
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert os.listdir(tmp_path) == []
