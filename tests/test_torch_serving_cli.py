"""The port's serving commands on the CPU: ``screen``, ``design`` and
``export`` (``python -m pigan_thz_torch ... --device cpu``), run in this
process through ``cli.main`` on a trio that ``train`` saved at a tiny size,
and every ``SystemExit`` of the JAX package's checks
(pigan_thz_tpu/cli.py:519-745).  What each command writes is held against
the library call it stands for on the same saved weights: the screen's
winners against ``screen_designs``, the designs against ``InverseDesigner``,
each exported artifact against the in-process serving function.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pigan_thz_torch import cli, serve
from pigan_thz_torch.design import InverseDesigner, ScreeningConfig, screen_designs
from pigan_thz_torch.train.trainer import Trainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--set", "data.num_samples=128"]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """A saved trio (2 + 2 epochs) and a 2-member ensemble_best.pt beside it."""
    root = tmp_path_factory.mktemp("serving_cli")
    out = str(root / "saved_models")
    assert cli.main(["train", "--epochs", "2", "--forward-epochs", "2", *SMALL,
                     "--set", "train.batch_size=32", "--workdir", str(root / "runs"),
                     "--out", out, "--no-tensorboard"]) == 0
    proc = subprocess.run(
        [sys.executable, os.path.join("examples", "torch_seed_ensemble.py"), "--device", "cpu",
         "--members", "2", "--epochs", "2", "--fwd-epochs", "2", "--set",
         "data.num_samples=128", "--set", "train.batch_size=32", "--save",
         os.path.join(out, cli.ENSEMBLE_FILE)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return out


def _trainer(models):
    cfg = cli._overlay_model_config_dir(
        cli._make_cfg(cli.build_parser().parse_args(["design", "--models", models, *SMALL])),
        models, ["data.num_samples=128"])
    trainer = Trainer(cfg, device="cpu")
    trainer.load_final(models)
    return trainer


@pytest.mark.parametrize("dtype, pallas", [("float32", True), ("float32", False),
                                           ("bfloat16", False)])
def test_screen_writes_the_top_k(dtype, pallas, models, tmp_path, capsys):
    out = str(tmp_path / "screen.json")
    args = ["screen", "--models", models, *SMALL, "--candidates", "1500", "--chunk-size",
            "512", "--top-k", "6", "--dtype", dtype, "--out", out, *(["--pallas"] * pallas)]
    assert cli.main(args) == 0
    assert "screened 1500 candidates" in capsys.readouterr().out
    with open(out) as fh:
        rows = json.load(fh)
    assert rows["objective"] == "FoM1"
    trainer = _trainer(models)
    f = cli._load_forward_model(trainer.cfg, models, torch.device("cpu"))
    ds = trainer.ds
    want = screen_designs(f, ds.frequencies, ds.param_lo, ds.param_hi,
                          torch.Generator().manual_seed(trainer.cfg.train.seed),
                          ScreeningConfig(num_candidates=1500, chunk_size=512, top_k=6,
                                          use_pallas=pallas, compute_dtype=dtype))
    n = int(want.valid.sum())
    assert [r["rank"] for r in rows["designs"]] == list(range(1, n + 1))
    for r, score, p in zip(rows["designs"], want.scores.tolist(), want.params.tolist()):
        assert r["score"] == score and [r[k] for k in ("r1", "r2", "w", "g")] == p


def test_design_matches_the_designer(models, tmp_path, capsys):
    out = str(tmp_path / "design.json")
    assert cli.main(["design", "--models", models, *SMALL, "--target-index", "0",
                     "--target-index", "3", "--refine-steps", "5", "--uncertainty",
                     "--out", out]) == 0
    printed = capsys.readouterr().out
    with open(out) as fh:
        got = json.load(fh)
    assert got["refine_steps"] == 5 and len(got["designs"]) == 2
    start = printed.index('{\n  "refine_steps"')
    assert json.loads(printed[start: printed.index("\nkernel launches")]) == got
    trainer = _trainer(models)
    st = trainer.pigan_state
    designer = InverseDesigner(st.g, st.f, trainer.ds)
    spectra = trainer.ds.spectra[torch.tensor([0, 3])]
    want = designer.design(spectra, refine_steps=5)
    _, s_std, _, m_std = designer.uncertainty(
        spectra, torch.Generator().manual_seed(trainer.cfg.train.seed),
        params_norm=want.params_norm)
    for i, row in enumerate(got["designs"]):
        assert [row[k] for k in ("r1", "r2", "w", "g")] == want.params[i].tolist()
        assert row["spectrum_mse"] == float(want.spectrum_mse[i])
        assert row["spectrum_std_mean"] == float(s_std[i].mean())
        assert row["metrics_std_mean"] == float(m_std[i].mean())
        assert row["spectrum_std_mean"] > 0


@pytest.mark.parametrize("suffix", [".npy", ".csv"])
def test_design_reads_a_target_file(suffix, models, tmp_path):
    trainer = _trainer(models)
    rows = trainer.ds.spectra[:2].numpy()
    path = str(tmp_path / f"targets{suffix}")
    if suffix == ".npy":
        np.save(path, rows)
    else:
        np.savetxt(path, rows, delimiter=",")
    outs = []
    for args in (["--target-file", path], ["--target-index", "0", "--target-index", "1"]):
        out = str(tmp_path / f"d{len(outs)}.json")
        assert cli.main(["design", "--models", models, *SMALL, *args, "--out", out]) == 0
        with open(out) as fh:
            outs.append(json.load(fh))
    for a, b in zip(*(o["designs"] for o in outs)):
        for k in ("r1", "r2", "w", "g", "spectrum_mse"):
            assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(b[k]))


@pytest.mark.parametrize("dtype, pallas", [("float32", False), ("bfloat16", False),
                                           ("int8", False), ("float32", True)])
def test_export_writes_loadable_artifacts(dtype, pallas, models, tmp_path, capsys):
    out = str(tmp_path / "exported")
    assert cli.main(["export", "--models", models, *SMALL, "--dtype", dtype,
                     "--batch-size", "8", "--out", out, *(["--pallas"] * pallas)]) == 0
    printed = capsys.readouterr().out
    names = ("designer.pt2", "generator.pt2", "surrogate.pt2")
    assert all(f"exported {os.path.join(out, n)}" in printed for n in names)
    trainer = _trainer(models)
    st, ds = trainer.pigan_state, trainer.ds
    x = ds.spectra[:8].contiguous()
    cdt = {"float32": None}.get(dtype, dtype)
    designer = serve.load_exported(os.path.join(out, "designer.pt2"), device="cpu")
    want = serve.make_inverse_design_fn(st.g, st.f, ds, use_pallas=pallas, compute_dtype=cdt)(x)
    for a, b in zip(designer(x), want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    params = serve.load_exported(os.path.join(out, "generator.pt2"), device="cpu")(x)
    if dtype != "bfloat16":        # int8 leaves the generator artifact in fp32
        fp32 = serve.make_inverse_design_fn(st.g, st.f, ds, use_pallas=False)(x)[0]
        torch.testing.assert_close(params, fp32, rtol=0, atol=1e-5)
    spec, met = serve.load_exported(os.path.join(out, "surrogate.pt2"), device="cpu")(
        ds.params_norm[:8].contiguous())
    assert spec.shape == (8, 250) and met.shape == (8, 8)


def test_export_ensemble_artifact(models, tmp_path):
    out = str(tmp_path / "ens")
    assert cli.main(["export", "--models", models, *SMALL, "--artifact", "ensemble",
                     "--ensemble-members", "2", "--batch-size", "8", "--out", out]) == 0
    trainer = _trainer(models)
    gens, f = cli._load_ensemble(trainer.cfg, models, 2, torch.device("cpu"))
    x = trainer.ds.spectra[:8].contiguous()
    got = serve.load_exported(os.path.join(out, "ensemble_designer.pt2"), device="cpu")(x)
    want = serve.make_ensemble_inverse_design_fn(gens, f, trainer.ds)(x)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    assert not torch.equal(*(g.main[0].weight for g in gens))


@pytest.mark.parametrize("argv, match", [
    (["screen", "--pallas", "--dtype", "bfloat16"], "float32 only"),
    (["export", "--pallas", "--dtype", "bfloat16"], "mutually exclusive"),
    (["export", "--pallas", "--dtype", "int8"], "mutually exclusive"),
    (["export", "--artifact", "ensemble"], "needs --ensemble-members"),
    (["export", "--artifact", "ensemble", "--ensemble-members", "0"], "needs --ensemble-members"),
    (["export", "--artifact", "ensemble", "--ensemble-members", "2", "--dtype", "int8"],
     "single-model designer"),
    (["export", "--artifact", "ensemble", "--ensemble-members", "2", "--use-ema"],
     "single-model options"),
    (["export", "--artifact", "ensemble", "--ensemble-members", "2", "--pallas"],
     "single-model options"),
    (["export", "--artifact", "ensemble", "--ensemble-members", "3"], "holds 2 members"),
    (["export", "--use-ema"], "no 'generator_ema'"),
])
def test_serving_commands_exit_on_bad_flags(argv, match, models, tmp_path):
    with pytest.raises(SystemExit, match=match):
        cli.main([argv[0], "--models", models, *SMALL, "--out", str(tmp_path / "x"),
                  *argv[1:]])


def test_ensemble_export_without_the_file_exits(tmp_path):
    with pytest.raises(SystemExit, match="no ensemble_best.pt"):
        cli.main(["export", "--models", str(tmp_path), *SMALL, "--artifact", "ensemble",
                  "--ensemble-members", "2", "--out", str(tmp_path / "x")])


def test_screen_over_a_mesh_is_not_ported(models, monkeypatch):
    """Screening over ranks is ported (``--mesh-data 2 --device cpu`` against
    one rank: tests/test_torch_parallel.py).  What stays refused: fewer CUDA
    devices than ranks, before any work (one device a rank, as the JAX
    package's make_mesh over jax.devices()[:N]), and fewer than one rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
        cli.main(["screen", "--models", models, *SMALL, "--device", "cuda",
                  "--mesh-data", "2"])
    with pytest.raises(SystemExit, match="at least 1"):
        cli.main(["screen", "--models", models, *SMALL, "--mesh-data", "0"])


@pytest.mark.parametrize("command", ["screen", "design", "export"])
def test_serving_commands_need_the_card_by_default(command, models):
    """--device defaults to cuda: without a card the commands stop before
    any work, with no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main([command, "--models", models])
