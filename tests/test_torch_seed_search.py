"""The seed search (``parallel/ensemble_megakernel.py:seed_search``,
``examples/torch_seed_search.py``) against the JAX package's
``examples/seed_search.py`` program on the CPU.

- The step: K3's settings are the ensemble step's (``EnsembleSettings(
  detach_forward=False)`` with ``weight_vector()``), not
  ``StepSettings.from_config``'s.
- The eager engine (the JAX program's literal counterpart) from JAX's
  members on JAX's shuffles: its first step within STEP_TOL (rtol and atol)
  of ``make_ensemble_multi_epoch_fn``'s in Adam's first moments (the
  gradient) and in the rows of D and of the total G loss; the rows of the
  terms that read G's output alone (LC, range, Maxwell, metrics) within
  G_ROW_RTOL: JAX's BatchNorm variance is float32's one-pass E[x²] - E[x]²,
  which loses digits where the batch mean is large beside the spread (the
  port's from float64 sums), and those terms read G's output directly
  (measured up to 4.2e-5 on the LC term).  Two epochs within
  tests/test_torch_gan_step.py's trajectory tolerances.
- The kernel engine (K3's plain version here) against the eager engine on
  the same draws: one epoch, tests/test_torch_ensemble_kernel.py's
  tolerances for the plain version against the eager step; every member saw
  the same batches.
- The best-tracking rule on planted scores: a tie keeps the earlier, the
  mean wins when it is strictly best.
- ``--save-best``: the mean's snapshot as ``ensemble_best.pt`` is what
  ``export --artifact ensemble`` loads: the exported designer's params
  equal the in-process mean's within SERVE_TOL; a member's as the trio.

Narrow widths (G 48-24, D 40-20, F 16-32-48-32-16), 128 samples, B = 32.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import cli
from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.data.dataset import ThzDataset, denormalize_params
from pigan_thz_torch.interop import load_pigan_state_
from pigan_thz_torch.models import build_trio as t_build_trio
from pigan_thz_torch.parallel import (EnsembleSettings, evaluate_ensemble_mean,
                                      init_ensemble_states, member_generator, weight_vector)
from pigan_thz_torch.parallel.ensemble import member_predictions
from pigan_thz_torch.parallel.ensemble_megakernel import (ENSEMBLE_BEST, SearchBest,
                                                          pick_best, save_ensemble_best,
                                                          search_chunk_fn, search_settings,
                                                          seed_search)
from pigan_thz_torch.serve import load_exported
from pigan_thz_torch.train import checkpoint as ckpt
from pigan_thz_torch.train.state import make_optimizers as t_make_optimizers
from pigan_thz_torch.train.steps import StepSettings
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.data.dataset import build_dataset as j_build_dataset
from pigan_thz_tpu.data.dataset import epoch_indices as j_epoch_indices
from pigan_thz_tpu.models import build_trio as j_build_trio
from pigan_thz_tpu.parallel import ensemble as j_ens
from pigan_thz_tpu.train.state import make_optimizers as j_make_optimizers
from pigan_thz_tpu.train.steps import StepSettings as JSettings

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B, E, M = 128, 32, 2, 3
SPE = N // B
NARROW = dict(g=(48, 24), d=(40, 20), f=(16, 32, 48, 32, 16))
STEP_TOL = 1e-5
G_ROW_RTOL = 1e-4
G_OUTPUT_ROWS = ("lc_loss", "param_range_loss", "maxwell_loss", "recon_metrics_loss")
# tests/test_torch_gan_step.py, 8 steps against the JAX XLA path
ROWS_RTOL, PARAM_ATOL = 2e-3, 8e-4
# tests/test_torch_ensemble_kernel.py: the plain version against the eager step
PLAIN_ROWS_RTOL, PLAIN_PARAM_ATOL = 5e-3, 1.2e-3
SERVE_TOL = 1e-5
GAUGE = ("main.0.bias", "main.3.bias")


def _narrow(cfg, epochs=E):
    return cfg.replace(
        data=dataclasses.replace(cfg.data, num_samples=N),
        train=dataclasses.replace(cfg.train, batch_size=B, num_epochs=epochs),
        generator=dataclasses.replace(cfg.generator, hidden_dims=NARROW["g"]),
        discriminator=dataclasses.replace(cfg.discriminator, hidden_dims=NARROW["d"]),
        forward_model=dataclasses.replace(cfg.forward_model, hidden_dims=NARROW["f"]))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _trees(jst) -> dict:
    ga, da = jst.g_opt[1][0], jst.d_opt[1][0]
    return {"g": {"params": _np(jst.g.params), "batch_stats": _np(jst.g.extra["batch_stats"])},
            "d": {"params": _np(jst.d.params)}, "f": {"params": _np(jst.f.params)},
            "g_mu": _np(ga.mu), "g_nu": _np(ga.nu), "g_count": int(ga.count),
            "d_mu": _np(da.mu), "d_nu": _np(da.nu), "d_count": int(da.count),
            "step": int(jst.step)}


def _payload(st) -> dict:
    return {k: v.detach().clone() for k, v in st.state_dict().items()
            if isinstance(v, torch.Tensor) and v.is_floating_point()}


def _subset(jds, idx):
    return jds._replace(spectra=jds.spectra[idx], params=jds.params[idx],
                        params_norm=jds.params_norm[idx], metrics=jds.metrics[idx],
                        metrics_norm=jds.metrics_norm[idx])


@pytest.fixture(scope="module")
def setup():
    tc, jc = _narrow(t_default_config()), _narrow(j_default_config())
    raw = synthetic_dataset(tc.data, device="cpu")
    jds = j_build_dataset(raw.spectra.numpy(), raw.params.numpy(), raw.metrics.numpy(),
                          jc.data)
    tds = ThzDataset(*(torch.from_numpy(np.array(x, np.float32)) for x in jds))
    g, d, f = j_build_trio(jc)
    jg_tx, jd_tx, _ = j_make_optimizers(jc, SPE)
    fv = f.init({"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(5)},
                jnp.zeros((2, 4)), train=False)
    jstates = j_ens.init_ensemble_states(g, d, f, jg_tx, jd_tx, M, jax.random.PRNGKey(7),
                                         forward_variables=fv)
    # numpy copies: the JAX multi-epoch function donates the states it is given
    return dict(tc=tc, jc=jc, jds=jds, tds=tds, jtrio=(g, d, f), jtx=(jg_tx, jd_tx),
                jstates=jax.tree.map(np.asarray, jstates),
                full=_full_setup(raw))


def _full_setup(raw):
    """The full-width trio's config and F on the same cells: the
    GAN-training kernel takes the baseline widths only."""
    tc = t_default_config()
    tc = tc.replace(data=dataclasses.replace(tc.data, num_samples=N),
                    train=dataclasses.replace(tc.train, batch_size=B, num_epochs=1))
    _, _, f = t_build_trio(tc, device="cpu", generator=torch.Generator().manual_seed(3))
    return tc, f


def _port_members(s, jstates):
    tc = s["tc"]
    g, d, f = t_build_trio(tc, device="cpu", generator=torch.Generator().manual_seed(0))
    gtx, dtx, _ = t_make_optimizers(tc, SPE)
    states = init_ensemble_states(g, d, f, gtx, dtx,
                                  [member_generator(7, m) for m in range(M)], device="cpu")
    for m in range(M):
        load_pigan_state_(states[m], _trees(jax.tree.map(lambda x, m=m: x[m], jstates)))
    return states


def _jax_search(s, jds, key, epochs):
    """The JAX program's chunk: make_ensemble_multi_epoch_fn with
    weight_vector() for every member, EnsembleSettings(detach_forward=False)."""
    g, d, f = s["jtrio"]
    jg_tx, jd_tx = s["jtx"]
    step = j_ens.make_ensemble_pigan_step(g, d, f, jg_tx, jd_tx,
                                          j_ens.EnsembleSettings(detach_forward=False),
                                          s["jds"].param_lo, s["jds"].param_hi)
    weights = jnp.stack([j_ens.weight_vector()] * M)
    jstates = jax.tree.map(jnp.asarray, s["jstates"])
    jout, jrows = j_ens.make_ensemble_multi_epoch_fn(step, B)(jstates, jds, key, weights,
                                                              epochs)
    return jax.tree.map(np.asarray, jout), jrows


def test_search_settings_are_the_ensemble_steps():
    st = search_settings()
    assert st == StepSettings(detach_forward=False)
    static = torch.tensor([st.adv_w, st.recon_w, st.physics_spec_w, st.physics_metrics_w,
                           st.maxwell_w, st.lc_w, st.range_w])
    assert torch.equal(static, weight_vector())
    np.testing.assert_array_equal(weight_vector().numpy(), np.asarray(j_ens.weight_vector()))
    jst = JSettings()
    np.testing.assert_array_equal(static.numpy(), np.asarray(
        [jst.adv_w, jst.recon_w, jst.physics_spec_w, jst.physics_metrics_w, jst.maxwell_w,
         jst.lc_w, jst.range_w], np.float32))
    ens = EnsembleSettings(detach_forward=False)
    assert (st.label_real, st.label_fake, st.range_lo, st.range_hi) == (
        ens.label_real, ens.label_fake, ens.range_lo, ens.range_hi)
    # from_config takes the config's knobs, which may differ from the step's
    cfg = t_default_config()
    cfg = cfg.replace(loss=dataclasses.replace(cfg.loss, window=0.5),
                      train=dataclasses.replace(cfg.train, label_smooth_real=1.0))
    assert StepSettings.from_config(cfg, detach_forward=False) != st


def test_eager_engine_first_step_matches_jax(setup):
    """One step: JAX's program on a dataset that is the first batch, the
    eager engine on the same rows."""
    s = setup
    key = jax.random.PRNGKey(3)
    idx = np.asarray(j_epoch_indices(jax.random.split(key, 1)[0], N, B))[0]
    sub = _subset(s["jds"], idx)
    jout, jrows = _jax_search(s, sub, key, 1)
    tsub = ThzDataset(*(torch.from_numpy(np.array(x, np.float32)) for x in sub))
    states = _port_members(s, s["jstates"])
    chunk = search_chunk_fn(_narrow(t_default_config()), tsub, "eager", M)
    states, rows = chunk(states, torch.arange(B).reshape(1, 1, B), torch.tensor([11]))
    for m in range(M):
        for k in jrows:
            rtol = G_ROW_RTOL if k in G_OUTPUT_ROWS else STEP_TOL
            np.testing.assert_allclose(float(rows[m][k][0]), float(jrows[k][0, m]),
                                       rtol=rtol, atol=STEP_TOL, err_msg=f"{m} {k}")
        want = _payload(_port_members(s, jout)[m])
        got = _payload(states[m])
        for k in ("g_opt.m", "d_opt.m"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=STEP_TOL,
                                       atol=STEP_TOL, err_msg=f"member {m} {k}")


def test_eager_engine_epochs_match_jax(setup):
    s = setup
    key = jax.random.PRNGKey(1)
    idx = np.stack([np.asarray(j_epoch_indices(k, N, B)) for k in jax.random.split(key, E)])
    jout, jrows = _jax_search(s, s["jds"], key, E)
    states = _port_members(s, s["jstates"])
    chunk = search_chunk_fn(s["tc"], s["tds"], "eager", M)
    states, rows = chunk(states, torch.from_numpy(idx).to(torch.int64),
                         torch.arange(E * SPE) + 100)
    for m in range(M):
        for k in jrows:
            atol = 1.0 / (SPE * B) if k in ("d_accuracy", "violation_rate") else 1e-6
            np.testing.assert_allclose(rows[m][k].numpy(), np.asarray(jrows[k])[:, m],
                                       rtol=ROWS_RTOL, atol=atol, err_msg=f"{m} {k}")
        want = _payload(_port_members(s, jout)[m])
        got = _payload(states[m])
        np.testing.assert_allclose(got["d_params"].numpy(), want["d_params"].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=f"member {m} d_params")


def _full_members(tc, f, count):
    g, d, _ = t_build_trio(tc, device="cpu", generator=torch.Generator().manual_seed(0))
    gtx, dtx, _ = t_make_optimizers(tc, SPE)
    return init_ensemble_states(g, d, f, gtx, dtx,
                                [member_generator(7, m) for m in range(count)], device="cpu")


def test_kernel_engine_plain_version_matches_eager(setup):
    """K3's plain version and the eager engine at full width (the kernel's
    widths), one epoch from the same members on the same draws; the
    members start apart and stay apart."""
    s = setup
    tc, f = s["full"]
    indices = torch.randperm(N, generator=torch.Generator().manual_seed(2)).reshape(1, SPE, B)
    seeds = torch.arange(SPE) + 40
    out = {}
    for engine in ("kernel", "eager"):
        states = _full_members(tc, f, 2)
        out[engine] = search_chunk_fn(tc, s["tds"], engine, 2)(states, indices, seeds)
    (ks, kr), (es, er) = out["kernel"], out["eager"]
    for m in range(2):
        for k in er[m]:
            atol = 1.0 / (SPE * B) if k in ("d_accuracy", "violation_rate") else 1e-6
            np.testing.assert_allclose(kr[m][k].numpy(), er[m][k].numpy(),
                                       rtol=PLAIN_ROWS_RTOL, atol=atol, err_msg=f"{m} {k}")
        np.testing.assert_allclose(ks.d_params[m].numpy(), es.d_params[m].numpy(), rtol=0,
                                   atol=PLAIN_PARAM_ATOL, err_msg=f"member {m}")
        assert ks[m].step == SPE and ks[m].g_opt.count == SPE
    assert float(kr[0]["g_loss"][0]) != float(kr[1]["g_loss"][0])


def test_search_engines_agree_end_to_end(setup):
    """seed_search with each engine at full width, 2 members, 1 epoch, one
    evaluation: the same draws from its generator, the rows' keys."""
    s = setup
    tc, f = s["full"]
    got = {}
    for engine in ("kernel", "eager"):
        rows = []
        states, best, evals = seed_search(tc, s["tds"], 2, forward_model=f, epochs=1,
                                          eval_every=1, engine=engine, on_row=rows.append)
        assert rows == evals and len(rows) == 1 and rows[0]["epoch"] == 1
        assert set(rows[0]) == {"epoch", "train_r2", "ensemble_mean_r2"}
        got[engine] = (states, best)
    np.testing.assert_allclose(got["kernel"][0].d_params.numpy(),
                               got["eager"][0].d_params.numpy(), rtol=0,
                               atol=PLAIN_PARAM_ATOL)
    assert got["kernel"][1].epoch == got["eager"][1].epoch == 1


def test_best_tracking_rule():
    # the members before the mean, the first maximum wins a tie
    assert pick_best([0.5, 0.7, 0.7], 0.6) == (0.7, 1)
    assert pick_best([0.5, 0.7], 0.7) == (0.7, 1)
    assert pick_best([0.5, 0.6], 0.9) == (0.9, "ensemble_mean")
    best = SearchBest()
    assert best.offer(0.8, 2, 100, None) and (best.r2, best.member, best.epoch) == (0.8, 2, 100)
    assert not best.offer(0.8, "ensemble_mean", 200, None)     # a tie keeps the earlier
    assert best.epoch == 100 and best.snapshot is None
    assert not best.offer(0.79, 0, 300, None)
    assert best.offer(0.81, "ensemble_mean", 400, None) and best.member == "ensemble_mean"


def test_save_best_mean_exports_as_the_ensemble_artifact(setup, tmp_path):
    """The snapshot of a mean that won, written as ensemble_best.pt beside
    model_config.json, is what export --artifact ensemble loads: the served
    params equal the in-process mean's."""
    s = setup
    tc = _narrow(t_default_config(), epochs=1)
    _, _, f = t_build_trio(tc, device="cpu", generator=torch.Generator().manual_seed(3))
    states, best, _ = seed_search(tc, s["tds"], 2, forward_model=f, epochs=1, eval_every=1,
                                  engine="eager", keep_snapshot=True)
    assert best.snapshot is not None
    models = tmp_path / "models"
    save_ensemble_best(str(models), best.snapshot)
    ckpt.save_model_config(str(models), tc)
    assert (models / ENSEMBLE_BEST).is_file()
    out = tmp_path / "art"
    rc = cli.main(["export", "--artifact", "ensemble", "--ensemble-members", "2",
                   "--models", str(models), "--out", str(out), "--device", "cpu",
                   "--batch-size", "16", "--set", f"data.num_samples={N}"])
    assert rc == 0
    fn = load_exported(str(out / "ensemble_designer.pt2"), device="cpu")
    spectra = s["tds"].spectra[:16]
    served = fn(spectra)
    params = served[0] if isinstance(served, (tuple, list)) else served["params"]
    mean = member_predictions(best.snapshot, spectra).mean(0)
    want = denormalize_params(mean, s["tds"].param_lo, s["tds"].param_hi)
    np.testing.assert_allclose(params.numpy(), want.numpy(), rtol=SERVE_TOL, atol=SERVE_TOL)
    if best.member == "ensemble_mean":
        assert float(evaluate_ensemble_mean(best.snapshot, s["tds"])["param_r2"]) == best.r2


def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_seed_search", os.path.join(REPO, "examples", "torch_seed_search.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("holdout", [False, True])
def test_example_on_the_cpu(holdout, tmp_path, capsys):
    """A tiny --device cpu run: one JSON row an evaluation with the JAX
    script's keys, the best last; --save-best writes the winner's files."""
    args = ["--device", "cpu", "--members", "2", "--epochs", "2", "--fwd-epochs", "1",
            "--eval-every", "1", "--set", f"data.num_samples={N}", "--set",
            f"train.batch_size={B}", "--save-best", str(tmp_path / "best")]
    assert _example().main(args + (["--holdout"] if holdout else [])) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    rows, last = lines[:-1], lines[-1]
    assert [r["epoch"] for r in rows] == [1, 2]
    keys = {"epoch", "train_r2", "ensemble_mean_r2", "wall_s"} | (
        {"heldout_r2"} if holdout else set())
    assert all(set(r) == keys for r in rows)
    assert set(last) == {"best_param_r2", "member", "best_epoch", "protocol", "wall_s",
                         "saved_to"}
    assert last["protocol"] == ("heldout" if holdout else "trainset")
    saved = os.listdir(last["saved_to"])
    assert "model_config.json" in saved
    if last["member"] == "ensemble_mean":
        assert ENSEMBLE_BEST in saved
    else:
        assert "generator_final.pth" in saved
