"""Training the enhanced variants: the port's eager steps against the JAX
XLA steps, resume, the engine rule and ``train --preset optimized`` as
typed, on the CPU.

- The PI-GAN step of the optimized trio (residual G, spectral-norm
  dual-encoder D, the baseline F, all at the published widths) from one
  carried-over JAX state, fed the JAX step's own stability noise and the
  dropout masks of ``tests/jax_masks.py`` (each of the step's model calls
  with its own set, as the JAX step's keys give them: G's D-phase pass, D
  on [real; fake], G's G-phase pass and its stability pass (one set), D on
  the G-phase batch), batch 64: the loss rows within ROWS_RTOL; G's
  BatchNorm stats and D's spectral-norm ``u`` and ``sigma`` within
  STATS_RTOL of their size; both Adams' first moments (after a step, the
  clipped gradients) in relative L2 a tensor, D's within D_MOMENT_RTOL and
  G's within G_MOMENT_RTOL a step; G's and D's parameters within LR_STEPS x lr a
  step (Adam moves an entry by ~lr whatever its gradient's size, so a sign
  flip of a rounding-level gradient moves it by 2 x lr); the gauge leaves
  (the biases that feed BatchNorm, whose true gradient is 0) left out.
  G's gradient is ill-conditioned at this state: the preset's constraint
  and window terms on an untrained F reach ~1e6 (G's gradient is clipped
  from far above the limit), and BatchNorm behind dropout and three
  residual blocks amplifies rounding; scaling the spectra by 1 + 1e-7 moves
  the port's own G moments by up to 1.4 % at batch 16.  Measured JAX to
  port: G's moments 7e-3 (preset), 3.3e-2 (WGAN-GP), D's below 1e-5.  With the preset's settings, with WGAN-GP (the critic pass
  with its own masks, its spectral-norm state discarded), and with D
  updated every 2nd step over two steps (the skip branch stores D's
  ``u`` and ``sigma``).
- The forward step of the uncertainty surrogate with ``nll_w`` > 0, the
  JAX masks carried across: the loss rows, parameters and first moments.
- Kill and resume of an enhanced trio, bit for bit.
- The engine rule on the card's side, and ``train --preset optimized`` as
  typed, then ``evaluate`` and a served request on the saved trio.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_masks import MaskPlan
from pigan_thz_torch import config_presets as tp
from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.cli import main as cli_main
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.data.dataset import ThzDataset
from pigan_thz_torch.interop import (
    forward_state_to_flax,
    load_forward_state_,
    load_pigan_state_,
    pigan_state_to_flax,
)
from pigan_thz_torch.models import build_forward_model as t_build_forward_model
from pigan_thz_torch.models import build_trio as t_build_trio
from pigan_thz_torch.serve import FusedStage, ModuleStage, _designer, make_inverse_design_fn
from pigan_thz_torch.train import checkpoint as ckpt
from pigan_thz_torch.train import steps as tsteps
from pigan_thz_torch.train.state import init_forward_state as t_init_forward_state
from pigan_thz_torch.train.state import init_pigan_state as t_init_pigan_state
from pigan_thz_torch.train.state import make_optimizers as t_make_optimizers
from pigan_thz_torch.train.trainer import Trainer
from pigan_thz_tpu import config_presets as jp
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.data.dataset import build_dataset as j_build_dataset
from pigan_thz_tpu.models import build_forward_model as j_build_forward_model
from pigan_thz_tpu.models import build_trio as j_build_trio
from pigan_thz_tpu.train.state import init_forward_state as j_init_forward_state
from pigan_thz_tpu.train.state import init_pigan_state as j_init_pigan_state
from pigan_thz_tpu.train.state import make_optimizers as j_make_optimizers
from pigan_thz_tpu.train.steps import ForwardStepSettings as JFwdSettings
from pigan_thz_tpu.train.steps import StepSettings as JSettings
from pigan_thz_tpu.train.steps import make_forward_step as j_make_forward_step
from pigan_thz_tpu.train.steps import make_pigan_step as j_make_pigan_step

torch.set_num_threads(2)

N, B = 128, 64
ROWS_RTOL, STATS_RTOL = 5e-3, 1e-3
D_MOMENT_RTOL, G_MOMENT_RTOL = 1e-3, 5e-2
LR_STEPS = 2.2    # parameters: within 2.2 x lr a step (a sign flip of a
                  # rounding-level gradient moves an Adam entry by 2 x lr)

# the optimized preset's knobs, and the two D-phase variants
CASES = {
    "optimized": dict(steps=1),
    "wgan_gp": dict(steps=1, gan_loss="wgan_gp"),
    "d_every_2": dict(steps=2, d_update_every=2),
}


def _cfgs():
    def cut(c):
        return c.replace(data=dataclasses.replace(c.data, num_samples=N),
                         train=dataclasses.replace(c.train, batch_size=B, num_epochs=4))
    return (cut(jp.apply_optimization_config(j_default_config())),
            cut(tp.apply_optimization_config(t_default_config())))


@pytest.fixture(scope="module")
def datasets():
    _, tc = _cfgs()
    raw = synthetic_dataset(tc.data, device="cpu")
    jc, _ = _cfgs()
    jds = j_build_dataset(raw.spectra.numpy(), raw.params.numpy(), raw.metrics.numpy(),
                          jc.data)
    tds = ThzDataset(*(torch.from_numpy(np.array(x, np.float32)) for x in jds))
    return jds, tds


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _trees(jst) -> dict:
    ga, da = jst.g_opt[1][0], jst.d_opt[1][0]
    return {
        "g": {"params": _np(jst.g.params), "batch_stats": _np(jst.g.extra["batch_stats"])},
        "d": {"params": _np(jst.d.params), "batch_stats": _np(jst.d.extra["batch_stats"])},
        "f": {"params": _np(jst.f.params)},
        "g_mu": _np(ga.mu), "g_nu": _np(ga.nu), "g_count": int(ga.count),
        "d_mu": _np(da.mu), "d_nu": _np(da.nu), "d_count": int(da.count),
        "step": int(jst.step),
    }


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _gauge(path: str) -> bool:
    """G's Dense biases that feed BatchNorm (every one but the head's)."""
    return path.endswith("/bias") and "Dense" in path and not path.startswith("Dense_0")


@pytest.mark.parametrize("case", list(CASES))
def test_pigan_step_of_the_optimized_trio_matches_jax(case, datasets):
    jds, tds = datasets
    jc, tc = _cfgs()
    knobs = dict(CASES[case])
    steps = knobs.pop("steps")
    jset = dataclasses.replace(jp.step_settings_from_optimized_config(jc), **knobs)
    tset = dataclasses.replace(tp.step_settings_from_optimized_config(tc), **knobs)
    assert (jset.stability_w, jset.detach_forward) == (1.0, False)

    g, d, f = j_build_trio(jc)
    jg_tx, jd_tx, _ = j_make_optimizers(jc, N // B)
    jst = j_init_pigan_state(g, d, f, jg_tx, jd_tx, jax.random.PRNGKey(1))
    trees = _trees(jst)
    assert "u" in str(list(_flat(trees["d"]["batch_stats"])))

    # the JAX step's calls in trace order: G (D phase), D [real; fake],
    # [D's critic], G (G phase), D (G phase), G (stability, the G phase's key)
    d_sets = {"optimized": ["dd", "dg"], "wgan_gp": ["dd", "critic", "dg"]}.get(
        case, lambda args: "dd" if args[0].shape[0] == 2 * B else "dg")
    plan = MaskPlan(7, {"ResidualGenerator": ["gd", "gg", "gg"],
                        "DualEncoderDiscriminator": d_sets})
    jstep = jax.jit(j_make_pigan_step(g, d, f, jg_tx, jd_tx, jset, jds.param_lo,
                                      jds.param_hi))
    idx = np.random.default_rng(0).permutation(N)
    rng, jrows, draws = jst.rng, [], []
    with plan.apply():
        for s in range(steps):
            ix = idx[s * B:(s + 1) * B]
            batch = tuple(jnp.asarray(np.asarray(a)[ix]) for a in jds[:5])
            jst, m = jstep(jst, batch, 1.0)
            jrows.append({k: float(v) for k, v in m.items()})
            ks = jax.random.split(rng, 9)
            rng = ks[0]
            draws.append({"stability_noise": torch.from_numpy(
                np.array(jax.random.normal(ks[5], (B, 250)))),
                "gp_eps": torch.from_numpy(np.array(jax.random.uniform(ks[8], (B, 1))))})
    assert {n for n, _ in plan.sets} >= {"gd", "gg", "dd", "dg"}

    provider = plan.provider({
        tsteps.G_IN_D_PHASE: "gd", tsteps.G_IN_G_PHASE: "gg", tsteps.D_IN_G_PHASE: "dg",
        tsteps.D_IN_D_PHASE: lambda shape: "dd" if shape[0] == 2 * B else "critic"})

    tg, td, tf = t_build_trio(tc, device="cpu")
    tg_tx, td_tx, _ = t_make_optimizers(tc, N // B)
    tst = load_pigan_state_(t_init_pigan_state(tg, td, tf, tg_tx, td_tx, 0, device="cpu"),
                            trees)
    tstep = tsteps.make_pigan_step(tg_tx, td_tx, tset, tds.param_lo, tds.param_hi)
    for s in range(steps):
        ix = torch.from_numpy(idx[s * B:(s + 1) * B])
        tst, m = tstep(tst, tuple(a[ix] for a in tds[:5]), 1.0, 0,
                       {**draws[s], "dropout": provider})
        for k, v in jrows[s].items():
            assert abs(float(m[k]) - v) <= 1e-6 + ROWS_RTOL * abs(v), (s, k, float(m[k]), v)
    got = pigan_state_to_flax(tst)

    want = _trees(jst)
    for key in ("g", "d"):
        lr = tc.train.lr_g if key == "g" else tc.train.lr_d
        wp, gp = _flat(want[key]["params"]), _flat(got[key]["params"])
        for path, a in wp.items():
            if key == "g" and _gauge(path):
                continue
            assert np.max(np.abs(gp[path] - a)) <= LR_STEPS * lr * steps, (key, path)
        ws, gs = _flat(want[key]["batch_stats"]), _flat(got[key]["batch_stats"])
        assert ws.keys() == gs.keys()
        for path, a in ws.items():
            limit = STATS_RTOL * max(np.max(np.abs(a)), 1.0)
            assert np.max(np.abs(gs[path] - a)) <= limit, (key, path)
        gm = _flat(got[f"{key}_mu"])
        for path, a in _flat(want[f"{key}_mu"]).items():
            if key == "g" and _gauge(path):
                continue
            rel = np.linalg.norm(gm[path] - a) / max(np.linalg.norm(a), 1e-12)
            assert rel <= (G_MOMENT_RTOL * steps if key == "g" else D_MOMENT_RTOL), (
                key, path, rel)
        assert got[f"{key}_count"] == want[f"{key}_count"]


def test_uncertainty_forward_step_with_nll_matches_jax(datasets):
    """One step of the uncertainty surrogate with nll_w = 0.5 (its variance
    heads trained), the JAX masks carried across."""
    jds, tds = datasets
    jc, tc = _cfgs()
    jc = jc.replace(forward_model=dataclasses.replace(jc.forward_model, name="uncertainty"))
    tc = tc.replace(forward_model=dataclasses.replace(tc.forward_model, name="uncertainty"))
    jf = j_build_forward_model(jc.forward_model)
    _, _, jf_tx = j_make_optimizers(jc, N // B)
    jst = j_init_forward_state(jf, jf_tx, jax.random.PRNGKey(2))
    _, _, tf_tx = t_make_optimizers(tc, N // B)
    tst = t_init_forward_state(t_build_forward_model(tc.forward_model, device="cpu"), tf_tx, 0,
                               device="cpu")
    a = jst.opt[1][0]
    load_forward_state_(tst, _np(jst.f.params), _np(a.mu), _np(a.nu), int(a.count))

    plan = MaskPlan(3, {"UncertaintyForwardModel": ["fwd"]})
    ix = np.arange(B)
    with plan.apply():
        jstep = j_make_forward_step(jf, jf_tx, JFwdSettings(nll_w=0.5))
        jst, jm = jax.jit(jstep)(jst, tuple(jnp.asarray(np.asarray(x)[ix]) for x in jds[:5]))
    assert len(plan.sets) == 7
    tstep = tsteps.make_forward_step(tf_tx, tsteps.ForwardStepSettings(nll_w=0.5))
    tst, tm = tstep(tst, tuple(x[torch.from_numpy(ix)] for x in tds[:5]), None, 0,
                    {"dropout": plan.provider({tsteps.FORWARD: "fwd"})})
    for k in ("loss", "spectrum_loss", "metrics_loss"):
        assert abs(float(tm[k]) - float(jm[k])) <= ROWS_RTOL * abs(float(jm[k])), k
    got = forward_state_to_flax(tst)
    a = jst.opt[1][0]
    for key, tree in (("params", jst.f.params), ("mu", a.mu)):
        for path, w in _flat(_np(tree)).items():
            g = _flat(got[key])[path]
            if key == "params":
                assert np.max(np.abs(g - w)) <= LR_STEPS * tc.train.fwd_pretrain_lr, path
            else:
                assert np.linalg.norm(g - w) <= D_MOMENT_RTOL * max(np.linalg.norm(w), 1e-12), path


# ---------------------------------------------------------------------------
# Resume, the engine rule, the command as typed
# ---------------------------------------------------------------------------


def _small(cfg, n=64, batch=32):
    return cfg.replace(data=dataclasses.replace(cfg.data, num_samples=n),
                       train=dataclasses.replace(cfg.train, batch_size=batch, num_epochs=4,
                                                 fwd_pretrain_epochs=2))


def _payload(state):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in state.state_dict().items()}


def test_kill_and_resume_of_an_enhanced_trio_is_bit_for_bit(tmp_path):
    """Residual G, spectral-norm multi-scale D and the physics F (attention
    dropout in every step), two GAN epochs, a save, a fresh trainer, two
    more: bit for bit the uninterrupted run, D's u / sigma included."""
    c = t_default_config()
    cfg = _small(c.replace(
        generator=dataclasses.replace(c.generator, name="residual"),
        discriminator=dataclasses.replace(c.discriminator, name="multi_scale",
                                          use_spectral_norm=True),
        forward_model=dataclasses.replace(c.forward_model, name="physics")))
    ds = synthetic_dataset(cfg.data, device="cpu")
    settings = tp.step_settings_from_optimized_config(tp.apply_optimization_config(cfg))

    def run(mgr_dir=None):
        t = Trainer(cfg, ds=ds, device="cpu", epochs_per_call=2)
        t.pretrain_forward(epochs=2, seed=0, log_every=10**9)
        t.init_pigan()
        t.train_pigan(epochs=2, settings=settings, seed=0, log_every=10**9)
        if mgr_dir:
            mgr = ckpt.CheckpointManager(mgr_dir, save_interval=1)
            mgr.save(2, t.pigan_state, history=t.train_history, config=cfg)
            t = Trainer(cfg, ds=ds, device="cpu", epochs_per_call=2)
            assert t.resume_from(mgr, "pigan") == 2
        t.train_pigan(epochs=2, settings=settings, seed=2, log_every=10**9)
        return t

    ref, got = run(), run(str(tmp_path))
    assert got.train_history == ref.train_history
    a, b = _payload(ref.pigan_state), _payload(got.pigan_state)
    assert a.keys() == b.keys() and any(k.endswith(".u") for k in a)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_engine_rule_on_the_card_side(capsys):
    """With the device type set to CUDA (nothing launches here): "auto"
    takes the eager step for a phase with a model no kernel covers and says
    why, keeps the baseline F's pretraining on its kernel, still raises for
    a baseline trio outside the kernel's envelope; "kernel" raises on an
    enhanced model."""
    cfg = _small(tp.apply_optimization_config(t_default_config()))
    ds = synthetic_dataset(cfg.data, device="cpu")
    t = Trainer(cfg, ds=ds, device="cpu")
    t.device = torch.device("cuda")
    settings = tp.step_settings_from_optimized_config(cfg)
    assert not t._use_kernel("PI-GAN training", "GAN-training", "generator is not the "
                             "baseline MLP(512,256)", ("generator", "discriminator",
                                                      "forward model"))
    err = capsys.readouterr().err
    assert "eager step: no TPU kernel covers the generator 'residual', discriminator " \
           "'dual_encoder'" in err
    assert t._use_kernel("forward pretraining", "forward-training", None, ("forward model",))
    t.engine = "kernel"
    with pytest.raises(ValueError, match="generator is not the baseline"):
        t._gan_epoch_fn(settings, t.g_tx, t.d_tx, {}, 2)
    base = Trainer(_small(t_default_config().replace(train=dataclasses.replace(
        t_default_config().train, adam_state_dtype="bfloat16"))), ds=ds, device="cpu")
    base.device = torch.device("cuda")
    with pytest.raises(ValueError, match="adam_state_dtype"):
        base._gan_epoch_fn(settings, base.g_tx, base.d_tx, {}, 2)


def test_train_preset_optimized_as_typed_then_evaluate_and_serve(tmp_path, capsys):
    """``train --preset optimized`` as typed at a tiny budget, ``evaluate``
    on the saved trio, and a B = 64 request: the baseline F's stage through
    its kernel (here the plain version), the residual G's through its
    module, equal to the all-module cycle; ``use_pallas=True`` refuses the
    residual G."""
    work = str(tmp_path)
    rc = cli_main(["train", "--device", "cpu", "--preset", "optimized", "--epochs", "2",
                   "--forward-epochs", "2", "--set", "data.num_samples=128", "--set",
                   "train.batch_size=32", "--workdir", work, "--no-tensorboard"])
    assert rc == 0
    out = capsys.readouterr()
    assert "PI-GAN training on the eager step" in out.out + out.err
    models = os.path.join(work, "saved_models")
    saved = json.load(open(os.path.join(models, "model_config.json")))
    assert (saved["generator"]["name"], saved["discriminator"]["name"]) == (
        "residual", "dual_encoder")
    assert cli_main(["evaluate", "--device", "cpu", "--models", models, "--set",
                     "data.num_samples=128", "--json", os.path.join(work, "e.json")]) == 0
    report = json.load(open(os.path.join(work, "e.json")))
    assert np.isfinite(report["pigan_evaluation"]["parameter_prediction"]["r2"])

    cfg = _small(tp.apply_optimization_config(t_default_config()), n=128)
    t = Trainer(cfg, device="cpu")
    t.load_final(models)
    g, f = t.pigan_state.g, t.pigan_state.f
    designer = _designer(g, f, t.ds, None, None)
    assert isinstance(designer.generator, ModuleStage)
    assert isinstance(designer.surrogate, FusedStage)
    spectra = t.ds.spectra[:64].contiguous()
    got = make_inverse_design_fn(g, f, t.ds)(spectra)
    want = make_inverse_design_fn(g, f, t.ds, use_pallas=False)(spectra)
    for a, b in zip(got, want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-4
    with pytest.raises(ValueError, match="baseline"):
        make_inverse_design_fn(g, f, t.ds, use_pallas=True)


def test_evaluate_reads_the_uncertainty_surrogate_s_means():
    """A trio with the uncertainty F: the evaluator reads its means (its
    forward-suite spectra are the model's first output) and every suite's
    numbers are finite."""
    c = t_default_config()
    cfg = _small(c.replace(forward_model=dataclasses.replace(c.forward_model,
                                                             name="uncertainty")))
    t = Trainer(cfg, device="cpu", epochs_per_call=1)
    t.pretrain_forward(epochs=1, log_every=10**9)
    t.init_pigan()
    res = t.evaluate()
    r2 = res["forward_network_evaluation"]["spectrum_prediction"]["r2"]
    with torch.no_grad():
        mean = t.pigan_state.f.eval()(t.ds.params_norm)[0]
    want = 1.0 - float(((mean - t.ds.spectra) ** 2).sum() / (
        (t.ds.spectra - t.ds.spectra.mean(0)) ** 2).sum())
    assert np.isfinite(r2) and np.isfinite(res["pigan_evaluation"]["parameter_prediction"]["r2"])
    assert abs(r2 - want) < 0.5 * abs(want) + 1.0
