"""``train.compute_dtype="bfloat16"`` in the port's eager leg, against the JAX
package's flax modules and XLA steps with ``dtype=bfloat16``.

- The models: ``build_trio`` reads the compute dtype; parameters stay
  float32; G (train and eval mode), D and F give flax's outputs on the same
  carried-over weights.
- One eager forward step and one eager PI-GAN step against the JAX XLA
  steps on the same weights and batch.
- The slice as a whole: forward pretraining and the PI-GAN phase through
  both packages' epoch functions (the loops their Trainers run) from one set
  of weights and one shuffle sequence, under bfloat16 and under WGAN-GP.
- The port's Trainer trains ``mode="full"`` under bfloat16 + WGAN-GP on both
  of its CPU engines (the eager step, the kernel's plain version).

Tolerances.  A bfloat16 value carries 8 bits: one rounding is up to 2^-9
relative, and where the two packages' float32 sums differ by an ulp a
rounding can land on the other neighbour (2^-8).  Outputs are held to
MODEL_RTOL of their largest magnitude (measured 0 to 5.8e-3: the
discriminator's and F's heads sum 256 rounded terms); one step's rows to
STEP_ROWS_RTOL (measured below 3e-3).  Adam's first moments (the step's
gradients) are held tensor by tensor in relative L2 to STEP_MOMENT_RTOL or,
where bfloat16 itself moves a gradient further, to twice the distance
between the JAX package's own float32 and bfloat16 steps: G's gradient
passes two BatchNorm backwards that subtract each column's mean, and the
critic's under WGAN-GP is a difference of real and fake rows that share 250
of 254 inputs, so what survives is small beside the activations' rounding
(measured: the port 0.11 from the JAX step in G's first layer, the JAX
package's float32 step 0.10 from its bfloat16 one).  The slice as a whole
runs without dropout (the one draw the packages cannot share) and is held
to SLICE_RECON_RTOL in recon_spec_loss (measured 6e-5) and SLICE_R2_ATOL in
param R² (measured 0.03 in float32, 0.16 in bfloat16): after 3 + 3 epochs
G's eval-mode output rides on BatchNorm running means that have absorbed
the walk of G's two Dense biases before BatchNorm, whose true gradient is
zero and whose Adam steps are each package's rounding noise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.config import DiscriminatorConfig as TDiscCfg
from pigan_thz_torch.config import ForwardModelConfig as TForwardCfg
from pigan_thz_torch.config import GeneratorConfig as TGenCfg
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.data.dataset import ThzDataset, gather_batch
from pigan_thz_torch.interop import from_flax, load_forward_state_, load_pigan_state_
from pigan_thz_torch.models import (
    build_discriminator,
    build_forward_model,
    build_generator,
    build_trio,
)
from pigan_thz_torch.train.state import init_forward_state, init_pigan_state, make_optimizers
from pigan_thz_torch.train.steps import ForwardStepSettings, StepSettings, make_forward_step
from pigan_thz_torch.train.steps import make_pigan_step
from pigan_thz_torch.train.trainer import Trainer
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.config import DiscriminatorConfig, ForwardModelConfig, GeneratorConfig
from pigan_thz_tpu.data.dataset import build_dataset as j_build_dataset
from pigan_thz_tpu.models import build_discriminator as j_build_discriminator
from pigan_thz_tpu.models import build_forward_model as j_build_forward_model
from pigan_thz_tpu.models import build_generator as j_build_generator
from pigan_thz_tpu.models import build_trio as j_build_trio
from pigan_thz_tpu.train.state import init_forward_state as j_init_forward_state
from pigan_thz_tpu.train.state import init_pigan_state as j_init_pigan_state
from pigan_thz_tpu.train.state import make_optimizers as j_make_optimizers
from pigan_thz_tpu.train.steps import ForwardStepSettings as JFSettings
from pigan_thz_tpu.train.steps import StepSettings as JSettings
from pigan_thz_tpu.train.steps import gather_batch as j_gather_batch
from pigan_thz_tpu.train.steps import make_forward_step as j_make_forward_step
from pigan_thz_tpu.train.steps import make_pigan_step as j_make_pigan_step

torch.set_num_threads(1)

MODEL_RTOL = 2e-2
STEP_ROWS_RTOL = 1e-2
STEP_MOMENT_RTOL = 5e-2
SLICE_R2_ATOL, SLICE_RECON_RTOL = 0.25, 1e-3
N, B = 128, 64
BF16 = "bfloat16"


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _rel_max(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(b, seed=0):
    rng = np.random.default_rng(seed)
    spectra = (-8.0 * rng.random((b, 250)) ** 2).astype(np.float32)
    params = rng.uniform(2.2, 2.8, (b, 4)).astype(np.float32)
    params_norm = rng.uniform(-1.0, 1.0, (b, 4)).astype(np.float32)
    return spectra, params, params_norm


def _configs(dtype=BF16, **train):
    def over(cfg):
        return cfg.replace(data=dataclasses.replace(cfg.data, num_samples=N),
                           train=dataclasses.replace(cfg.train, batch_size=B,
                                                     compute_dtype=dtype, **train))
    return over(j_default_config()), over(t_default_config())


@pytest.fixture(scope="module")
def datasets():
    jc, tc = _configs()
    raw = synthetic_dataset(tc.data, device="cpu")
    jds = j_build_dataset(raw.spectra.numpy(), raw.params.numpy(), raw.metrics.numpy(),
                          jc.data)
    tds = ThzDataset(*(torch.from_numpy(np.array(x, np.float32)) for x in jds))
    return jds, tds


@pytest.mark.parametrize("which", ["generator_train", "generator_eval", "discriminator",
                                   "forward_model"])
def test_models_follow_compute_dtype(which):
    spectra, params, params_norm = _inputs(64)
    key = jax.random.PRNGKey(3)
    if which.startswith("generator"):
        jm = j_build_generator(GeneratorConfig(), dtype=BF16)
        jv = dict(_np32(jm.init(key, jnp.zeros((2, 250)))))
        jv["batch_stats"] = jax.tree.map(lambda a: a + 0.5, jv["batch_stats"])
        train = which.endswith("train")
        if train:
            want, _ = jm.apply(jv, spectra, train=True, mutable=["batch_stats"])
        else:
            want = jm.apply(jv, spectra)
        tm = build_generator(TGenCfg(), device="cpu", dtype=BF16)
        tm.load_state_dict(from_flax(jv, "generator"))
        tm.train(train)
        got = tm(torch.from_numpy(spectra))
        outs = [(got, want)]
    elif which == "discriminator":
        jm = j_build_discriminator(DiscriminatorConfig(), dtype=BF16)
        jv = _np32(jm.init(key, jnp.zeros((2, 250)), jnp.zeros((2, 4))))
        tm = build_discriminator(TDiscCfg(), device="cpu", dtype=BF16)
        tm.load_state_dict(from_flax(jv, "discriminator"))
        outs = [(tm(torch.from_numpy(spectra), torch.from_numpy(params)),
                 jm.apply(jv, spectra, params))]
    else:
        jm = j_build_forward_model(ForwardModelConfig(), dtype=BF16)
        jv = _np32(jm.init(key, jnp.zeros((2, 4))))
        tm = build_forward_model(TForwardCfg(), device="cpu", dtype=BF16).eval()
        tm.load_state_dict(from_flax(jv, "forward_model"))
        outs = list(zip(tm(torch.from_numpy(params_norm)), jm.apply(jv, params_norm)))
    for got, want in outs:
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        assert tuple(got.shape) == want.shape
        assert _rel_max(got.detach().float().numpy(), want) <= MODEL_RTOL
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_build_trio_reads_compute_dtype():
    _, tc = _configs()
    g, d, f = build_trio(tc, device="cpu")
    spectra, params, params_norm = (torch.from_numpy(x) for x in _inputs(4))
    assert g.eval()(spectra).dtype == d(spectra, params).dtype == torch.bfloat16
    assert f.eval()(params_norm)[0].dtype == torch.bfloat16
    g32, _, _ = build_trio(t_default_config(), device="cpu")
    assert g32.eval()(spectra).dtype == torch.float32
    with pytest.raises(ValueError, match="compute_dtype"):
        build_generator(TGenCfg(), device="cpu", dtype="float16")


def _moments_rel(port_m, jax_mu):
    """Per tensor ‖port − jax‖ / ‖jax‖ of two first-moment trees (the port's
    in flax's layout)."""
    out = []
    for a, b in zip(jax.tree.leaves(port_m), jax.tree.leaves(_np32(jax_mu))):
        scale = np.linalg.norm(b)
        if scale > 0:
            out.append(float(np.linalg.norm(np.asarray(a) - b) / scale))
    return out


def test_one_eager_forward_step_matches_the_jax_xla_step(datasets):
    """One pretraining step (dropout 0: the two packages draw other masks) of
    the bfloat16 F from the same weights on the same batch."""
    from pigan_thz_torch.interop import forward_state_to_flax

    jds, tds = datasets
    jc, tc = _configs()
    jc = jc.replace(forward_model=dataclasses.replace(jc.forward_model, dropout_rate=0.0))
    tc = tc.replace(forward_model=dataclasses.replace(tc.forward_model, dropout_rate=0.0))
    f = j_build_forward_model(jc.forward_model, dtype=BF16)
    _, _, ftx = j_make_optimizers(jc, N // B)
    jst = j_init_forward_state(f, ftx, jax.random.PRNGKey(2))
    _, _, ttx = make_optimizers(tc, N // B)
    tst = init_forward_state(build_forward_model(tc.forward_model, device="cpu", dtype=BF16),
                             ttx, 0)
    adam = jst.opt[1][0]
    load_forward_state_(tst, _np32(jst.f.params), _np32(adam.mu), _np32(adam.nu), 0, 0)
    idx = np.arange(B)
    jst, jm = j_make_forward_step(f, ftx, JFSettings())(jst, j_gather_batch(jds, idx))
    tst, tm = make_forward_step(ttx, ForwardStepSettings())(
        tst, gather_batch(tds, torch.from_numpy(idx)))
    for k in tm:
        assert abs(float(tm[k]) - float(jm[k])) <= STEP_ROWS_RTOL * abs(float(jm[k])), k
    back = forward_state_to_flax(tst)
    assert max(_moments_rel(back["mu"], jst.opt[1][0].mu)) <= STEP_MOMENT_RTOL


@pytest.mark.parametrize("knobs", [dict(detach_forward=False),
                                   dict(detach_forward=True, gan_loss="wgan_gp")],
                         ids=["through_f", "wgan_gp_detached"])
def test_one_eager_pigan_step_matches_the_jax_xla_step(knobs, datasets):
    """One PI-GAN step of the bfloat16 trio from the same weights on the same
    batch (WGAN-GP with the JAX step's own interpolation weights), the JAX
    package's float32 step from the same weights as the yardstick."""
    from pigan_thz_torch.interop import pigan_state_to_flax

    jds, tds = datasets
    jc, tc = _configs()
    jc32, _ = _configs("float32")
    runs = {}
    for name, c in (("bf16", jc), ("float32", jc32)):
        g, d, f = j_build_trio(c)
        g_tx, d_tx, _ = j_make_optimizers(c, N // B)
        if name == "bf16":
            jst = start = j_init_pigan_state(g, d, f, g_tx, d_tx, jax.random.PRNGKey(1))
            ks = jax.random.split(jst.rng, 9)
            eps = torch.from_numpy(np.array(jax.random.uniform(ks[8], (B, 1))))
            tg, td, tf = build_trio(tc, device="cpu")
            gtx, dtx, _ = make_optimizers(tc, N // B)
            tst = init_pigan_state(tg, td, tf, gtx, dtx, 0, device="cpu")
            ga, da = jst.g_opt[1][0], jst.d_opt[1][0]
            load_pigan_state_(tst, {
                "g": {"params": _np32(jst.g.params),
                      "batch_stats": _np32(jst.g.extra["batch_stats"])},
                "d": {"params": _np32(jst.d.params)}, "f": {"params": _np32(jst.f.params)},
                "g_mu": _np32(ga.mu), "g_nu": _np32(ga.nu), "g_count": 0,
                "d_mu": _np32(da.mu), "d_nu": _np32(da.nu), "d_count": 0, "step": 0})
        else:   # the same weights in a float32 trio
            jst = start
        jset = JSettings.from_config(c, **knobs)
        runs[name] = j_make_pigan_step(g, d, f, g_tx, d_tx, jset, jds.param_lo,
                                       jds.param_hi)(jst, j_gather_batch(jds, np.arange(B)))
    (jst, jm), (j32, _) = runs["bf16"], runs["float32"]
    tset = StepSettings.from_config(tc, **knobs)
    tst, tm = make_pigan_step(gtx, dtx, tset, tds.param_lo, tds.param_hi)(
        tst, gather_batch(tds, torch.arange(B)), 1.0, 0, {"gp_eps": eps})
    for k in jm:
        if k in ("d_accuracy", "violation_rate"):
            assert abs(float(tm[k]) - float(jm[k])) <= 2.0 / B, k
            continue
        assert abs(float(tm[k]) - float(jm[k])) <= STEP_ROWS_RTOL * max(
            abs(float(jm[k])), 1e-3), k
    back = pigan_state_to_flax(tst)
    for part in ("g", "d"):
        got = _moments_rel(back[f"{part}_mu"], getattr(jst, f"{part}_opt")[1][0].mu)
        yard = _moments_rel(_np32(getattr(j32, f"{part}_opt")[1][0].mu),
                            getattr(jst, f"{part}_opt")[1][0].mu)
        print(f"{part} first moments: port vs JAX bf16",
              [f"{x:.3e}" for x in got], "JAX float32 vs bf16", [f"{x:.3e}" for x in yard])
        # (G's two Dense biases before BatchNorm, the gauge leaves, are noise
        # in both packages: their true gradient is zero)
        bad = [j for j, (a, y) in enumerate(zip(got, yard))
               if not a <= max(STEP_MOMENT_RTOL, 2.0 * y)
               and not (part == "g" and j in (0, 4))]
        assert not bad, (part, bad, got, yard)


@pytest.mark.parametrize("dtype, gan_loss", [(BF16, "bce"), ("float32", "wgan_gp")],
                         ids=["bf16", "wgan_gp"])
def test_the_slice_as_a_whole_matches_the_jax_xla_path(dtype, gan_loss):
    """Forward pretraining, then the PI-GAN phase with gradients through F,
    through both packages' epoch functions from one set of weights and one
    shuffle sequence (``tests/test_torch_reference_run.py``), 3 + 3 epochs
    on 128 samples at full width, without dropout: the final param R² and
    recon_spec_loss agree."""
    from test_torch_reference_run import run_both

    out = run_both(num_samples=N, forward_epochs=3, epochs=3, compute_dtype=dtype,
                   gan_loss=gan_loss, detach_forward=False, dropout_rate=0.0)
    j, t = out["jax_xla"], out["port_eager"]
    assert abs(j["param_r2"] - t["param_r2"]) <= SLICE_R2_ATOL, out
    assert abs(j["recon_spec_loss"] - t["recon_spec_loss"]) <= (
        SLICE_RECON_RTOL * j["recon_spec_loss"]), out


def test_trainer_trains_full_in_bf16_with_wgan_on_both_cpu_engines(datasets):
    """The port's Trainer, ``mode="full"``, bfloat16 + WGAN-GP: the eager
    step ("auto" on the CPU) and the kernel's plain version ("kernel") both
    train both phases from one seed; they are two numerics (the eager models
    round activations as flax does, the kernel only its products' operands),
    so their rows agree to a bfloat16 tolerance, not to the last bit."""
    _, tds = datasets
    _, tc = _configs()
    settings = StepSettings.from_config(tc, detach_forward=False, gan_loss="wgan_gp")
    hist = {}
    for engine in ("auto", "kernel"):
        tr = Trainer(tc, ds=tds, epochs_per_call=2, engine=engine, device="cpu")
        tr.pretrain_forward(epochs=2)
        tr.init_pigan()
        hist[engine] = tr.train_pigan(epochs=2, settings=settings)
        assert tr.pigan_state.g.main[0].compute_dtype == torch.bfloat16
    for k in ("forward/loss", "pigan/recon_spec_loss", "pigan/g_loss"):
        a, b = np.asarray(hist["auto"][k]), np.asarray(hist["kernel"][k])
        assert np.all(np.isfinite(a)) and np.all(np.isfinite(b))
        np.testing.assert_allclose(a, b, rtol=5e-2, err_msg=k)
