"""``train --mode full`` as typed, through the JAX package's XLA step and the
port's eager step, from one set of weights and one shuffle sequence.

The command as typed pretrains F, then trains the PI-GAN with F's input
detached (``detach_forward`` True: ``--fixed-physics`` off).  Both sides run
the same epochs at full width: the JAX package's ``make_epoch_fn`` over its
XLA steps, the port's ``make_multi_epoch_fn`` over its eager steps, each
epoch on the shuffle ``epoch_indices(key)`` of one JAX key.  F, G and D start
from the JAX package's initialisation (carried across with ``interop``); the
PI-GAN phase starts from each side's own pretrained F.  The dropout masks of
F's pretraining are each side's own (JAX's generator, the port's counter
hash): the one draw the two cannot share.

What is compared is the result: G's param R² over the training set (eval
mode) and the last epoch's ``recon_spec_loss``.  The JAX package records a
seed spread of 0.002 in R² (RESULTS.md:939).

    PYTHONPATH=. python tests/test_torch_reference_run.py --forward-epochs 100 --epochs 100

runs it at the full reference size (1000 samples) and prints one JSON line;
the ``slow``-marked test runs it at a small budget.  ``--perturb-g 1e-7``
scales G's initial weights by 1 + 1e-7 on both sides: how far a
rounding-sized change of the start moves each side's result.
"""

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.data.dataset import ThzDataset
from pigan_thz_torch.interop import (
    forward_state_to_flax,
    load_forward_state_,
    load_pigan_state_,
)
from pigan_thz_torch.models import build_forward_model as t_build_forward_model
from pigan_thz_torch.models import build_trio as t_build_trio
from pigan_thz_torch.ops.metrics import r2_score as t_r2_score
from pigan_thz_torch.train.state import init_forward_state as t_init_forward_state
from pigan_thz_torch.train.state import init_pigan_state as t_init_pigan_state
from pigan_thz_torch.train.state import make_optimizers as t_make_optimizers
from pigan_thz_torch.train.steps import StepSettings as TSettings
from pigan_thz_torch.train.steps import make_forward_step as t_make_forward_step
from pigan_thz_torch.train.steps import make_multi_epoch_fn as t_make_multi_epoch_fn
from pigan_thz_torch.train.steps import make_pigan_step as t_make_pigan_step
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.data.dataset import build_dataset as j_build_dataset
from pigan_thz_tpu.data.dataset import epoch_indices as j_epoch_indices
from pigan_thz_tpu.models import build_trio as j_build_trio
from pigan_thz_tpu.train.state import init_forward_state as j_init_forward_state
from pigan_thz_tpu.train.state import init_pigan_state as j_init_pigan_state
from pigan_thz_tpu.train.state import make_optimizers as j_make_optimizers
from pigan_thz_tpu.train.steps import StepSettings as JSettings
from pigan_thz_tpu.train.steps import make_epoch_fn as j_make_epoch_fn
from pigan_thz_tpu.train.steps import make_forward_step as j_make_forward_step
from pigan_thz_tpu.train.steps import make_pigan_step as j_make_pigan_step


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _configs(num_samples: int, forward_epochs: int, epochs: int, compute_dtype: str,
             dropout_rate: float | None = None):
    def over(cfg):
        if dropout_rate is not None:
            cfg = cfg.replace(forward_model=dataclasses.replace(cfg.forward_model,
                                                                dropout_rate=dropout_rate))
        return cfg.replace(
            data=dataclasses.replace(cfg.data, num_samples=num_samples),
            train=dataclasses.replace(cfg.train, fwd_pretrain_epochs=forward_epochs,
                                      num_epochs=epochs, compute_dtype=compute_dtype))
    return over(j_default_config()), over(t_default_config())


def _gp_draws(rng, steps: int, batch: int) -> list:
    """The WGAN-GP interpolation weights the JAX step draws from its key chain
    (its state's key splits in 9 each step), as the port's per-step draws."""
    out = []
    for _ in range(steps):
        ks = jax.random.split(rng, 9)
        rng = ks[0]
        out.append({"gp_eps": torch.from_numpy(np.array(jax.random.uniform(ks[8], (batch, 1))))})
    return out


def run_both(num_samples: int = 1000, forward_epochs: int = 100, epochs: int = 100,
             seed: int = 0, port_seed: int = 0, compute_dtype: str = "float32",
             gan_loss: str = "bce", detach_forward: bool = True,
             dropout_rate: float | None = None, perturb_g: float = 0.0,
             shared_f: bool = False) -> dict:
    """Both sides' ``train --mode full``, as typed by default (F's input
    detached, float32, BCE); returns each side's final param R² and
    recon_spec_loss and its wall seconds on this machine.  ``port_seed``
    seeds the port's forward state's generator, which draws its dropout
    seeds: another value gives the port other dropout masks and nothing else
    different, the spread that the unshared draw alone makes (``dropout_rate``
    0 removes it).  Under WGAN-GP the port's step takes the JAX step's
    interpolation weights.  ``perturb_g`` scales G's initial weights by
    1 + ``perturb_g`` on both sides; ``shared_f`` starts the port's PI-GAN
    phase from the JAX side's pretrained F.  Each side's pretrained F is
    scored by its spectrum MSE over the training set (eval mode), and the
    PI-GAN phase's recon_spec_loss is kept epoch by epoch."""
    jc, tc = _configs(num_samples, forward_epochs, epochs, compute_dtype, dropout_rate)
    raw = synthetic_dataset(tc.data, device="cpu")
    jds = j_build_dataset(raw.spectra.numpy(), raw.params.numpy(), raw.metrics.numpy(),
                          jc.data)
    tds = ThzDataset(*(torch.from_numpy(np.array(x, np.float32)) for x in jds))
    b = jc.train.batch_size
    spe = num_samples // b
    keys = jax.random.split(jax.random.PRNGKey(seed + 100), forward_epochs + epochs)
    indices = [torch.from_numpy(np.array(j_epoch_indices(k, num_samples, b)))[None]
               for k in keys]

    # -- forward pretraining --------------------------------------------------
    g, d, f = j_build_trio(jc)
    g_tx, d_tx, f_tx = j_make_optimizers(jc, spe)
    jfs = j_init_forward_state(f, f_tx, jax.random.PRNGKey(seed))
    gtx, dtx, ftx = t_make_optimizers(tc, spe)
    tfs = t_init_forward_state(t_build_forward_model(tc.forward_model, device="cpu",
                                                     dtype=compute_dtype), ftx, port_seed)
    adam = jfs.opt[1][0]
    load_forward_state_(tfs, _np32(jfs.f.params), _np32(adam.mu), _np32(adam.nu),
                        int(adam.count), int(jfs.step))
    t0 = time.perf_counter()
    fepoch = j_make_epoch_fn(j_make_forward_step(f, f_tx), b)
    for e in range(forward_epochs):
        jfs, _ = fepoch(jfs, jds, keys[e])
    jax.block_until_ready(jfs.f.params)
    j_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    tfn = t_make_multi_epoch_fn(t_make_forward_step(ftx), b)
    for e in range(forward_epochs):
        tfs, _ = tfn(tfs, tds, torch.ones(1), indices=indices[e])
    t_wall = time.perf_counter() - t0
    j_fmse = float(jnp.mean((f.apply(jfs.f.variables, jds.params_norm, train=False)[0]
                             - jds.spectra) ** 2))
    with torch.no_grad():
        t_fmse = float(((tfs.f.eval()(tds.params_norm)[0] - tds.spectra) ** 2).mean())
    tfs.f.train()

    # -- the PI-GAN phase, F's input detached -------------------------------------
    jset = JSettings.from_config(jc, detach_forward=detach_forward, gan_loss=gan_loss)
    tset = TSettings.from_config(tc, detach_forward=detach_forward, gan_loss=gan_loss)
    jps = j_init_pigan_state(g, d, f, g_tx, d_tx, jax.random.PRNGKey(seed + 1),
                             forward_variables=jfs.f.variables)
    if perturb_g:
        jps = jps.replace(g=jps.g.replace(
            params=jax.tree.map(lambda a: a * (1.0 + perturb_g), jps.g.params)))
    tg, td, tf = t_build_trio(tc, device="cpu")
    tps = t_init_pigan_state(tg, td, tf, gtx, dtx, 0, device="cpu")
    ga, da = jps.g_opt[1][0], jps.d_opt[1][0]
    load_pigan_state_(tps, {
        "g": {"params": _np32(jps.g.params), "batch_stats": _np32(jps.g.extra["batch_stats"])},
        "d": {"params": _np32(jps.d.params)},
        "f": {"params": _np32(jfs.f.params) if shared_f
              else forward_state_to_flax(tfs)["params"]},
        "g_mu": _np32(ga.mu), "g_nu": _np32(ga.nu), "g_count": 0,
        "d_mu": _np32(da.mu), "d_nu": _np32(da.nu), "d_count": 0, "step": 0})
    draws = _gp_draws(jps.rng, epochs * spe, b) if gan_loss == "wgan_gp" else None
    t0 = time.perf_counter()
    pepoch = j_make_epoch_fn(j_make_pigan_step(g, d, f, g_tx, d_tx, jset, jds.param_lo,
                                               jds.param_hi), b, with_scale=True)
    j_curve = []
    for e in range(epochs):
        jps, jm = pepoch(jps, jds, keys[forward_epochs + e])
        j_curve.append(float(jm["recon_spec_loss"]))
    jax.block_until_ready(jps.g.params)
    j_wall += time.perf_counter() - t0
    t0 = time.perf_counter()
    tfn = t_make_multi_epoch_fn(t_make_pigan_step(gtx, dtx, tset, tds.param_lo, tds.param_hi), b)
    t_curve = []
    for e in range(epochs):
        tps, tm = tfn(tps, tds, torch.ones(1), indices=indices[forward_epochs + e],
                      draws=None if draws is None else draws[e * spe:(e + 1) * spe])
        t_curve.append(float(tm["recon_spec_loss"][-1]))
    t_wall += time.perf_counter() - t0

    # -- the result ------------------------------------------------------------------
    pred = g.apply({"params": jps.g.params, "batch_stats": jps.g.extra["batch_stats"]},
                   jds.spectra, train=False)
    j_r2 = float(t_r2_score(torch.from_numpy(np.array(jds.params_norm)),
                            torch.from_numpy(np.array(pred, np.float32))))
    with torch.no_grad():
        t_r2 = float(t_r2_score(tds.params_norm, tps.g.eval()(tds.spectra).float()))
    return {"num_samples": num_samples, "forward_epochs": forward_epochs, "epochs": epochs,
            "jax_xla": {"param_r2": j_r2, "recon_spec_loss": float(jm["recon_spec_loss"]),
                        "f_spectrum_mse": j_fmse, "recon_by_epoch": j_curve,
                        "wall_s": j_wall},
            "port_eager": {"param_r2": t_r2,
                           "recon_spec_loss": float(tm["recon_spec_loss"][-1]),
                           "f_spectrum_mse": t_fmse, "recon_by_epoch": t_curve,
                           "wall_s": t_wall}}


@pytest.mark.slow
def test_train_as_typed_matches_the_jax_xla_path():
    """A small budget of the comparison: both sides train, and end near each
    other (the full-size run is recorded in PERF.md)."""
    out = run_both(num_samples=256, forward_epochs=10, epochs=10)
    j, t = out["jax_xla"], out["port_eager"]
    assert all(np.isfinite([j["param_r2"], t["param_r2"], j["recon_spec_loss"],
                            t["recon_spec_loss"]]))
    assert abs(j["param_r2"] - t["param_r2"]) < 0.1, out
    assert abs(j["recon_spec_loss"] - t["recon_spec_loss"]) < 0.1 * j["recon_spec_loss"], out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-samples", type=int, default=1000)
    ap.add_argument("--forward-epochs", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--port-seed", type=int, default=0)
    ap.add_argument("--dropout-rate", type=float, default=None,
                    help="F's dropout rate (default the config's 0.2; 0 shares every draw)")
    ap.add_argument("--perturb-g", type=float, default=0.0,
                    help="scale G's initial weights by 1 + this, on both sides")
    ap.add_argument("--shared-f", action="store_true",
                    help="the port's PI-GAN phase starts from the JAX side's pretrained F")
    a = ap.parse_args()
    print(json.dumps(run_both(a.num_samples, a.forward_epochs, a.epochs, a.seed, a.port_seed,
                              dropout_rate=a.dropout_rate, perturb_g=a.perturb_g,
                              shared_f=a.shared_f)))
