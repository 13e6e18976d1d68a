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
hash): the one draw the two cannot share (``--dropout-rate 0`` and
``--shared-f`` take it away).

What is compared is the result: G's param R² over the training set (eval
mode) and the last epoch's ``recon_spec_loss``.  The JAX package records a
seed spread of 0.002 in R² (RESULTS.md:939).

    PYTHONPATH=. python tests/test_torch_reference_run.py --forward-epochs 100 --epochs 100

runs it at the full reference size (1000 samples) and prints one JSON line;
``--seeds 0-7 --jobs 4 --out DIR`` runs paired seeds in processes of their
own and prints ``summarize_pairs`` (``--summarize DIR`` reprints it);
``--fixed-physics`` runs that recipe.  ``--perturb-g 1e-7`` scales G's
initial weights by 1 + 1e-7 on both sides: how far a rounding-sized change
of the start moves each side's result.

``--audit`` runs ``trajectory_audit``: the PI-GAN phase step by step with
every draw shared, the JAX side's curve against the port's and each
against its own perturbed twin (the rounding envelope), in float32 or,
with ``--dtype float64``, in float64 on both sides; ``--elementwise``
measures the step's tanh, exp, log1p and BatchNorm variance on its real
activations against float64 (``elementwise_audit``).

The ``slow``-marked tests run the command as typed at a small budget and
the ``--fixed-physics`` recipe at one where its schedules have annealed.
"""

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen.normalization import _compute_stats

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.data.dataset import ThzDataset
from pigan_thz_torch.data.dataset import gather_batch as t_gather_batch
from pigan_thz_torch.interop import (
    _flat,
    _params_from_flax,
    forward_state_to_flax,
    load_forward_state_,
    load_pigan_state_,
)
from pigan_thz_torch.models import build_forward_model as t_build_forward_model
from pigan_thz_torch.models import build_trio as t_build_trio
from pigan_thz_torch.models.blocks import FlaxBatchNorm1d, frozen_batch_stats
from pigan_thz_torch.ops.metrics import r2_score as t_r2_score
from pigan_thz_torch.train.state import flat_layout
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
from pigan_thz_tpu.data.dataset import gather_batch as j_gather_batch
from pigan_thz_tpu.models import build_trio as j_build_trio
from pigan_thz_tpu.train.schedules import cosine_schedule as j_cosine_schedule
from pigan_thz_tpu.train.schedules import step_schedule as j_step_schedule
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


def _datasets(jc, tc):
    """One dataset in both packages: the port's synthetic samples, normalised
    by the JAX package, then carried across as they are."""
    raw = synthetic_dataset(tc.data, device="cpu")
    jds = j_build_dataset(raw.spectra.numpy(), raw.params.numpy(), raw.metrics.numpy(),
                          jc.data)
    return jds, ThzDataset(*(torch.from_numpy(np.array(x, np.float32)) for x in jds))


def port_pigan_state(tc, gtx, dtx, jps, f_params):
    """A port ``PiGanState`` holding the JAX state ``jps`` (G, D, Adam's
    moments, both counts at 0) and F's flax ``f_params``."""
    tg, td, tf = t_build_trio(tc, device="cpu")
    tps = t_init_pigan_state(tg, td, tf, gtx, dtx, 0, device="cpu")
    ga, da = jps.g_opt[1][0], jps.d_opt[1][0]
    return load_pigan_state_(tps, {
        "g": {"params": _np32(jps.g.params), "batch_stats": _np32(jps.g.extra["batch_stats"])},
        "d": {"params": _np32(jps.d.params)}, "f": {"params": f_params},
        "g_mu": _np32(ga.mu), "g_nu": _np32(ga.nu), "g_count": 0,
        "d_mu": _np32(da.mu), "d_nu": _np32(da.nu), "d_count": 0, "step": 0})


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
    jds, tds = _datasets(jc, tc)
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
    tps = port_pigan_state(tc, gtx, dtx, jps, _np32(jfs.f.params) if shared_f
                           else forward_state_to_flax(tfs)["params"])
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


# ---------------------------------------------------------------------------
# The step-by-step audit: both sides in lockstep with every draw shared
# ---------------------------------------------------------------------------

GAUGE = ("MLPBlock_0/Dense_0/bias", "MLPBlock_1/Dense_0/bias")


def _ravel(tree) -> np.ndarray:
    return np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in jax.tree.leaves(tree)])


def _gauge_mask(tree) -> np.ndarray:
    """False on G's two pre-BatchNorm Dense biases in ``_ravel(tree)``'s
    order: their true gradient is zero, so each side walks them on its own
    rounding noise (a gauge direction that no train-mode output sees)."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        out.append(np.full(np.size(leaf), name not in GAUGE))
    return np.concatenate(out)


def _jax_order(tree, module) -> np.ndarray:
    """The permutation that takes ``module``'s flat buffer into
    ``_ravel(tree)``'s order (``tree`` the module's flax params)."""
    leaves, treedef = jax.tree.flatten(tree)
    marks, pos = [], 0
    for leaf in leaves:
        marks.append(np.arange(pos, pos + np.size(leaf), dtype=np.float64).reshape(np.shape(leaf)))
        pos += np.size(leaf)
    where = _flat(_params_from_flax(jax.tree.unflatten(treedef, marks), module), module)
    return np.argsort(where.numpy().astype(np.int64))


def _bn_stats(module) -> np.ndarray:
    """G's BatchNorm running statistics in ``_ravel(batch_stats)``'s order."""
    return np.concatenate([np.ravel(b.detach().double().numpy())
                           for m in module.modules() if isinstance(m, FlaxBatchNorm1d)
                           for b in (m.running_mean, m.running_var)])


class _JaxSide:
    """The JAX package's XLA step, jitted, one step a call."""

    def __init__(self, step, state, ds, generator):
        self.step, self.state, self.ds = jax.jit(step), state, ds
        self.g_apply = jax.jit(lambda v, x: generator.apply(v, x, train=False))

    def __call__(self, idx):
        self.state, m = self.step(self.state, j_gather_batch(self.ds, jnp.asarray(idx)), 1.0)
        self.recon = float(m["recon_spec_loss"])

    def parts(self):
        st = self.state
        out = self.g_apply({"params": st.g.params, **st.g.extra}, self.ds.spectra)
        return (_ravel(st.g.params), _ravel(st.d.params), _ravel(st.g.extra["batch_stats"]),
                np.asarray(out, np.float64).ravel())


class _PortSide:
    """The port's eager step, one step a call."""

    def __init__(self, step, state, ds, order_g, order_d):
        self.step, self.state, self.ds = step, state, ds
        self.order_g, self.order_d = order_g, order_d

    def __call__(self, idx):
        self.state, m = self.step(self.state, t_gather_batch(self.ds, torch.as_tensor(idx)), 1.0)
        self.recon = float(m["recon_spec_loss"])

    def parts(self):
        st = self.state
        with torch.no_grad():
            out = st.g.eval()(self.ds.spectra)
        return (st.g_params.double().numpy()[self.order_g],
                st.d_params.double().numpy()[self.order_d], _bn_stats(st.g),
                out.double().numpy().ravel())


def _port_to_float64_(tps, tds):
    """The port's state and dataset in float64: G's and D's flat buffers
    (the parameters rebound as views), their Adam moments, the BatchNorm
    statistics and F."""
    for key in ("g", "d"):
        module, flat = getattr(tps, key), getattr(tps, f"{key}_params").double()
        with torch.no_grad():
            for (_, off, shape), p in zip(flat_layout(module), module.parameters()):
                p.data = flat[off: off + p.numel()].view(shape)
            for buf in module.buffers():
                if buf.is_floating_point():
                    buf.data = buf.data.double()
        setattr(tps, f"{key}_params", flat)
        opt = getattr(tps, f"{key}_opt")
        opt.m, opt.v = opt.m.double(), opt.v.double()
    tps.f.double()
    return ThzDataset(*(x.double() for x in tds))


def _flax_fast_variance(self, x):
    """``FlaxBatchNorm1d``'s train-mode forward with flax 0.12's statistics
    (``use_fast_variance``: E[x²] − E[x]² summed in float32), the
    normalisation and running-statistics update unchanged: the audit's
    ``flax_bn`` variant of the port."""
    if not self.training:
        return _FLAX_BN_FORWARD(self, x)
    mean, sq = x.mean(dim=0), (x * x).mean(dim=0)
    var = torch.clamp(sq - mean * mean, min=0.0)
    with torch.no_grad():
        keep = 1.0 - self.momentum
        self.running_mean.mul_(keep).add_(self.momentum * mean)
        self.running_var.mul_(keep).add_(self.momentum * var)
    return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


_FLAX_BN_FORWARD = FlaxBatchNorm1d._forward
PORT_VARIANTS = {"flax_bn": (FlaxBatchNorm1d, "_forward", _flax_fast_variance)}


def _rel(a, b, mask=None) -> float:
    if mask is not None:
        a, b = a[mask], b[mask]
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def trajectory_audit(num_samples: int = 1000, steps: int = 1500, forward_epochs: int = 100,
                     epochs: int = 100, seed: int = 0, perturb: float = 1e-7,
                     compute_dtype: str = "float32", variants: tuple = (),
                     every: int = 1) -> dict:
    """The PI-GAN phase as typed (F's input detached, BCE), both sides step
    by step in lockstep from one state with every draw shared: the JAX side
    is ``make_pigan_step`` jitted over ``gather_batch`` of the shared
    indices, the port's its eager step; F is the JAX side's, pretrained at
    dropout 0, and the baseline G and D draw nothing.  Four trajectories run:
    J (JAX), J' (JAX with G's initial weights scaled by 1 + ``perturb``),
    P (port), P' (port, the same perturbation), and one port trajectory per
    name in ``variants`` (``PORT_VARIANTS``: the port with one numerical
    choice made as the JAX side makes it).  Every ``every`` steps each pair
    records the relative parameter distance of G (the gauge leaves left
    out) and of D, the relative distance of G's BatchNorm running
    statistics and of G's eval-mode output over the training set (what
    the param R² reads), and the gap in the step's recon_spec_loss.  J-J'
    and P-P' are the rounding envelope: float32 chaos grown from
    ``perturb``.

    ``compute_dtype`` "float64" runs both sides in float64 (the caller has
    enabled ``jax_enable_x64`` and made torch's default dtype float64): the
    JAX package's modules with ``dtype=float64`` (its config takes float32
    and bfloat16 only), the states cast, and the port's optimisers reading
    the learning rates the JAX side's optax applies (its schedules compute
    in float32 at its int32 counts, even under x64).  The horizon of the
    schedules is ``epochs`` (D halves its rate every ``int(epochs / 4)``
    epochs)."""
    f64 = compute_dtype == "float64"
    jc, tc = _configs(num_samples, forward_epochs, epochs, "float32", dropout_rate=0.0)
    jds, tds = _datasets(jc, tc)
    b = jc.train.batch_size
    spe = num_samples // b
    keys = jax.random.split(jax.random.PRNGKey(seed + 100), forward_epochs + epochs)
    idx = np.concatenate([np.asarray(j_epoch_indices(k, num_samples, b))
                          for k in keys[forward_epochs:]])[:steps]

    g, d, f = j_build_trio(jc)
    g_tx, d_tx, f_tx = j_make_optimizers(jc, spe)
    jfs = j_init_forward_state(f, f_tx, jax.random.PRNGKey(seed))
    fepoch = j_make_epoch_fn(j_make_forward_step(f, f_tx), b)
    for e in range(forward_epochs):
        jfs, _ = fepoch(jfs, jds, keys[e])
    jps = j_init_pigan_state(g, d, f, g_tx, d_tx, jax.random.PRNGKey(seed + 1),
                             forward_variables=jfs.f.variables)
    jset = JSettings.from_config(jc, detach_forward=True)
    tset = TSettings.from_config(tc, detach_forward=True)
    gtx, dtx, _ = t_make_optimizers(tc, spe)
    if f64:
        jps = jax.tree.map(lambda a: a.astype(jnp.float64)
                           if jnp.issubdtype(a.dtype, jnp.floating) else a, jps)
        jds = jax.tree.map(lambda a: a.astype(jnp.float64), jds)
        # at the int32 counts optax keeps: its schedules then compute in float32
        count = jnp.arange(steps + 1, dtype=jnp.int32)
        g_lr = np.asarray(j_cosine_schedule(jc.train.lr_g, epochs, spe)(count), np.float64)
        d_lr = np.asarray(j_step_schedule(jc.train.lr_d, epochs, spe)(count), np.float64)
        gtx = dataclasses.replace(gtx, schedule=lambda c: torch.tensor(g_lr[int(c)]))
        dtx = dataclasses.replace(dtx, schedule=lambda c: torch.tensor(d_lr[int(c)]))

    def scaled(st):
        return st.replace(g=st.g.replace(params=jax.tree.map(lambda a: a * (1.0 + perturb),
                                                               st.g.params)))

    def port_state(perturbed: bool):
        src = scaled(jps) if perturbed and not f64 else jps
        tps = port_pigan_state(tc, gtx, dtx, src, _np32(jfs.f.params))
        ds = tds
        if f64:
            ds = _port_to_float64_(tps, tds)
            if perturbed:
                tps.g_params.mul_(1.0 + perturb)
        return tps, ds

    if f64:
        # the config takes float32 | bfloat16; the flax modules take float64
        g, d, f = (m.clone(dtype=jnp.float64) for m in (g, d, f))
    jstep = j_make_pigan_step(g, d, f, g_tx, d_tx, jset, jds.param_lo, jds.param_hi)
    order_g = _jax_order(jps.g.params, port_state(False)[0].g)
    order_d = _jax_order(jps.d.params, port_state(False)[0].d)
    mask = _gauge_mask(jps.g.params)
    runs = {"J": _JaxSide(jstep, jps, jds, g), "J'": _JaxSide(jstep, scaled(jps), jds, g)}
    for name, perturbed in (("P", False), ("P'", True)):
        tps, ds = port_state(perturbed)
        runs[name] = _PortSide(t_make_pigan_step(gtx, dtx, tset, ds.param_lo, ds.param_hi),
                               tps, ds, order_g, order_d)
    pairs = [("J", "J'"), ("P", "P'"), ("J", "P"), ("J'", "P'")]
    for v in variants:
        tps, ds = port_state(False)
        runs[v] = _PortSide(t_make_pigan_step(gtx, dtx, tset, ds.param_lo, ds.param_hi),
                            tps, ds, order_g, order_d)
        pairs.append(("J", v))
    curves = {f"{a}-{b}": {"g": [], "d": [], "bn": [], "out": [], "recon": []}
              for a, b in pairs}
    recon = {k: [] for k in runs}
    recorded = []
    t0 = time.perf_counter()
    for t in range(steps):
        for name, run in runs.items():
            if name in variants:
                cls, attr, fn = PORT_VARIANTS[name]
                setattr(cls, attr, fn)
                try:
                    run(idx[t])
                finally:
                    setattr(cls, attr, _FLAX_BN_FORWARD)
            else:
                run(idx[t])
            recon[name].append(run.recon)
        if (t + 1) % every and t + 1 != steps:
            continue
        recorded.append(t + 1)
        parts = {k: r.parts() for k, r in runs.items()}
        for a, b_ in pairs:
            (ga_, da_, sa, oa), (gb, db, sb, ob) = parts[a], parts[b_]
            c = curves[f"{a}-{b_}"]
            c["g"].append(_rel(ga_, gb, mask))
            c["d"].append(_rel(da_, db))
            c["bn"].append(_rel(sa, sb))
            c["out"].append(_rel(oa, ob))
            c["recon"].append(abs(runs[a].recon - runs[b_].recon))
    # the learning rates each side reads at every count of the window
    counts = np.arange(steps + 1)
    lr_gap = {k: float(np.max(np.abs(
        np.asarray(jsched(jnp.asarray(counts, jnp.int32)), np.float64)
        - np.array([float(tsched(int(c))) for c in counts]))))
        for k, jsched, tsched in (("g", j_cosine_schedule(jc.train.lr_g, epochs, spe),
                                   gtx.schedule),
                                  ("d", j_step_schedule(jc.train.lr_d, epochs, spe),
                                   dtx.schedule))}
    return {"num_samples": num_samples, "steps": steps, "epochs": epochs,
            "steps_per_epoch": spe, "seed": seed, "perturb": perturb, "lr_max_abs_gap": lr_gap,
            "compute_dtype": compute_dtype, "variants": list(variants),
            "d_schedule_boundaries": [k * int(epochs * 0.25) * spe for k in range(1, 4)],
            "recorded_steps": recorded, "curves": curves, "recon": recon,
            "wall_s": time.perf_counter() - t0}


def summarize_audit(out: dict, at=(1, 2, 5, 10, 20, 50, 100, 200, 375, 376, 500, 750, 751,
                                   1000, 1125, 1126, 1500)) -> dict:
    """The audit's curves at a few steps, and each pair's geometric-mean
    ratio to the J-J' envelope over windows of steps."""
    steps = out["recorded_steps"]
    pos = {s: i for i, s in enumerate(steps)}
    picks = [s for s in at if s in pos]
    table = {pair: {q: [c[q][pos[s]] for s in picks] for q in c}
             for pair, c in out["curves"].items()}
    env = out["curves"]["J-J'"]
    ratios = {}
    edges = [1, 11, 101, 376, 751, 1126, steps[-1] + 1]
    for pair, c in out["curves"].items():
        if pair == "J-J'":
            continue
        row = {}
        for lo, hi in zip(edges[:-1], edges[1:]):
            ix = [pos[s] for s in steps if lo <= s < hi]
            if not ix:
                continue
            for q in ("g", "d", "out"):
                r = np.log10(np.maximum(np.array(c[q])[ix], 1e-300)
                             / np.maximum(np.array(env[q])[ix], 1e-300))
                row[f"{q}[{lo},{hi})"] = float(10 ** r.mean())
        ratios[pair] = row
    return {k: v for k, v in out.items() if k not in ("curves", "recon", "recorded_steps")} | {
        "at_steps": picks, "curves_at": table, "ratio_to_J-J'": ratios}


def _ulp_errors(approx: np.ndarray, exact: np.ndarray) -> dict:
    """``approx`` (float32) against ``exact`` (float64) in float32 ulps of the
    exact value: the mean signed error (a bias) with its standard error, the
    mean and the largest absolute error."""
    ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    e = (approx.astype(np.float64) - exact) / ulp
    return {"mean_ulp": float(e.mean()), "stderr_ulp": float(e.std() / np.sqrt(e.size)),
            "mean_abs_ulp": float(np.abs(e).mean()), "max_abs_ulp": float(np.abs(e).max())}


def elementwise_audit(num_samples: int = 1000, steps: int = 300, seed: int = 0) -> dict:
    """The step's elementwise functions on its real activations, XLA CPU
    (jitted ``jnp``) and torch against float64: tanh at G's head, and the
    BCE's exp(-|x|), log1p and softplus term on D's logits; and G's
    BatchNorm batch variance as flax computes it (``_compute_stats``, the
    one-pass float32 form) and as the port does (float64 sums).  The
    activations are the port's G and D from the JAX package's
    initialisation after ``steps`` eager steps as typed (F from its
    initialisation), over every batch of one epoch."""
    jc, tc = _configs(num_samples, 1, 100, "float32")
    jds, tds = _datasets(jc, tc)
    b = jc.train.batch_size
    spe = num_samples // b
    g, d, f = j_build_trio(jc)
    g_tx, d_tx, _ = j_make_optimizers(jc, spe)
    jps = j_init_pigan_state(g, d, f, g_tx, d_tx, jax.random.PRNGKey(seed + 1))
    gtx, dtx, _ = t_make_optimizers(tc, spe)
    tps = port_pigan_state(tc, gtx, dtx, jps, _np32(jps.f.params))
    step = t_make_pigan_step(gtx, dtx, TSettings.from_config(tc, detach_forward=True),
                             tds.param_lo, tds.param_hi)
    keys = jax.random.split(jax.random.PRNGKey(seed + 100), steps // spe + 2)
    idx = np.concatenate([np.asarray(j_epoch_indices(k, num_samples, b)) for k in keys])
    for t in range(steps):
        tps, _ = step(tps, t_gather_batch(tds, torch.as_tensor(idx[t])), 1.0)
    heads, logits, pre_bn = [], [], []
    bns = [i for i, m in enumerate(tps.g.main) if isinstance(m, FlaxBatchNorm1d)]
    with torch.no_grad(), frozen_batch_stats(tps.g):
        for t in range(steps, steps + spe):
            spectra, params = tds.spectra[idx[t]], tds.params[idx[t]]
            pre_bn += [tps.g.train().main[:i](spectra) for i in bns]
            z = tps.g.main[:-1](spectra)
            fake = z.tanh() * 0.5 * (tds.param_hi - tds.param_lo) + 0.5 * (
                tds.param_hi + tds.param_lo)
            heads.append(z.numpy())
            logits.append(tps.d(torch.cat([spectra, spectra]), torch.cat([params, fake])).numpy())
    z, x = np.concatenate(heads).ravel(), np.concatenate(logits).ravel()
    xa = -np.abs(x)
    e = np.exp(xa.astype(np.float32))
    out = {"num_values": {"tanh": int(z.size), "bce": int(x.size)}}
    fns = {
        "tanh": (z, jnp.tanh, torch.tanh, np.tanh),
        "exp(-|x|)": (xa, jnp.exp, torch.exp, np.exp),
        "log1p": (e, jnp.log1p, torch.log1p, np.log1p),
        "softplus(-|x|)": (xa, lambda a: jnp.log1p(jnp.exp(a)),
                           lambda a: torch.log1p(torch.exp(a)),
                           lambda a: np.log1p(np.exp(a))),
    }
    for name, (v, jf, tf_, nf) in fns.items():
        exact = nf(v.astype(np.float64))
        out[name] = {"xla_cpu": _ulp_errors(np.asarray(jax.jit(jf)(jnp.asarray(v))), exact),
                     "torch": _ulp_errors(tf_(torch.from_numpy(v)).numpy(), exact)}
    # G's BatchNorm batch variance: flax's one-pass float32 statistics against
    # the port's float64 sums, each error relative to var + eps (what the
    # normalisation divides by); cancellation grows with mean² / var
    flax_stats = jax.jit(lambda a: _compute_stats(a, (0,), None)[1])
    errs = {"flax_float32": [], "port_float64_sums": []}
    ratio = []
    for x in pre_bn:
        xd = x.double()
        exact = ((xd - xd.mean(0)) ** 2).mean(0).numpy()
        ports = torch.clamp((xd * xd).mean(0) - xd.mean(0) ** 2, min=0.0).float().numpy()
        flax = np.asarray(flax_stats(jnp.asarray(x.numpy())))
        for key, v in (("flax_float32", flax), ("port_float64_sums", ports)):
            errs[key].append((v.astype(np.float64) - exact) / (exact + 1e-5))
        ratio.append(xd.mean(0).numpy() ** 2 / np.maximum(exact, 1e-30))
    out["batchnorm_var"] = {"median_mean2_over_var": float(np.median(np.concatenate(ratio)))}
    for key, e in errs.items():
        e = np.concatenate(e)
        out["batchnorm_var"][key] = {
            "mean_rel": float(e.mean()), "stderr_rel": float(e.std() / np.sqrt(e.size)),
            "mean_abs_rel": float(np.abs(e).mean()), "max_abs_rel": float(np.abs(e).max())}
    return out


def summarize_pairs(results: list) -> dict:
    """Paired seeds of ``run_both``: per seed each side's param R², final
    recon_spec_loss and the mean of its last 10 epochs; for each quantity
    how many seeds have the port's the higher, the two-sided sign-test
    probability, and the paired mean gap (port - JAX) with its 95 %
    Student-t interval."""
    from scipy import stats

    rows, out = [], {}
    for r in sorted(results, key=lambda r: r["seed"]):
        row = {"seed": r["seed"]}
        for side, key in (("jax_xla", "jax"), ("port_eager", "port")):
            v = r[side]
            row[key] = {"param_r2": v["param_r2"], "recon_final": v["recon_spec_loss"],
                        "recon_last10": float(np.mean(v["recon_by_epoch"][-10:]))}
        rows.append(row)
    n = len(rows)
    for q in ("param_r2", "recon_final", "recon_last10"):
        gap = np.array([row["port"][q] - row["jax"][q] for row in rows])
        higher = int((gap > 0).sum())
        ties = int((gap == 0).sum())
        p = float(stats.binomtest(higher, n - ties, 0.5).pvalue) if n > ties else 1.0
        half = float(stats.t.ppf(0.975, n - 1) * gap.std(ddof=1) / np.sqrt(n)) if n > 1 else None
        out[q] = {"port_higher": higher, "of": n, "sign_test_p": p, "mean_gap": float(gap.mean()),
                  "ci95": None if half is None else [float(gap.mean()) - half,
                                                     float(gap.mean()) + half],
                  "jax_mean": float(np.mean([row["jax"][q] for row in rows])),
                  "port_mean": float(np.mean([row["port"][q] for row in rows]))}
    return {"seeds": rows, "paired": out}


@pytest.mark.slow
def test_fixed_physics_param_r2_within_the_seed_spread():
    """The main path's acceptance: ``train --mode full --fixed-physics`` on
    both sides from the same initial weights and shuffles, each pretraining
    its own F (its own dropout masks), at 1000 samples and 200 + 200
    epochs: the schedules anneal over the run (G's cosine to 0.01x, D's
    rate halved three times) and param R² sits at ~0.967.  The port's
    final param R² lies within the JAX package's seed spread (0.002,
    RESULTS.md:939) of the JAX XLA path's.  Measured on the CPU: seed 0
    JAX 0.96730 / port 0.96755, a gap of +0.00025; seeds 1 and 2 gaps of
    -0.00060 and -0.00030; at 100 + 100 seed 0's gap was -0.00230, outside
    the spread, R² still climbing (0.9596).  About 5 min."""
    out = run_both(num_samples=1000, forward_epochs=200, epochs=200, detach_forward=False)
    j, t = out["jax_xla"]["param_r2"], out["port_eager"]["param_r2"]
    assert np.isfinite([j, t]).all(), out
    assert j > 0.95, out
    assert abs(j - t) < 0.002, (j, t)


@pytest.mark.slow
def test_train_as_typed_matches_the_jax_xla_path():
    """A small budget of the comparison (256 samples, 10 + 10 epochs): both
    sides train and end near each other.  Each side pretrains its own F with
    its own dropout masks, which is where the two part at this budget: over
    seeds 0-7 the R² gap reached 0.078 and the recon gap 0.72 % (the JAX
    side against its own 1 + 1e-7 twin: 0.008 and 1e-6), so R² keeps 0.1
    and recon is held to 2 % (PERF.md, section 6)."""
    out = run_both(num_samples=256, forward_epochs=10, epochs=10)
    j, t = out["jax_xla"], out["port_eager"]
    assert all(np.isfinite([j["param_r2"], t["param_r2"], j["recon_spec_loss"],
                            t["recon_spec_loss"]]))
    assert abs(j["param_r2"] - t["param_r2"]) < 0.1, out
    assert abs(j["recon_spec_loss"] - t["recon_spec_loss"]) < 0.02 * j["recon_spec_loss"], out


@pytest.mark.slow
def test_train_as_typed_with_every_draw_shared_stays_on_the_envelope():
    """The same budget with every draw shared (F pretrained without dropout,
    the JAX side's F in both PI-GAN phases): the two differ only in
    arithmetic and end as close as the JAX side ends to its own twin from
    G's weights scaled by 1 + 1e-7.  Over seeds 0-7 the R² gap was at most
    0.0034 (the twin 0.0039) and the recon gap 7e-7 relative."""
    out = run_both(num_samples=256, forward_epochs=10, epochs=10, dropout_rate=0.0,
                   shared_f=True)
    j, t = out["jax_xla"], out["port_eager"]
    assert abs(j["param_r2"] - t["param_r2"]) < 0.01, out
    assert abs(j["recon_spec_loss"] - t["recon_spec_loss"]) < 1e-5 * j["recon_spec_loss"], out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
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
    ap.add_argument("--fixed-physics", action="store_true",
                    help="train --fixed-physics: the gradient flows through F")
    ap.add_argument("--threads", type=int, default=4, help="torch's CPU threads")
    ap.add_argument("--audit", action="store_true",
                    help="the step-by-step audit (trajectory_audit) in place of the run")
    ap.add_argument("--steps", type=int, default=1500, help="--audit: PI-GAN steps")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32",
                    help="--audit: both sides' compute dtype")
    ap.add_argument("--variants", default="",
                    help="--audit: comma-separated PORT_VARIANTS run beside the port")
    ap.add_argument("--every", type=int, default=1, help="--audit: record every N steps")
    ap.add_argument("--curves", default=None, help="--audit: write the whole curves here")
    ap.add_argument("--elementwise", action="store_true",
                    help="tanh and the BCE's exp / log1p on the step's activations "
                         "(elementwise_audit) in place of the run")
    ap.add_argument("--seeds", default=None,
                    help="paired seeds, e.g. 0-7: run each in a process of its own "
                         "(--jobs at once) into --out, then print summarize_pairs")
    ap.add_argument("--jobs", type=int, default=4, help="--seeds: processes at once")
    ap.add_argument("--out", default=None,
                    help="a run's JSON file; with --seeds the directory of seed<N>.json")
    ap.add_argument("--summarize", default=None,
                    help="print summarize_pairs of the seed*.json files in this directory")
    a = ap.parse_args()
    torch.set_num_threads(a.threads)
    if a.summarize:
        files = sorted(pathlib.Path(a.summarize).glob("seed*.json"))
        print(json.dumps(summarize_pairs([json.loads(f.read_text()) for f in files])))
        raise SystemExit(0)
    if a.seeds:
        lo, _, hi = a.seeds.partition("-")
        seeds = range(int(lo), int(hi or lo) + 1)
        out = pathlib.Path(a.out)
        out.mkdir(parents=True, exist_ok=True)
        skip = {"--seeds", "--jobs", "--out", "--seed"}
        argv, rest = [], iter(sys.argv[1:])
        for arg in rest:
            if arg in skip:
                next(rest)
            elif arg.split("=")[0] not in skip:
                argv.append(arg)
        pending = list(seeds)
        running = []
        while pending or running:
            while pending and len(running) < a.jobs:
                sd = pending.pop(0)
                running.append(subprocess.Popen(
                    [sys.executable, __file__, *argv, "--seed", str(sd),
                     "--out", str(out / f"seed{sd}.json")]))
            if running[0].wait():
                for proc in running[1:]:
                    proc.kill()
                raise SystemExit(f"a seed's run failed: {running[0].args}")
            running.pop(0)
        files = [out / f"seed{sd}.json" for sd in seeds]
        print(json.dumps(summarize_pairs([json.loads(f.read_text()) for f in files])))
        raise SystemExit(0)
    if a.elementwise:
        print(json.dumps(elementwise_audit(a.num_samples, a.steps, a.seed)))
    elif not a.audit:
        res = run_both(a.num_samples, a.forward_epochs, a.epochs, a.seed, a.port_seed,
                       dropout_rate=a.dropout_rate, perturb_g=a.perturb_g,
                       shared_f=a.shared_f, detach_forward=not a.fixed_physics)
        res["seed"] = a.seed
        if a.out:
            pathlib.Path(a.out).write_text(json.dumps(res))
        print(json.dumps(res))
    else:
        if a.dtype == "float64":
            jax.config.update("jax_enable_x64", True)
            torch.set_default_dtype(torch.float64)
        res = trajectory_audit(a.num_samples, a.steps, a.forward_epochs, a.epochs, a.seed,
                               a.perturb_g or (1e-14 if a.dtype == "float64" else 1e-7),
                               a.dtype, tuple(v for v in a.variants.split(",") if v),
                               a.every)
        if a.curves:
            with open(a.curves, "w") as fh:
                json.dump(res, fh)
        print(json.dumps(summarize_audit(res)))
