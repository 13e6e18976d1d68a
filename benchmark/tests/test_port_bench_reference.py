"""The frozen reference against the port at a tiny size on the CPU: the
models' forward passes, F's training step and the typed D-then-G step on
the port's eager paths, and a whole run's check on the kernels' plain
versions (what the card's kernels stand in for here)."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, inputs, program
from benchmark.reference import compare
from benchmark.reference import models as M
from benchmark.reference import steps as R

SEED = 2**33 + 17


def _port(cell):
    pc = program.port_config(cell["config"])
    from pigan_thz_torch.models.registry import build_trio

    return pc, build_trio(pc, device="cpu")


@pytest.mark.parametrize("name", ["base-design-8192", "optimized-design-8192"])
def test_forward_passes(tiny, name):
    cell = tiny(name)
    cfg = cell["config"]
    _, (g, d, f) = _port(cell)
    g_ops, f_ops = M.generator_layers(cfg), M.forward_layers(cfg)
    w_g = inputs.make_weights(M.param_layout(g_ops) + M.buffer_layout(g_ops), SEED, "cpu", "G",
                              trained_stats=True)
    w_f = inputs.make_weights(M.param_layout(f_ops), SEED, "cpu", "F")
    program.load_(g, w_g, g_ops)
    program.load_(f, w_f, f_ops)
    x = inputs.request_pool(cfg, 32, SEED, "cpu")
    # float32 in another order: a few 1e-6 of the outputs' RMS (the card's
    # kernels read up to 2e-5 against the reference at 8192 rows)
    with torch.no_grad():
        assert compare.answer_gap(g.eval()(x), M.run(g_ops, w_g, x)) < 2e-5
        pn = torch.tanh(torch.randn(32, 4, generator=torch.Generator().manual_seed(1)))
        spec, met = f.eval()(pn)
        ref = M.run(f_ops, w_f, pn)
        assert compare.answer_gap(torch.cat([spec, met], 1), ref) < 2e-5
    if cfg["discriminator"]["name"] == "mlp":
        d_ops = M.discriminator_layers(cfg)
        w_d = inputs.make_weights(M.param_layout(d_ops), SEED, "cpu", "D")
        program.load_(d, w_d, d_ops)
        par = 2.2 + 0.6 * torch.rand(32, 4, generator=torch.Generator().manual_seed(2))
        with torch.no_grad():
            assert compare.answer_gap(d(x, par), M.run(d_ops, w_d, torch.cat([x, par], 1))) < 2e-5


def test_tf32_rounding():
    # TF32 keeps 10 mantissa bits: ulp 2**-10 at 1, 2**-9 at 3; ties go away from 0
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0 - 2**-11, -3.0 - 2**-10])
    assert M.to_tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, -3.0, -3.0 - 2**-9]


def test_dropout_hash_is_the_programs():
    from pigan_thz_torch.ops.forward_train import dropout_scale

    for seed, layer in ((0, 0), (12345, 3), (2**31 - 2, 4)):
        assert torch.equal(R.dropout_factors(seed, layer, (16, 40), 0.2, "cpu"),
                           dropout_scale(seed, layer, 16, 40, 0.2, "cpu"))


def test_eager_steps(tiny):
    """An epoch of the port's eager F step and D-then-G step (the shadow
    replay's and the CPU's engine) against the reference, on drawn rows."""
    from pigan_thz_torch.train.state import init_forward_state, init_pigan_state, make_optimizers
    from pigan_thz_torch.train.steps import (StepSettings, make_forward_step,
                                             make_multi_epoch_fn, make_pigan_step)

    cell = tiny("base-train-full")
    cfg, tc = cell["config"], cell["config"]["train"]
    pc, (g, d, f) = _port(cell)
    b = cfg["batch_size"]
    spe = cfg["num_samples"] // b
    ts = inputs.training_set(cfg, SEED, "cpu")
    ds = program.dataset(pc, ts, "cpu")
    f_ops, g_ops, d_ops = M.forward_layers(cfg), M.generator_layers(cfg), M.discriminator_layers(cfg)
    w_f = inputs.make_weights(M.param_layout(f_ops), SEED, "cpu", "F")
    w_g = inputs.make_weights(M.param_layout(g_ops) + M.buffer_layout(g_ops), SEED, "cpu", "G")
    w_d = inputs.make_weights(M.param_layout(d_ops), SEED, "cpu", "D")
    perm = torch.randperm(cfg["num_samples"], generator=torch.Generator().manual_seed(3))
    rows = perm[:spe * b].view(1, spe, b)
    seeds = torch.arange(77, 77 + spe)

    g_tx, d_tx, f_tx = make_optimizers(pc, spe)
    fs = init_forward_state(f, f_tx, 0, device="cpu")
    program.load_(fs.f, w_f, f_ops)
    fwd = make_multi_epoch_fn(make_forward_step(f_tx), b)
    fs, m = fwd(fs, ds, torch.ones(1), rows, seeds)
    ref_f = R.ForwardTrainer(cfg, w_f, decay_steps=tc["forward_epochs"] * spe)
    pn, mn = M.normalize_params(ts["params"], cfg), M.normalize_metrics(ts["metrics"])
    for k in range(spe):
        r = rows[0, k]
        ref_f.step(ts["spectra"][r], pn[r], mn[r], int(seeds[k]))
    assert compare.loss_gap(float(m["loss"][0]), ref_f.losses) < 1e-5
    # the change by the check's own measure (leaves nought to rounding left
    # out): over 8 steps the eager F reads ~1e-4 at the median leaf, TF32
    # products ~1e-3
    got = {n: t - w_f[n] for n, t in program.leaves(fs.f, fs.params, f_ops).items()}
    ref = {n: t.detach() - w_f[n] for n, t in ref_f.params.items()}
    moving = compare.moving_leaves(ref_f.opt.first_grad)
    assert compare.median_leaf_gap(got, ref, moving) < 3e-4

    settings = StepSettings.from_config(pc, detach_forward=True)
    ps = init_pigan_state(g, d, fs.f, g_tx, d_tx, 0, device="cpu")
    program.load_(ps.g, w_g, g_ops)
    program.load_(ps.d, w_d, d_ops)
    step = make_multi_epoch_fn(make_pigan_step(g_tx, d_tx, settings, ds.param_lo, ds.param_hi), b)
    rows = perm.flip(0)[:spe * b].view(1, spe, b)
    ps, m = step(ps, ds, torch.ones(1), rows, torch.zeros(spe, dtype=torch.int64))
    # both sides' GAN steps against the same frozen F: the port's
    ref_g = R.GanTrainer(cfg, w_g, w_d, program.leaves(fs.f, fs.params, f_ops),
                         g_decay_steps=tc["gan_epochs"] * spe,
                         d_every=max(1, int(tc["gan_epochs"] * 0.25) * spe))
    for k in range(spe):
        r = rows[0, k]
        ref_g.step(ts["spectra"][r], ts["params"][r], mn[r])
    assert compare.loss_gap(float(m["d_loss"][0]), ref_g.d_losses) < 1e-5
    assert compare.loss_gap(float(m["g_loss"][0]), ref_g.g_losses) < 1e-5
    got = {n: t for n, t in program.leaves(ps.g, ps.g_opt.m, g_ops).items()}
    assert compare.median_leaf_gap(got, ref_g.g_opt.m) < 1e-4


@pytest.mark.parametrize("name", ["base-train-full", "base-ensemble4", "base-design-8192",
                                  "optimized-design-8192"])
def test_a_runs_check_passes(tiny, name):
    """Set-up, a short window and the check of a cell at a tiny size: the
    program's numbers are within the cell's limits."""
    cell = tiny(name)
    drv = harness.driver(cell["traffic"])(cell["config"], cell["traffic"], SEED, "cpu")
    drv.setup()
    record = drv.window(0.2, False)
    drv.release()
    correct, rows = compare.verdict(drv.check(), cell["limits"])
    assert correct, rows
    assert record["window_s"] >= 0.2
