"""The port's losses, schedules, optimiser, plateau controller and batching
against the JAX package, on the same numpy inputs.

Losses and schedules are the same float32 formulas on both sides: they
agree to a few ulp (rtol 1e-6).  Three clip + Adam steps are checked
element for element (atol 1e-7 on updates of size ~1e-3: the two divide by
the bias corrections in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pigan_thz_torch import default_config
from pigan_thz_torch.data import epoch_indices, gather_batch, split_dataset, synthetic_dataset
from pigan_thz_torch.ops import losses as tl
from pigan_thz_torch.train import schedules as ts
from pigan_thz_tpu.data.dataset import epoch_indices as j_epoch_indices
from pigan_thz_tpu.ops import losses as jl
from pigan_thz_tpu.train import schedules as js

torch.set_num_threads(1)

RTOL = 1e-6


def _pair(rng, *shape, lo=-2.0, hi=2.0):
    a = rng.uniform(lo, hi, shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["bce", "bce_logits", "mse", "mae", "gaussian_nll",
                                  "maxwell_smoothness_loss", "lc_approx_loss",
                                  "param_range_loss", "constraint_loss",
                                  "enhanced_constraint_loss", "physics_window_loss",
                                  "stability_loss", "cycle_consistency_loss",
                                  "intensive_forward_loss", "violation_rate"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(abs(hash(name)) % 2**32)
    (ja, ta), (jb, tb), (jc, tc), (jd, td) = (_pair(rng, 16, 250) for _ in range(4))
    (jp, tp), (jq, tq) = _pair(rng, 16, 4, lo=-0.3, hi=1.3), _pair(rng, 16, 4)
    (jm, tm) = _pair(rng, 16, 8, lo=0.0, hi=4.0)
    (jprob, tprob), (jt, tt) = _pair(rng, 16, 1, lo=0.0, hi=1.0), _pair(rng, 16, 1, lo=0.0, hi=1.0)
    (jv, tv) = _pair(rng, 16, 250, lo=0.1, hi=2.0)
    args = {
        "bce": ((jprob, jt), (tprob, tt)),
        "bce_logits": ((ja, jt), (ta, tt)),
        "mse": ((ja, jb), (ta, tb)),
        "mae": ((ja, jb), (ta, tb)),
        "gaussian_nll": ((ja, jv, jb), (ta, tv, tb)),
        "maxwell_smoothness_loss": ((ja,), (ta,)),
        "lc_approx_loss": ((jm[:, 0], jm[:, 1], jp), (tm[:, 0], tm[:, 1], tp)),
        "param_range_loss": ((jp,), (tp,)),
        "constraint_loss": ((jp,), (tp,)),
        "enhanced_constraint_loss": ((jp, ja), (tp, ta)),
        "physics_window_loss": ((ja, jb, jm), (ta, tb, tm)),
        "stability_loss": ((jp, jq), (tp, tq)),
        "cycle_consistency_loss": ((jp, jq), (tp, tq)),
        "intensive_forward_loss": ((ja, jb, jc, jd), (ta, tb, tc, td)),
        "violation_rate": ((jp,), (tp,)),
    }[name]
    want = getattr(jl, name)(*args[0])
    got = getattr(tl, name)(*args[1])
    if name == "enhanced_constraint_loss":
        _close(got.loss, want.loss)
        _close(got.violation_rate, want.violation_rate)
    else:
        _close(got, want)


def test_loss_gradients_match_jax():
    """The smoothness and L1 terms the forward step differentiates."""
    rng = np.random.default_rng(3)
    (ja, ta), (jb, tb) = _pair(rng, 8, 250), _pair(rng, 8, 250)
    ta.requires_grad_(True)

    def jf(x):
        return jl.maxwell_smoothness_loss(x) + 0.5 * jl.mae(x, jb) + jl.mse(x, jb)

    want = jax.grad(jf)(ja)
    (tl.maxwell_smoothness_loss(ta) + 0.5 * tl.mae(ta, tb) + tl.mse(ta, tb)).backward()
    _close(ta.grad, want, rtol=1e-5, atol=1e-9)


STEPS = [0, 1, 7, 14, 15, 16, 100, 374, 375, 376, 749, 750, 1499, 1500, 1501, 7499,
         7500, 9000]


@pytest.mark.parametrize("kind", ["cosine", "warmup_cosine", "step", "linear", "constant"])
@pytest.mark.parametrize("alpha", [0.0, 0.01])
def test_schedules_match_make_schedule(kind, alpha):
    want_fn = js.make_schedule(kind, 1e-3, 500, 15, schedule_alpha=alpha)
    got_fn = ts.make_schedule(kind, 1e-3, 500, 15, schedule_alpha=alpha)
    want = np.array([float(want_fn(s)) for s in STEPS])
    got = got_fn(torch.tensor(STEPS)).numpy()
    _close(got, want, rtol=2e-6, atol=1e-12)
    assert float(got_fn(STEPS[3])) == pytest.approx(float(want[3]), rel=2e-6, abs=1e-12)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown schedule"):
        ts.make_schedule("exotic", 1e-3, 1, 1)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("b1,schedule,wd", [(0.9, "cosine", 0.0), (0.5, "step", 0.0),
                                            (0.5, "cosine", 1e-2)])
def test_clip_adam_matches_build_optimizer(grad_scale, b1, schedule, wd):
    """Three steps of clip_by_global_norm -> Adam(W) -> schedule on random
    gradients, the last with an lr_scale, from one flat parameter vector."""
    rng = np.random.default_rng(int(grad_scale * 1000) + int(b1 * 10))
    p0 = rng.normal(size=1000).astype(np.float32)
    grads = [rng.normal(size=1000).astype(np.float32) * grad_scale for _ in range(3)]
    kw = dict(lr=2e-3, total_epochs=4, steps_per_epoch=2, schedule=schedule, b1=b1,
              grad_clip=1.0, weight_decay=wd)
    jtx = js.build_optimizer(**kw)
    ttx = ts.build_optimizer(**kw)
    jp, jst = jnp.asarray(p0), None
    jst = jtx.init(jp)
    tp = torch.from_numpy(p0.copy())
    tst = ttx.init(tp)
    for i, g in enumerate(grads):
        scale = 0.5 if i == 2 else None
        upd, jst = jtx.update(jnp.asarray(g), jst, jp)
        if scale is not None:
            upd = upd * scale
        jp = optax.apply_updates(jp, upd)
        ttx.update_(torch.from_numpy(g), tst, tp, scale)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-7)
    # moments to rounding of the clipped gradient (the global norm sums in
    # another order): |m| ~ 1e-2, |v| ~ 1e-4
    adam = jst[1][0]
    np.testing.assert_allclose(tst.m.numpy(), np.asarray(adam.mu), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tst.v.numpy(), np.asarray(adam.nu), rtol=1e-6, atol=1e-11)
    assert tst.count == int(adam.count) == 3


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("b1,schedule", [(0.9, "cosine"), (0.5, "step")])
def test_bf16_moments_match_scale_by_adam_bf16(grad_scale, b1, schedule):
    """``adam_state_dtype="bfloat16"``: four steps of clip -> Adam with the
    moments stored in bfloat16 (the JAX package's ``scale_by_adam_bf16``),
    the recurrence and the update in float32.  The stored moments are
    bfloat16 values on both sides, equal to rounding: a moment whose float32
    values differ by an ulp can round to neighbouring bfloat16 values (2^-8
    relative), which the parameters see at that size times lr."""
    rng = np.random.default_rng(int(grad_scale * 1000) + int(b1 * 10) + 7)
    p0 = rng.normal(size=1000).astype(np.float32)
    grads = [rng.normal(size=1000).astype(np.float32) * grad_scale for _ in range(4)]
    kw = dict(lr=2e-3, total_epochs=4, steps_per_epoch=2, schedule=schedule, b1=b1,
              grad_clip=1.0, adam_state_dtype="bfloat16")
    jtx, ttx = js.build_optimizer(**kw), ts.build_optimizer(**kw)
    jp = jnp.asarray(p0)
    jst = jtx.init(jp)
    tp = torch.from_numpy(p0.copy())
    tst = ttx.init(tp)
    for g in grads:
        upd, jst = jtx.update(jnp.asarray(g), jst, jp)
        jp = optax.apply_updates(jp, upd)
        ttx.update_(torch.from_numpy(g), tst, tp)
    adam = jst[1][0]
    assert adam.mu.dtype == jnp.bfloat16
    for got, want in ((tst.m, adam.mu), (tst.v, adam.nu)):
        want = np.asarray(want.astype(jnp.float32))
        # every stored value is a bfloat16 value
        assert torch.equal(got, got.to(torch.bfloat16).float())
        np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -7, atol=1e-30)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=2e-3 * 2 ** -6)
    assert tst.count == int(adam.count) == 4
    # the float32 optimiser does not round its moments
    plain = ts.build_optimizer(**{**kw, "adam_state_dtype": "float32"})
    st32 = plain.init(torch.from_numpy(p0.copy()))
    plain.update_(torch.from_numpy(grads[0]), st32, torch.from_numpy(p0.copy()))
    assert not torch.equal(st32.m, st32.m.to(torch.bfloat16).float())


def test_bf16_moments_raise_not_ported():
    """bfloat16 moments are ported (``ClipAdam.state_dtype``); what still
    raises is what the JAX package raises: weight decay with them, and an
    unknown dtype."""
    assert ts.build_optimizer(1e-3, 1, 1, adam_state_dtype="bfloat16").state_dtype == "bfloat16"
    with pytest.raises(ValueError, match="weight_decay"):
        ts.build_optimizer(1e-3, 1, 1, adam_state_dtype="bfloat16", weight_decay=1e-4)
    with pytest.raises(ValueError, match="float32 | bfloat16"):
        ts.build_optimizer(1e-3, 1, 1, adam_state_dtype="float16")


@pytest.mark.parametrize("kw", [{}, {"mode": "max", "threshold_mode": "abs", "cooldown": 3},
                                {"patience": 2, "factor": 0.1, "min_scale": 0.05,
                                 "base_lr": 1e-3}])
def test_plateau_matches_jax_value_for_value(kw):
    rng = np.random.default_rng(len(kw))
    metrics = np.concatenate([np.linspace(5, 1, 20), np.full(60, 1.0),
                              rng.uniform(0.5, 1.5, 40), [np.nan, 0.4, 0.4]])
    j, t = js.ReduceLROnPlateau(**kw), ts.ReduceLROnPlateau(**kw)
    for x in metrics:
        assert t.step(x) == j.step(x)
        assert t.state_dict() == j.state_dict()
    assert t.num_reductions > 0
    t2 = ts.ReduceLROnPlateau(**kw)
    t2.load_state_dict(j.state_dict())
    assert t2.state_dict() == j.state_dict()


@pytest.mark.parametrize("n,b", [(1000, 64), (128, 64), (10, 64), (100, 7), (64, 64)])
def test_epoch_indices_shapes_and_tiling(n, b):
    gen = torch.Generator().manual_seed(n)
    idx = epoch_indices(gen, n, b)
    jidx = np.asarray(js_epoch_indices(n, b))
    assert idx.shape == jidx.shape == (max(1, n // b), b)
    assert idx.dtype == torch.int64
    flat = idx.reshape(-1)
    if n >= b:
        # a permutation's prefix: distinct, the last n mod b left out
        assert flat.unique().numel() == flat.numel() == (n // b) * b
    else:
        # tiled: the permutation repeated, so every sample appears
        reps = -(-b // n)
        assert set(flat.tolist()) == set(range(n))
        assert torch.equal(flat, flat[:n].repeat(reps)[:b])
    assert int(flat.min()) >= 0 and int(flat.max()) < n


def js_epoch_indices(n, b):
    return j_epoch_indices(jax.random.PRNGKey(0), n, b)


def test_gather_batch_and_split():
    ds = synthetic_dataset(dataclasses.replace(default_config().data, num_samples=40),
                           device="cpu")
    idx = torch.tensor([3, 1, 39])
    batch = gather_batch(ds, idx)
    assert [tuple(t.shape) for t in batch] == [(3, 250), (3, 4), (3, 4), (3, 8), (3, 8)]
    assert torch.equal(batch[0][1], ds.spectra[1])
    tr, va = split_dataset(ds, 0.2, torch.Generator().manual_seed(1))
    assert (tr.num_samples, va.num_samples) == (32, 8)
    rows = torch.cat([tr.params, va.params])
    assert torch.equal(rows[rows[:, 0].argsort()], ds.params[ds.params[:, 0].argsort()])
    assert torch.equal(tr.param_lo, ds.param_lo) and torch.equal(va.metric_hi, ds.metric_hi)
