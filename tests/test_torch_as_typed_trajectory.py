"""``train --mode full`` as typed, step by step: the port's eager PI-GAN step
against the JAX package's XLA step with every draw shared.

The PI-GAN phase as typed (F's input detached, BCE, float32) at full width
(G 250-512-256-4, D 254-512-256-1, the baseline F), 256 samples, batch 64,
``train.num_epochs`` 5, so D's step schedule halves its rate every 4 steps
(first at the count 4, the fifth step).  Both sides start from one
JAX-initialised state and one frozen F and walk the same shuffles of one
JAX key; the baseline G and D have no dropout and the as-typed settings
draw no noise, so the two differ only in arithmetic.

Each of the first ``STEPS`` steps is held to one fixed bound per quantity
(no limit that grows with float32's own drift): the relative distance of
G's train-mode output on a fixed batch, of D's parameters, of G's
BatchNorm running means and of its running variances, and the step's
recon_spec_loss and d_loss.  The window is short because float32 chaos is
fast here: Adam turns a gradient at the rounding level into a step of the
full learning rate, so the JAX step against itself from G's weights
scaled by 1 + 1e-7 is already 1e-3 apart in G's output after one step and
1e-3 apart in d_loss by the ninth.  Over these six steps that twin stays
inside every bound (about half of each), the port too, and each planted
fault lands at least 10x above a bound.

Two differences of the watch list stay below the envelope over this window
and are not planted: torch's ``clip_grad_norm_`` rule (a factor
1 + 1e-6 / ‖g‖ on a clipped step, which Adam's normalisation cancels) and
G trained against the smoothed 0.9 (``PYTHONPATH=. python
tests/test_torch_as_typed_trajectory.py`` prints every fault's excess).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pigan_thz_torch.ops.losses as t_losses
import pigan_thz_torch.train.schedules as t_schedules
import pigan_thz_torch.train.state as t_state
from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.data.dataset import gather_batch as t_gather_batch
from pigan_thz_torch.models.blocks import FlaxBatchNorm1d, frozen_batch_stats
from pigan_thz_torch.train.steps import StepSettings as TSettings
from pigan_thz_torch.train.steps import make_pigan_step as t_make_pigan_step
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.data.dataset import epoch_indices as j_epoch_indices
from pigan_thz_tpu.data.dataset import gather_batch as j_gather_batch
from pigan_thz_tpu.models import build_trio as j_build_trio
from pigan_thz_tpu.train.state import init_pigan_state as j_init_pigan_state
from pigan_thz_tpu.train.state import make_optimizers as j_make_optimizers
from pigan_thz_tpu.train.steps import StepSettings as JSettings
from pigan_thz_tpu.train.steps import make_pigan_step as j_make_pigan_step
from test_torch_reference_run import (_bn_stats, _datasets, _jax_order, _np32, _ravel,
                                      port_pigan_state)

N, B, E = 256, 64, 5
SPE = N // B
STEPS = 6
# the fixed per-step bounds: relative distances, and the rows absolute
BOUNDS = {"g": 1e-2, "d": 4e-5, "bn_mean": 6e-4, "bn_var": 3e-4, "recon": 8e-4,
          "d_loss": 1.5e-5}


def _cfg(cfg):
    return cfg.replace(
        data=dataclasses.replace(cfg.data, num_samples=N),
        train=dataclasses.replace(cfg.train, batch_size=B, num_epochs=E))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


@pytest.fixture(scope="module")
def reference():
    """The JAX XLA step's trajectory (and its perturbed twin's), step by
    step, with what the port needs to start from the same state."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    jc, tc = _cfg(j_default_config()), _cfg(t_default_config())
    jds, tds = _datasets(jc, tc)
    keys = jax.random.split(jax.random.PRNGKey(7), E)
    idx = np.concatenate([np.asarray(j_epoch_indices(k, N, B)) for k in keys])[:STEPS]
    g, d, f = j_build_trio(jc)
    g_tx, d_tx, _ = j_make_optimizers(jc, SPE)
    jps = j_init_pigan_state(g, d, f, g_tx, d_tx, jax.random.PRNGKey(1))
    step = jax.jit(j_make_pigan_step(g, d, f, g_tx, d_tx, JSettings.from_config(jc),
                                     jds.param_lo, jds.param_hi))

    probe = jds.spectra[:B]
    g_train = jax.jit(lambda v: g.apply(v, probe, train=True, mutable=["batch_stats"])[0])

    def walk(st):
        out = []
        for t in range(STEPS):
            st, m = step(st, j_gather_batch(jds, jnp.asarray(idx[t])), 1.0)
            out.append((np.asarray(g_train({"params": st.g.params, **st.g.extra}),
                                   np.float64).ravel(),
                        _ravel(st.d.params), _ravel(st.g.extra["batch_stats"]),
                        float(m["recon_spec_loss"]), float(m["d_loss"])))
        return out

    start = jps
    twin = jps.replace(g=jps.g.replace(params=jax.tree.map(lambda a: a * (1.0 + 1e-7),
                                                           jps.g.params)))
    yield dict(tc=tc, tds=tds, idx=idx, start=start, jax=walk(start), twin=walk(twin))
    torch.set_num_threads(threads)


def _port_walk(ref) -> list:
    """The port's eager steps from the reference's start state."""
    tc, tds, st = ref["tc"], ref["tds"], ref["start"]
    gtx, dtx, _ = t_state.make_optimizers(tc, SPE)
    tps = port_pigan_state(tc, gtx, dtx, st, _np32(st.f.params))
    order_g, order_d = _jax_order(st.g.params, tps.g), _jax_order(st.d.params, tps.d)
    step = t_make_pigan_step(gtx, dtx, TSettings.from_config(tc), tds.param_lo, tds.param_hi)
    out = []
    for t in range(STEPS):
        tps, m = step(tps, t_gather_batch(tds, torch.as_tensor(ref["idx"][t])), 1.0)
        with torch.no_grad(), frozen_batch_stats(tps.g):
            probe = tps.g.train()(tds.spectra[:B])
        out.append((probe.double().numpy().ravel(),
                    tps.d_params.double().numpy()[order_d], _bn_stats(tps.g),
                    float(m["recon_spec_loss"]), float(m["d_loss"])))
    return out


def _gaps(a: list, b: list) -> dict:
    """Each quantity's gap, step by step."""
    per = {"g": [], "d": [], "bn_mean": [], "bn_var": [], "recon": [], "d_loss": []}
    means = np.r_[0:512, 1024:1280]      # (mean, var) of the 512 and the 256 features
    for (ga, da, sa, ra, la), (gb, db, sb, rb, lb) in zip(a, b):
        per["g"].append(_rel(ga, gb))
        per["d"].append(_rel(da, db))
        per["bn_mean"].append(_rel(sa[means], sb[means]))
        per["bn_var"].append(_rel(np.delete(sa, means), np.delete(sb, means)))
        per["recon"].append(abs(ra - rb))
        per["d_loss"].append(abs(la - lb))
    return per


def _excess(per: dict) -> dict:
    """Each quantity's largest gap over its bound."""
    return {q: max(v) / BOUNDS[q] for q, v in per.items()}


def test_jax_rounding_chaos_stays_inside_the_bounds(reference):
    """The window is short enough: the JAX step against itself from G's
    weights scaled by 1 + 1e-7 stays below every bound, step by step."""
    per = _gaps(reference["jax"], reference["twin"])
    assert max(_excess(per).values()) < 1.0, per


def test_eager_step_matches_the_jax_xla_step_step_by_step(reference):
    per = _gaps(reference["jax"], _port_walk(reference))
    assert max(_excess(per).values()) < 1.0, per


# ---------------------------------------------------------------------------
# Planted faults: each a torch default or a loss-shape slip of the watch list
# ---------------------------------------------------------------------------


def _late_step_schedule(*args, **kw):
    """D's staircase one step late: the rate at count c is the right one at
    c - 1."""
    right = _STEP_SCHEDULE(*args, **kw)
    return lambda count: right(torch.clamp(torch.as_tensor(count) - 1, min=0))


def _torch_clip_update(self, grads, state, params, lr_scale=None, sq_norm=None):
    """``ClipAdam.update_`` with ``clip_grad_norm_``'s rule: scale by
    clip / (‖g‖ + 1e-6), clamped at 1."""
    norm = torch.sqrt(torch.sum(grads * grads))
    grads = grads * torch.clamp(self.grad_clip / (norm + 1e-6), max=1.0)
    return _UPDATE(dataclasses.replace(self, grad_clip=0.0), grads, state, params, lr_scale,
                   sq_norm)


def _unbiased_running_var(self, x):
    """torch's BatchNorm running variance: the unbiased batch variance."""
    y = _BN_FORWARD(self, x)
    if self.training and self.update_stats:
        with torch.no_grad():
            var = x.double().var(dim=0, unbiased=False)
            self.running_var.add_((self.momentum * var / (x.shape[0] - 1)).float())
    return y


def _torch_adam_betas(*args, **kw):
    """torch's Adam default betas (0.9, 0.999) for G and D in place of b1 0.5."""
    if kw.get("b1") == 0.5:
        kw["b1"] = 0.9
    return _BUILD(*args, **kw)


def _smoothed_g_target(logits, target):
    """G trained against the smoothed 0.9 in place of the unsmoothed 1.0."""
    return _BCE(logits, torch.where(target == 1.0, torch.full_like(target, 0.9), target))


_STEP_SCHEDULE, _UPDATE = t_schedules.step_schedule, t_schedules.ClipAdam.update_
_BN_FORWARD, _BUILD, _BCE = FlaxBatchNorm1d._forward, t_state.build_optimizer, t_losses.bce_logits
FAULTS = {
    "d_schedule_boundary_one_step_late": (t_schedules, "step_schedule", _late_step_schedule),
    "batchnorm_unbiased_running_var": (FlaxBatchNorm1d, "_forward", _unbiased_running_var),
    "torch_adam_default_b1": (t_state, "build_optimizer", _torch_adam_betas),
}
UNSEEN = {
    "torch_clip_grad_norm_rule": (t_schedules.ClipAdam, "update_", _torch_clip_update),
    "g_target_smoothed": (t_losses, "bce_logits", _smoothed_g_target),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_lands_ten_times_above_a_bound(fault, reference, monkeypatch):
    owner, name, fn = FAULTS[fault]
    monkeypatch.setattr(owner, name, fn)
    excess = _excess(_gaps(reference["jax"], _port_walk(reference)))
    assert max(excess.values()) >= 10.0, (fault, excess)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)
    ref = next(reference.__wrapped__())
    rows = {"jax_twin": _excess(_gaps(ref["jax"], ref["twin"])),
            "port": _excess(_gaps(ref["jax"], _port_walk(ref)))}
    for fault, (owner, name, fn) in {**FAULTS, **UNSEEN}.items():
        saved = getattr(owner, name)
        setattr(owner, name, fn)
        try:
            rows[fault] = _excess(_gaps(ref["jax"], _port_walk(ref)))
        finally:
            setattr(owner, name, saved)
    for name, excess in rows.items():
        print(f"{name:36s}", " ".join(f"{q} {v:.3g}" for q, v in excess.items()))
