"""The enhanced model variants against the JAX package, at its published
widths: the residual and conv-attention generators; the dual-encoder, conv
and multi-scale discriminators with flax's spectral norm; the branched,
physics and uncertainty surrogates.

Weights come from flax's ``init`` and cross with ``from_flax``, with
BatchNorm running stats and spectral norm's ``u`` drawn with numpy so that
they are not the init's; inputs come from a numpy seed, batch 8.

- eval mode: outputs within EVAL_ATOL + EVAL_RTOL x the output's scale;
- train mode: the JAX package's dropout masks carried across
  (``tests/jax_masks.py``: flax's Dropout through ``intercept_methods``,
  attention-weight dropout through flax's ``dot_product_attention_weights``,
  the one (1, 1, Q, K) mask flax's ``broadcast_dropout`` shares across the
  batch and the heads), outputs as in eval mode, each parameter's gradient
  of a fixed random projection of the outputs within GRAD_RTOL of that
  tensor's largest JAX gradient (the biases that feed BatchNorm, whose true
  gradient is 0, below GAUGE_RTOL of the largest gradient on both sides),
  and the updated batch_stats within STATS_ATOL;
- spectral norm: ``u`` and ``sigma`` after one and after three train-mode
  calls within SN_ATOL, and eval mode's iteration with nothing stored;
- ``to_flax`` after ``from_flax`` gives every leaf back exactly;
- ``flax_init_``'s conv and attention kernels have flax's statistics;
- torch's ``AdaptiveAvgPool1d`` has the JAX package's pooling bins exactly.

fp32 on both sides in other summation orders: BatchNorm over a batch of 8
and softmax amplify rounding, hence the relative limits."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from jax_masks import MaskPlan
from pigan_thz_torch.config import DiscriminatorConfig as TDiscCfg
from pigan_thz_torch.config import ForwardModelConfig as TFwdCfg
from pigan_thz_torch.config import GeneratorConfig as TGenCfg
from pigan_thz_torch.interop import _params_from_flax, from_flax, to_flax
from pigan_thz_torch.models import (
    build_discriminator,
    build_forward_model,
    build_generator,
    dropout_masks,
)
from pigan_thz_torch.models.forward_model import mc_dropout_predict, sample_predictions
from pigan_thz_tpu.config import DiscriminatorConfig, ForwardModelConfig, GeneratorConfig
from pigan_thz_tpu.models import build_discriminator as j_build_discriminator
from pigan_thz_tpu.models import build_forward_model as j_build_forward_model
from pigan_thz_tpu.models import build_generator as j_build_generator
from pigan_thz_tpu.models.blocks import adaptive_avg_pool_matrix
from pigan_thz_tpu.models.forward_model import sample_predictions as j_sample_predictions

torch.set_num_threads(2)

B = 8
EVAL_ATOL, EVAL_RTOL = 1e-5, 1e-5
GRAD_RTOL = 2e-4
GAUGE_RTOL = 1e-5
STATS_ATOL = 1e-5
SN_ATOL = 1e-6

# (role, name, config knobs)
VARIANTS = [
    ("g", "residual", {}),
    ("g", "conv_attn", {}),
    ("g", "conv_attn", {"use_attention": False}),
    ("d", "dual_encoder", {"use_spectral_norm": True}),
    ("d", "dual_encoder", {"use_spectral_norm": False}),
    ("d", "conv", {}),
    ("d", "multi_scale", {"use_spectral_norm": True}),
    ("f", "branched", {}),
    ("f", "physics", {}),
    ("f", "uncertainty", {}),
]
IDS = [f"{n}{'-' + '-'.join(f'{k}={v}' for k, v in kw.items()) if kw else ''}"
       for _, n, kw in VARIANTS]


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _inputs(role, seed=0):
    rng = np.random.default_rng(seed)
    spec = rng.normal(size=(B, 250)).astype(np.float32)
    par = rng.uniform(2.2, 2.8, size=(B, 4)).astype(np.float32)
    pn = rng.uniform(-1.0, 1.0, size=(B, 4)).astype(np.float32)
    return {"g": (spec,), "d": (spec, par), "f": (pn,)}[role]


def _pair(role, name, kw):
    """(JAX module, its variables with drawn stats, port module loaded)."""
    if role == "g":
        jm = j_build_generator(GeneratorConfig(name=name, **kw))
        tm = build_generator(TGenCfg(name=name, **kw), device="cpu")
    elif role == "d":
        jm = j_build_discriminator(DiscriminatorConfig(name=name, **kw))
        tm = build_discriminator(TDiscCfg(name=name, **kw), device="cpu")
    else:
        jm = j_build_forward_model(ForwardModelConfig(name=name, **kw))
        tm = build_forward_model(TFwdCfg(name=name, **kw), device="cpu")
    x = [jnp.asarray(a) for a in _inputs(role)]
    v = _np(jm.init({"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}, *x))
    rng = np.random.default_rng(5)
    if "batch_stats" in v:
        flat = flatten_dict(v["batch_stats"])
        for k, a in flat.items():
            if k[-1] == "mean":
                flat[k] = (0.05 * rng.normal(size=a.shape)).astype(np.float32)
            elif k[-1] == "var":
                flat[k] = (0.8 + 0.4 * rng.random(a.shape)).astype(np.float32)
            elif k[-1].endswith("/u"):
                flat[k] = rng.normal(size=a.shape).astype(np.float32)
        v["batch_stats"] = unflatten_dict(flat)
    tm.load_state_dict(from_flax(v, tm))
    return jm, v, tm


def _gauge_leaves(model) -> set:
    """The parameters whose true gradient is 0 (the gauge leaves): the
    biases of the Dense and conv layers that feed a train-mode BatchNorm,
    which the batch mean removes; attention's key bias, which adds the
    same q·b to every key's score, which the softmax removes; and in the
    conv-attention generator attention's out bias, a constant shift of every
    token that the head's first Dense maps to a constant its BatchNorm
    removes.  (The value bias is not one: dropped attention weights do not
    sum to 1.)"""
    out = set()
    for name, mod in model.named_modules():
        if hasattr(mod, "num_heads"):
            out.add(f"{name}.key.bias")
        if isinstance(mod, torch.nn.Sequential):
            layers = list(mod)
            for i in range(len(layers) - 1):
                if isinstance(layers[i + 1], torch.nn.BatchNorm1d):
                    out.add(f"{name}.{i}.bias" if name else f"{i}.bias")
    head = getattr(model, "head", None)
    if getattr(model, "attention", None) is not None and isinstance(
            head, torch.nn.Sequential) and isinstance(head[1], torch.nn.BatchNorm1d):
        out.add("attention.out.bias")
    return out


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _close(a, b, atol, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    limit = atol + rtol * float(np.max(np.abs(a))) if a.size else 0.0
    assert err <= limit, (err, limit)
    return err


@pytest.mark.parametrize("role,name,kw", VARIANTS, ids=IDS)
def test_eval_forward_matches_flax(role, name, kw):
    jm, v, tm = _pair(role, name, kw)
    x = _inputs(role)
    jo = _tuple(jm.apply(v, *[jnp.asarray(a) for a in x]))
    with torch.no_grad():
        to = _tuple(tm.eval()(*[torch.from_numpy(a) for a in x]))
    assert len(jo) == len(to)
    for a, b in zip(jo, to):
        _close(a, b.numpy(), EVAL_ATOL, EVAL_RTOL)


@pytest.mark.parametrize("role,name,kw", VARIANTS, ids=IDS)
def test_train_forward_and_gradients_match_flax(role, name, kw):
    """Train mode with the JAX masks carried across: outputs, every
    parameter's gradient and the updated batch_stats."""
    jm, v, tm = _pair(role, name, kw)
    x = _inputs(role)
    root = type(jm).__name__
    plan = MaskPlan(11, {root: ["train"]})
    rng = np.random.default_rng(3)
    jx = [jnp.asarray(a) for a in x]
    shapes = [np.shape(o) for o in _tuple(jax.eval_shape(lambda: jm.apply(v, *jx)))]
    cots = [rng.normal(size=s).astype(np.float32) for s in shapes]
    extra = {k: val for k, val in v.items() if k != "params"}

    def loss(params):
        out, new = jm.apply({"params": params, **extra}, *jx, train=True,
                            rngs={"dropout": jax.random.PRNGKey(0)},
                            mutable=list(extra))
        out = _tuple(out)
        return sum(jnp.sum(o * c) for o, c in zip(out, cots)), (out, new)

    with plan.apply():
        (_, (jo, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(v["params"])
    assert plan.sets, "the JAX model drew no dropout mask"

    with dropout_masks(tm, plan.masks("train")):
        to = _tuple(tm.train()(*[torch.from_numpy(a) for a in x]))
    tl = sum(torch.sum(o * torch.from_numpy(c)) for o, c in zip(to, cots))
    params = dict(tm.named_parameters())
    tgrads = torch.autograd.grad(tl, list(params.values()))
    for a, b in zip(jo, to):
        _close(a, b.detach().numpy(), EVAL_ATOL, EVAL_RTOL)
    want = _params_from_flax(_np(grads), tm)
    scale = max(float(w.abs().max()) for w in want.values())
    gauge = _gauge_leaves(tm)
    for (pname, _), g in zip(params.items(), tgrads):
        if pname in gauge:
            # true gradient 0: both packages' are rounding noise
            assert max(float(g.abs().max()), float(want[pname].abs().max())) <= GAUGE_RTOL * scale
        else:
            _close(want[pname].numpy(), g.numpy(), 1e-7, GRAD_RTOL)
    if extra:
        sd = from_flax({"params": v["params"], **_np(dict(new_stats))}, tm)
        own = tm.state_dict()
        for k, val in sd.items():
            if not k.endswith(("weight", "bias", "num_batches_tracked")):
                _close(val.numpy(), own[k].numpy(), STATS_ATOL, 0.0)


@pytest.mark.parametrize("name", ["dual_encoder", "multi_scale"])
def test_spectral_norm_state_after_repeated_calls(name):
    """``u`` and ``sigma`` after one and after three train-mode calls on
    different batches (no dropout: D's masks are held elsewhere), and eval
    mode's one iteration from the stored ``u`` with nothing stored."""
    jm, v, tm = _pair("d", name, {"use_spectral_norm": True})
    tm.train()
    for layer in tm.modules():
        if hasattr(layer, "shared_dims"):
            layer.p = 0.0
    stats = v["batch_stats"]
    for call in range(3):
        spec, par = _inputs("d", seed=100 + call)
        _, new = _sn_train_apply(jm, v["params"], stats, spec, par)
        stats = _np(dict(new))["batch_stats"]
        with torch.no_grad():
            tm(torch.from_numpy(spec), torch.from_numpy(par))
        if call in (0, 2):
            sd = from_flax({"params": v["params"], "batch_stats": stats}, tm)
            own = tm.state_dict()
            keys = [k for k in sd if k.endswith((".u", ".sigma"))]
            assert len(keys) == (18 if name == "dual_encoder" else 36)
            for k in keys:
                _close(sd[k].numpy(), own[k].numpy(), SN_ATOL, 0.0)
    # eval mode: the iteration runs, nothing is stored
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    spec, par = _inputs("d", seed=7)
    jo = jm.apply({"params": v["params"], "batch_stats": stats}, jnp.asarray(spec),
                  jnp.asarray(par))
    with torch.no_grad():
        to = tm.eval()(torch.from_numpy(spec), torch.from_numpy(par))
    _close(jo, to.numpy(), EVAL_ATOL, EVAL_RTOL)
    assert all(torch.equal(before[k], t) for k, t in tm.state_dict().items())


def _sn_train_apply(jm, params, stats, spec, par):
    """D in train mode (SpectralNorm's update_stats) with its dropout
    layers passing their input through."""

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            return args[0]
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(interceptor):
        return jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(spec),
                        jnp.asarray(par), train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                        mutable=["batch_stats"])


@pytest.mark.parametrize("role,name,kw", VARIANTS, ids=IDS)
def test_to_flax_inverts_from_flax(role, name, kw):
    _, v, tm = _pair(role, name, kw)
    back = flatten_dict(to_flax(tm.state_dict(), tm))
    want = flatten_dict(v)
    assert set(back) == set(want)
    for k, a in want.items():
        assert back[k].shape == a.shape and np.array_equal(back[k], a), k


def test_flax_init_statistics_of_conv_and_attention_kernels():
    """The registry's init against flax's: each conv kernel and each
    attention projection with the std of a truncated lecun normal of its
    fan-in (conv: in_channels x width; q / k / v: the 256 inputs; out:
    heads x head_dim), zero biases; spectral norm's ``u`` a unit normal and
    ``sigma`` 1."""
    g = build_generator(TGenCfg(name="conv_attn"), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    jv = j_build_generator(GeneratorConfig(name="conv_attn")).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, 250)))["params"]
    convs = [m for m in g.convs.convs if isinstance(m, torch.nn.Conv1d)]
    checks = [(convs[1].weight, jv["ConvStack1D_0"]["Conv_1"]["kernel"], 64 * 5),
              (convs[2].weight, jv["ConvStack1D_0"]["Conv_2"]["kernel"], 128 * 3)]
    att = jv["SelfAttention_0"]["MultiHeadDotProductAttention_0"]
    for name in ("query", "key", "value"):
        checks.append((getattr(g.attention, name).weight, att[name]["kernel"], 256))
    checks.append((g.attention.out.weight, att["out"]["kernel"], 8 * 32))
    for w, jw, fan_in in checks:
        want = np.sqrt(1.0 / fan_in)
        assert abs(float(w.std()) / want - 1.0) < 0.02
        assert abs(float(np.std(np.asarray(jw))) / want - 1.0) < 0.02
        assert float(w.abs().max()) <= 2.0 * want / 0.87962566103423978 + 1e-6
    for m in g.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv1d)):
            assert not bool(m.bias.any())
    d = build_discriminator(TDiscCfg(name="dual_encoder", use_spectral_norm=True),
                            device="cpu", generator=torch.Generator().manual_seed(0))
    us = torch.cat([m.u.reshape(-1) for m in d.modules() if hasattr(m, "u")])
    assert us.numel() == 1441
    assert abs(float(us.mean())) < 0.1 and abs(float(us.std()) - 1.0) < 0.08
    assert all(float(m.sigma) == 1.0 for m in d.modules() if hasattr(m, "sigma"))


@pytest.mark.parametrize("length,out", [(62, 32), (62, 16), (250, 32), (125, 16), (7, 3)])
def test_adaptive_avg_pool_has_the_jax_package_s_bins(length, out):
    eye = torch.eye(length)[None]                        # (1, L, L): column j = e_j
    pooled = torch.nn.AdaptiveAvgPool1d(out)(eye)[0]     # (L, out)
    assert np.array_equal(pooled.T.numpy(), adaptive_avg_pool_matrix(length, out))


def test_sample_predictions_statistics():
    """The predictive Gaussian's samples: mean and variance of 4000 draws
    within 5 standard errors of the model's, as the JAX package's draws."""
    _, v, f = _pair("f", "uncertainty", {})
    pn = _inputs("f")[0][:2]
    spec, met = sample_predictions(f, torch.from_numpy(pn),
                                   torch.Generator().manual_seed(0), num_samples=4000)
    assert spec.shape == (4000, 2, 250) and met.shape == (4000, 2, 8)
    jm = j_build_forward_model(ForwardModelConfig(name="uncertainty"))
    js, jmet = j_sample_predictions(jm, v, jnp.asarray(pn), jax.random.PRNGKey(0), 4000)
    with torch.no_grad():
        mean_s, mean_m, var_s, var_m = f.eval()(torch.from_numpy(pn))
    for draws, jdraws, mean, var in ((spec, js, mean_s, var_s), (met, jmet, mean_m, var_m)):
        se = torch.sqrt(var / 4000)
        assert bool((torch.abs(draws.mean(0) - mean) < 5 * se + 1e-6).all())
        assert bool((torch.abs(torch.from_numpy(np.asarray(jdraws)).mean(0) - mean)
                     < 5 * se + 1e-5).all())
        assert bool((torch.abs(draws.var(0) / var - 1.0) < 0.15).all())


def test_mc_dropout_shares_the_attention_mask_across_a_sample_s_rows():
    """The physics surrogate's single-token attention dropout is one mask a
    sample (flax's broadcast_dropout under the JAX package's vmap): with
    every other rate at 0 a sample's rows are all kept or all dropped, so
    with two equal rows the spread of row 0 equals that of row 1."""
    f = build_forward_model(TFwdCfg(name="physics"), device="cpu",
                            generator=torch.Generator().manual_seed(0))
    for m in f.modules():
        if hasattr(m, "shared_dims") and not m.shared_dims:
            m.p = 0.0
    pn = torch.from_numpy(np.repeat(_inputs("f")[0][:1], 2, axis=0))
    spec_mean, spec_std, _, _ = mc_dropout_predict(f, pn, torch.Generator().manual_seed(1),
                                                   num_samples=64)
    assert bool((spec_std[0] > 0).any())
    assert torch.equal(spec_std[0], spec_std[1]) and torch.equal(spec_mean[0], spec_mean[1])
