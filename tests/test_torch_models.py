"""The port's baseline models and weight carry-over against the JAX package.

Weights are initialised by flax and carried across with ``from_flax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch.config import ForwardModelConfig as TFwdCfg
from pigan_thz_torch.config import GeneratorConfig as TGenCfg
from pigan_thz_torch.interop import from_flax, to_flax
from pigan_thz_torch.models import build_forward_model, build_generator
from pigan_thz_tpu import interop as jinterop
from pigan_thz_tpu.config import ForwardModelConfig, GeneratorConfig
from pigan_thz_tpu.models import build_forward_model as j_build_forward_model
from pigan_thz_tpu.models import build_generator as j_build_generator

torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_generator():
    """Baseline G with non-trivial BatchNorm running stats."""
    g = j_build_generator(GeneratorConfig())
    k = jax.random.PRNGKey(0)
    gv = dict(g.init(k, jnp.zeros((2, 250)), train=False))
    gv["batch_stats"] = jax.tree.map(
        lambda a: a + 0.1 * jax.random.normal(k, a.shape) ** 2, gv["batch_stats"]
    )
    return g, _np_tree(gv)


@pytest.fixture(scope="module")
def jax_forward():
    f = j_build_forward_model(ForwardModelConfig())
    k = jax.random.PRNGKey(1)
    fv = f.init({"params": k, "dropout": k}, jnp.zeros((2, 4)), train=False)
    return f, _np_tree(fv)


@pytest.mark.parametrize("kind", ["generator", "forward_model"])
def test_from_flax_equals_jax_flax_to_torch(kind, jax_generator, jax_forward):
    variables = jax_generator[1] if kind == "generator" else jax_forward[1]
    mapping = jinterop.GENERATOR_MAP if kind == "generator" else jinterop.FORWARD_MODEL_MAP
    want = jinterop.flax_to_torch(variables, mapping)
    got = from_flax(variables, kind)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)


@pytest.mark.parametrize("kind", ["generator", "forward_model"])
def test_to_flax_inverts_from_flax(kind, jax_generator, jax_forward):
    variables = jax_generator[1] if kind == "generator" else jax_forward[1]
    back = to_flax(from_flax(variables, kind), kind)
    want = _flat(variables)
    got = _flat(back)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("kind", ["generator", "forward_model"])
def test_port_layout_is_the_reference_torch_layout(kind, jax_generator, jax_forward):
    if kind == "generator":
        module, variables = build_generator(TGenCfg(), device="cpu"), jax_generator[1]
    else:
        module, variables = build_forward_model(TFwdCfg(), device="cpu"), jax_forward[1]
    got, want = module.state_dict(), from_flax(variables, kind)
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name


def test_unknown_kind_raises(jax_forward):
    with pytest.raises(ValueError):
        from_flax(jax_forward[1], "critic")


def test_generator_eval_matches_flax(jax_generator):
    g, gv = jax_generator
    x = np.random.default_rng(0).normal(size=(33, 250)).astype(np.float32)
    want = np.asarray(g.apply(gv, jnp.asarray(x), train=False))
    tg = build_generator(TGenCfg(), device="cpu")
    tg.load_state_dict(from_flax(gv, "generator"))
    with torch.no_grad():
        got = tg.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_forward_eval_matches_flax(jax_forward):
    """1e-4 on the spectrum: XLA-CPU and MKL sum in different orders over
    the 1024-wide layers."""
    f, fv = jax_forward
    x = np.random.default_rng(1).uniform(-1, 1, size=(33, 4)).astype(np.float32)
    want_s, want_m = f.apply(fv, jnp.asarray(x), train=False)
    tf = build_forward_model(TFwdCfg(), device="cpu")
    tf.load_state_dict(from_flax(fv, "forward_model"))
    with torch.no_grad():
        got_s, got_m = tf.eval()(torch.from_numpy(x))
    assert got_s.shape == (33, 250) and got_m.shape == (33, 8)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-5, rtol=0)


def test_flax_init_scheme():
    """Truncated lecun_normal kernels, zero biases, unit norm scales and
    BatchNorm stats 0 / 1 -- the distribution flax draws from."""
    g = build_generator(TGenCfg(), generator=torch.Generator().manual_seed(0), device="cpu")
    w = g.main[0].weight.detach()   # (512, 250): fan_in 250
    std = np.sqrt(1.0 / 250) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std
    assert abs(float(w.std()) - np.sqrt(1.0 / 250)) < 0.02 * np.sqrt(1.0 / 250)
    assert float(g.main[0].bias.abs().max()) == 0.0
    bn = g.main[1]
    assert torch.equal(bn.weight, torch.ones(512)) and torch.equal(bn.bias, torch.zeros(512))
    assert torch.equal(bn.running_mean, torch.zeros(512))
    assert torch.equal(bn.running_var, torch.ones(512))
    assert bn.eps == 1e-5 and bn.momentum == 0.1
    f = build_forward_model(TFwdCfg(), device="cpu")
    assert f.model[1].eps == 1e-6


def test_seeded_build_is_deterministic():
    a = build_forward_model(TFwdCfg(), generator=torch.Generator().manual_seed(3), device="cpu")
    b = build_forward_model(TFwdCfg(), generator=torch.Generator().manual_seed(3), device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


@pytest.mark.parametrize("build,cfg", [
    (build_generator, TGenCfg(name="conv_attn")),
    (build_generator, TGenCfg(name="residual")),
    (build_forward_model, TFwdCfg(name="branched")),
    (build_forward_model, TFwdCfg(name="physics")),
    (build_forward_model, TFwdCfg(name="uncertainty")),
])
def test_unported_variants_raise(build, cfg):
    """The enhanced variants, once refused by name, now build: the JAX
    package's parameter count, and finite outputs of its shapes in eval
    mode (their parity is in test_torch_enhanced_models.py)."""
    m = build(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    is_g = build is build_generator
    jbuild = j_build_generator if is_g else j_build_forward_model
    jcfg = (GeneratorConfig if is_g else ForwardModelConfig)(name=cfg.name)
    x = np.random.default_rng(0).normal(size=(3, 250 if is_g else 4)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jbuild(jcfg).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jnp.asarray(x)))
    assert sum(p.numel() for p in m.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(x))
    out = out if isinstance(out, tuple) else (out,)
    want = [(3, 4)] if is_g else [(3, 250), (3, 8)] * (2 if cfg.name == "uncertainty" else 1)
    assert [tuple(o.shape) for o in out] == want
    assert all(bool(torch.isfinite(o).all()) for o in out)


def test_unknown_variant_raises():
    with pytest.raises(ValueError):
        build_generator(TGenCfg(name="nope"), device="cpu")
