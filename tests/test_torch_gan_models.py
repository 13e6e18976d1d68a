"""The GAN slice's models against the JAX package: ``MLPDiscriminator``, the
generator in train mode (flax's BatchNorm, running stats included),
``build_trio`` and the discriminator's weight carry-over.

Weights are initialised by flax and carried across with ``from_flax``;
inputs come from a numpy seed.  Tolerances: outputs and running stats agree
to 1e-5 (fp32 on both sides, other summation orders over at most 512
terms)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.config import DiscriminatorConfig as TDiscCfg
from pigan_thz_torch.config import GeneratorConfig as TGenCfg
from pigan_thz_torch.interop import from_flax, to_flax
from pigan_thz_torch.models import (
    FlaxBatchNorm1d,
    MLPDiscriminator,
    build_discriminator,
    build_generator,
    build_trio,
    frozen_batch_stats,
)
from pigan_thz_tpu import interop as jinterop
from pigan_thz_tpu.config import DiscriminatorConfig, GeneratorConfig
from pigan_thz_tpu.models import build_discriminator as j_build_discriminator
from pigan_thz_tpu.models import build_generator as j_build_generator

torch.set_num_threads(1)

TOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def jax_discriminator():
    d = j_build_discriminator(DiscriminatorConfig())
    k = jax.random.PRNGKey(3)
    dv = d.init({"params": k, "dropout": k}, jnp.zeros((2, 250)), jnp.zeros((2, 4)),
                train=False)
    return d, _np_tree(dv)


@pytest.fixture(scope="module")
def jax_generator():
    g = j_build_generator(GeneratorConfig())
    k = jax.random.PRNGKey(0)
    gv = dict(g.init(k, jnp.zeros((2, 250)), train=False))
    gv["batch_stats"] = jax.tree.map(
        lambda a: a + 0.1 * jax.random.normal(k, a.shape) ** 2, gv["batch_stats"])
    return g, _np_tree(gv)


def _inputs(b, seed=0):
    rng = np.random.default_rng(seed)
    spectra = (-8.0 * rng.random((b, 250)) ** 2).astype(np.float32)    # dB, <= 0
    params = rng.uniform(2.2, 2.8, (b, 4)).astype(np.float32)
    return spectra, params


def test_discriminator_map_is_the_jax_package_s(jax_discriminator):
    _, dv = jax_discriminator
    want = jinterop.flax_to_torch(dv, jinterop.DISCRIMINATOR_MAP)
    got = from_flax(dv, "discriminator")
    assert set(got) == set(want) == {f"main.{i}.{p}" for i in (0, 2, 4)
                                     for p in ("weight", "bias")}
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)
    back = to_flax(got, "discriminator")
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(dv)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure(back) == jax.tree.structure(dict(dv))


@pytest.mark.parametrize("train", [False, True])
def test_discriminator_matches_flax(train, jax_discriminator):
    d, dv = jax_discriminator
    spectra, params = _inputs(33)
    want = np.asarray(d.apply(dv, jnp.asarray(spectra), jnp.asarray(params), train=train))
    td = build_discriminator(TDiscCfg(), device="cpu")
    td.load_state_dict(from_flax(dv, "discriminator"))
    td.train(train)
    with torch.no_grad():
        got = td(torch.from_numpy(spectra), torch.from_numpy(params)).numpy()
    assert got.shape == want.shape == (33, 1)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_discriminator_layout_and_flat_inputs():
    td = MLPDiscriminator()
    assert [tuple(p.shape) for p in td.parameters()] == [
        (512, 254), (512,), (256, 512), (256,), (1, 256), (1,)]
    spectra, params = _inputs(5)
    a = td(torch.from_numpy(spectra), torch.from_numpy(params))
    b = td(torch.from_numpy(spectra).reshape(5, 250, 1), torch.from_numpy(params))
    assert torch.equal(a, b)


def test_generator_train_mode_matches_flax(jax_generator):
    """Train-mode outputs and the running-stat update (biased variance,
    momentum 0.9) over two batches."""
    g, gv = jax_generator
    tg = build_generator(TGenCfg(), device="cpu")
    tg.load_state_dict(from_flax(gv, "generator"))
    tg.train()
    variables = gv
    for seed in (1, 2):
        spectra, _ = _inputs(64, seed)
        want, mutated = g.apply(variables, jnp.asarray(spectra), train=True,
                                mutable=["batch_stats"])
        variables = {"params": gv["params"], "batch_stats": mutated["batch_stats"]}
        with torch.no_grad():
            got = tg(torch.from_numpy(spectra)).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    back = to_flax(tg.state_dict(), "generator")["batch_stats"]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_np_tree(variables["batch_stats"]))):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    bn = tg.main[1]
    assert isinstance(bn, FlaxBatchNorm1d) and int(bn.num_batches_tracked) == 2


def test_running_variance_is_the_biased_one():
    """torch's BatchNorm1d would store the unbiased batch variance."""
    bn = FlaxBatchNorm1d(3, eps=1e-5, momentum=0.1).train()
    x = torch.tensor(np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32))
    bn(x)
    biased = x.var(dim=0, unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 * torch.ones(3) + 0.1 * biased,
                               rtol=1e-6, atol=1e-6)
    ref = torch.nn.BatchNorm1d(3, eps=1e-5, momentum=0.1).train()
    ref(x)
    assert not torch.allclose(ref.running_var, bn.running_var, rtol=1e-3, atol=0)
    # the same state_dict keys, and the same eval-mode function
    assert set(bn.state_dict()) == set(ref.state_dict())
    ref.load_state_dict(bn.state_dict())
    torch.testing.assert_close(bn.eval()(x), ref.eval()(x))


def test_frozen_batch_stats_leaves_the_stats_alone():
    g = build_generator(TGenCfg(), device="cpu",
                        generator=torch.Generator().manual_seed(0)).train()
    spectra, _ = _inputs(16)
    x = torch.from_numpy(spectra)
    before = {k: v.clone() for k, v in g.state_dict().items() if "running" in k}
    with torch.no_grad(), frozen_batch_stats(g):
        inside = g(x)
    for k, v in before.items():
        assert torch.equal(g.state_dict()[k], v)
    with torch.no_grad():
        outside = g(x)
    assert torch.equal(inside, outside)      # batch statistics either way
    assert any(not torch.equal(g.state_dict()[k], v) for k, v in before.items())


def test_build_trio_draws_g_then_d_then_f():
    cfg = t_default_config()
    g, d, f = build_trio(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    g2 = build_generator(cfg.generator, device="cpu", generator=gen)
    d2 = build_discriminator(cfg.discriminator, device="cpu", generator=gen)
    assert torch.equal(g.main[0].weight, g2.main[0].weight)
    assert torch.equal(d.main[4].weight, d2.main[4].weight)
    assert (f.spectrum_dim, d.main[0].in_features) == (250, 254)


@pytest.mark.parametrize("name", ["dual_encoder", "conv", "multi_scale"])
def test_unported_discriminators_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_discriminator(TDiscCfg(name=name), device="cpu")


@pytest.mark.parametrize("build", [build_generator, build_discriminator])
def test_build_functions_need_a_device(build):
    cfg = t_default_config()
    section = cfg.generator if build is build_generator else cfg.discriminator
    with pytest.raises(TypeError, match="device"):
        build(section)
    with pytest.raises(TypeError, match="device"):
        build_trio(cfg)
