"""The fused serving kernels' plain versions against the JAX Pallas kernels
(interpret mode, as tests/test_pallas.py runs them).  The CUDA kernels
against their plain versions on the card are in test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch.config import ForwardModelConfig as TFwdCfg
from pigan_thz_torch.config import GeneratorConfig as TGenCfg
from pigan_thz_torch.interop import from_flax
from pigan_thz_torch.models import build_forward_model, build_generator
from pigan_thz_torch.ops import fused_kernels as fk
from pigan_thz_tpu.config import ForwardModelConfig, GeneratorConfig
from pigan_thz_tpu.models import build_forward_model as j_build_forward_model
from pigan_thz_tpu.models import build_generator as j_build_generator
from pigan_thz_tpu.ops import pallas_kernels as pk

torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def jax_forward():
    f = j_build_forward_model(ForwardModelConfig())
    k = jax.random.PRNGKey(0)
    fv = f.init({"params": k, "dropout": k}, jnp.zeros((2, 4)), train=False)
    return _np_tree(fv)


@pytest.fixture(scope="module")
def jax_generator():
    """Baseline G with non-trivial BatchNorm running stats (as
    tests/test_pallas.py makes them)."""
    g = j_build_generator(GeneratorConfig())
    k = jax.random.PRNGKey(0)
    gv = dict(g.init(k, jnp.zeros((2, 250)), train=False))
    gv["batch_stats"] = jax.tree.map(
        lambda a: a + 0.1 * jax.random.normal(k, a.shape) ** 2, gv["batch_stats"]
    )
    return _np_tree(gv)


@pytest.fixture(scope="module")
def port_forward(jax_forward):
    f = build_forward_model(TFwdCfg(), device="cpu")
    f.load_state_dict(from_flax(jax_forward, "forward_model"))
    return f.eval()


@pytest.fixture(scope="module")
def port_generator(jax_generator):
    g = build_generator(TGenCfg(), device="cpu")
    g.load_state_dict(from_flax(jax_generator, "generator"))
    return g.eval()


def test_small_chain_matches_jax_kernel():
    """fused_mlp_forward_plain on a hand-built 2-layer chain vs the Pallas
    kernel in interpret mode."""
    rng = np.random.default_rng(0)
    W1 = rng.normal(size=(8, 16)).astype(np.float32)
    b1, s1, c1 = (rng.normal(size=(16,)).astype(np.float32) for _ in range(3))
    Wh = rng.normal(size=(16, 4)).astype(np.float32)
    bh = rng.normal(size=(4,)).astype(np.float32)
    x = rng.normal(size=(10, 8)).astype(np.float32)
    want = pk.fused_mlp_forward(
        jnp.asarray(x), [tuple(map(jnp.asarray, (W1, b1, s1, c1)))],
        (jnp.asarray(Wh), jnp.asarray(bh)), tile_b=8, interpret=True,
    )
    packed = fk.pack_chain(
        [tuple(map(torch.from_numpy, (W1, b1, s1, c1)))],
        (torch.from_numpy(Wh), torch.from_numpy(bh)),
    )
    assert packed.layer_norm and packed.dims == (8, 16, 4)
    got = fk.fused_mlp_forward_plain(torch.from_numpy(x), packed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("batch,tile_b", [(300, 256), (77, 64)])
def test_forward_surrogate_matches_jax_kernel(batch, tile_b, jax_forward, port_forward):
    """Full baseline F; B=77 is ragged against the Pallas tile."""
    x = np.random.default_rng(batch).uniform(-1, 1, size=(batch, 4)).astype(np.float32)
    want_s, want_m = pk.forward_surrogate_fused(
        jax_forward, jnp.asarray(x), tile_b=tile_b, interpret=True
    )
    packed = fk.pack_forward_model(port_forward)
    got_s, got_m = fk.forward_surrogate_fused(packed, torch.from_numpy(x))
    assert got_s.shape == (batch, 250) and got_m.shape == (batch, 8)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-4, rtol=0)


@pytest.mark.parametrize("batch", [100, 77])
def test_generator_matches_jax_kernel(batch, jax_generator, port_generator):
    x = np.random.default_rng(batch).normal(size=(batch, 250)).astype(np.float32)
    want = pk.generator_fused(jax_generator, jnp.asarray(x), interpret=True)
    packed = fk.pack_generator(port_generator)
    assert not packed.layer_norm and packed.dims == (250, 512, 256, 4)
    got = fk.generator_fused(packed, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_fold_batchnorm_matches_jax():
    rng = np.random.default_rng(1)
    W = rng.normal(size=(12, 6)).astype(np.float32)
    vecs = [rng.normal(size=(6,)).astype(np.float32) for _ in range(4)]
    var = rng.uniform(0.5, 2.0, size=(6,)).astype(np.float32)
    args = [W, *vecs, var]
    got = fk.fold_batchnorm(*map(torch.from_numpy, args))
    want = pk.fold_batchnorm(*map(jnp.asarray, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


def test_extraction_matches_jax(jax_forward, port_forward):
    layers, head = fk.extract_forward_mlp_weights(port_forward)
    j_layers, j_head = pk.extract_forward_mlp_weights(jax_forward)
    for got, want in zip([*layers, head], [*j_layers, j_head]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))


def test_packed_views_reproduce_the_chain(port_generator):
    layers, head = fk.extract_generator_weights(port_generator)
    packed = fk.pack_generator(port_generator)
    assert packed.weights.is_contiguous() and packed.weights.dtype == torch.float32
    for l, tensors in enumerate([*layers, head]):
        for got, want in zip(packed.layer(l), tensors):
            assert torch.equal(got, want)
    assert packed.offsets[0][2:] == (-1, -1)


def test_non_baseline_layouts_raise(port_generator, port_forward):
    g_layer = build_generator(TGenCfg(norm="layer"), device="cpu")        # no BatchNorm stats
    with pytest.raises(ValueError):
        fk.extract_generator_weights(g_layer)
    f_short = build_forward_model(TFwdCfg(hidden_dims=(256, 512, 256)), device="cpu")
    with pytest.raises(ValueError):
        fk.extract_forward_mlp_weights(f_short)
    with pytest.raises(ValueError):
        fk.extract_forward_mlp_weights(port_generator)
    with pytest.raises(ValueError):
        fk.extract_generator_weights(port_forward)


def test_pack_chain_rejects_bad_shapes():
    W = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        fk.pack_chain([(W, torch.zeros(7))], (torch.zeros(8, 2), torch.zeros(2)))
    with pytest.raises(ValueError):
        fk.pack_chain([(W, torch.zeros(8))], (torch.zeros(9, 2), torch.zeros(2)))
    with pytest.raises(ValueError):
        fk.pack_chain([(W, torch.zeros(8)), (torch.zeros(8, 8), torch.zeros(8),
                                             torch.ones(8), torch.zeros(8))],
                      (torch.zeros(8, 2), torch.zeros(2)))


def test_wrappers_validate_inputs(port_generator, port_forward):
    g = fk.pack_generator(port_generator)
    f = fk.pack_forward_model(port_forward)
    with pytest.raises(TypeError):
        fk.fused_dense_chain(torch.zeros(2, 250, dtype=torch.float64), g)
    with pytest.raises(ValueError):
        fk.fused_dense_chain(torch.zeros(2, 249), g)
    with pytest.raises(ValueError):
        fk.fused_dense_chain(torch.zeros(250, 2).T, g)        # not contiguous
    with pytest.raises(ValueError):
        fk.fused_mlp_forward(torch.zeros(2, 250), g)          # wrong chain kind
    with pytest.raises(ValueError):
        fk.fused_dense_chain(torch.zeros(2, 4), f)
    with pytest.raises(ValueError):
        fk.fused_dense_chain(torch.zeros(2, 250, device="meta"), g)
