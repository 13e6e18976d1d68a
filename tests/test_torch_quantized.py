"""The port's int8 serving path (pigan_thz_torch/ops/quantized.py and
``serve.make_inverse_design_fn(compute_dtype="int8")``) against the JAX
package's (pigan_thz_tpu/ops/quantized.py), on the CPU, at the full widths
of the baseline trio with JAX-initialised weights (G's BatchNorm stats
perturbed, so the folding is exercised) carried over by ``from_flax``.

Integers are compared exactly: the weight quantization (w_q and its scales),
the activations' int8 rows and the int32 accumulators, chain layer by chain
layer with JAX's own previous output as the input.  Float outputs of one
layer are the same fp32 operations in the same order (``acc * (sx * sw) +
b``): within QDENSE_RTOL.

The whole cycle.  Both packages quantize every layer's input row to int8,
so an fp32 difference between them of one ulp in an activation can move a
rounding across a half-integer, and then that row's int8 input differs by
one unit in one entry.  Through the next product that moves output j of the
row by |w_q[k, j]| * sx * sw[j] <= 127 * sx * sw[j] = sx * max|W[:, j]|: one
quantization step of the layer's input row times its largest weight.  The
cycle's last layers are G's head (through tanh, whose slope is at most 1)
and F's head, so the cycle is held, row by row and column by column, to
one such step of the last layer's input: |Δ| <= sx * max|W[:, j]|, with
sx the JAX row's activation scale (a flip further up moves the last input
row itself, and the test then fails: that is the bound's claim).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.config import GeneratorConfig
from pigan_thz_torch.data import build_dataset, denormalize_params
from pigan_thz_torch.interop import from_flax
from pigan_thz_torch.models import build_forward_model, build_generator
from pigan_thz_torch.ops import quantized as tq
from pigan_thz_torch.serve import make_inverse_design_fn
from pigan_thz_tpu.data.dataset import denormalize_params as j_denormalize
from pigan_thz_tpu.models import build_trio
from pigan_thz_tpu.ops import quantized as jq
from pigan_thz_tpu.ops.pallas_kernels import (
    extract_forward_mlp_weights as j_extract_forward,
)
from pigan_thz_tpu.ops.pallas_kernels import (
    extract_generator_weights as j_extract_generator,
)
from pigan_thz_tpu.serve import make_inverse_design_fn as j_make_inverse_design_fn

torch.set_num_threads(1)

QDENSE_RTOL = 1e-6


@pytest.fixture(scope="module")
def trio(cfg, small_ds):
    g, _, f = build_trio(cfg)
    k = jax.random.PRNGKey(0)
    gv = dict(g.init(k, small_ds.spectra[:2], train=False))
    gv["batch_stats"] = jax.tree.map(
        lambda a: a + 0.1 * jax.random.normal(k, a.shape) ** 2, gv["batch_stats"])
    fv = f.init({"params": k, "dropout": k}, small_ds.params_norm[:2], train=False)
    tcfg = t_default_config()
    tg = build_generator(tcfg.generator, device="cpu")
    tg.load_state_dict(from_flax(jax.tree.map(np.asarray, gv), "generator"))
    tf = build_forward_model(tcfg.forward_model, device="cpu")
    tf.load_state_dict(from_flax(jax.tree.map(np.asarray, fv), "forward_model"))
    tds = build_dataset(
        np.asarray(small_ds.spectra), np.asarray(small_ds.params),
        np.asarray(small_ds.metrics), tcfg.data,
        frequencies=np.asarray(small_ds.frequencies), device="cpu")
    return (g, f, gv, fv), (tg.eval(), tf.eval()), tds


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def test_quantize_weight_equals_jax(trio):
    """w_q and sw bit for bit on a random matrix and on every layer of the
    trio (G's BatchNorm-folded)."""
    (_, _, gv, fv), _, _ = trio
    W = jax.random.normal(jax.random.PRNGKey(1), (64, 32)) * jnp.linspace(0.1, 3.0, 32)[None]
    g_layers, g_head = j_extract_generator(gv)
    f_layers, f_head = j_extract_forward(fv)
    for w in [W, *(t[0] for t in g_layers), g_head[0], *(t[0] for t in f_layers), f_head[0]]:
        jw_q, jsw = jq.quantize_weight(w)
        w_q, sw = tq.quantize_weight(_t(w))
        assert w_q.dtype == torch.int8
        assert np.array_equal(w_q.numpy(), np.asarray(jw_q))
        assert np.array_equal(sw.numpy(), np.asarray(jsw))


def test_qdense_equals_jax():
    """The same fp32 input: x_q and the int32 accumulator exactly, the output
    within QDENSE_RTOL."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(2), 3)
    x = jax.random.normal(k1, (16, 48))
    W = jax.random.normal(k2, (48, 24)) * 0.2
    b = jax.random.normal(k3, (24,))
    jw_q, jsw = jq.quantize_weight(W)
    jx_q, jsx = jq._quantize_rows(x)
    jacc = jax.lax.dot_general(jx_q, jw_q, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    w_q, sw = tq.quantize_weight(_t(W))
    x_q, sx = tq._quantize_rows(_t(x))
    assert np.array_equal(x_q.numpy(), np.asarray(jx_q))
    assert np.array_equal(sx.numpy(), np.asarray(jsx))
    assert np.array_equal(tq.int_mm(x_q, w_q).numpy(), np.asarray(jacc))
    want = np.asarray(jq.qdense(x, jw_q, jsw, b))
    got = tq.qdense(_t(x), w_q, sw, _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=QDENSE_RTOL, atol=0)


def _layer_inputs(layers, head, x, between):
    """The JAX chain's input to each layer, starting from ``x`` (numpy)."""
    inputs = []
    for w_q, sw, b, *rest in [*layers, head]:
        inputs.append(x)
        x = between(np.asarray(jq.qdense(jnp.asarray(x), w_q, sw, b)), rest)
    return inputs


def test_int8_chains_equal_jax_layer_by_layer(trio, small_ds):
    """G's and F's int8 chains, each layer fed JAX's previous output: the
    same int8 rows, int32 accumulators and (within QDENSE_RTOL) outputs."""
    (_, _, gv, fv), (tg, tf), _ = trio
    relu = lambda y, rest: np.maximum(y, 0.0)  # noqa: E731

    def ln_leaky(y, rest):
        if not rest:
            return y
        h = jnp.asarray(y)
        mean = jnp.mean(h, -1, keepdims=True)
        var = jnp.mean((h - mean) ** 2, -1, keepdims=True)
        h = (h - mean) * jax.lax.rsqrt(var + 1e-6) * rest[0] + rest[1]
        return np.asarray(jnp.where(h >= 0, h, 0.2 * h))

    for jchain, tchain, x, between in (
            (jq.quantize_generator(gv), tq.quantize_generator(tg),
             np.asarray(small_ds.spectra[:64]), relu),
            (jq.quantize_forward(fv), tq.quantize_forward(tf),
             np.asarray(small_ds.params_norm[:64]), ln_leaky)):
        jlayers = [*jchain[0], jchain[1]]
        tlayers = [*tchain[0], tchain[1]]
        inputs = _layer_inputs(*jchain, x, between)
        assert len(inputs) == len(tlayers) == len(jchain[0]) + 1
        for h, (jw_q, jsw, jb, *_), (w_q, sw, b, *_) in zip(inputs, jlayers, tlayers):
            jx_q, _ = jq._quantize_rows(jnp.asarray(h))
            jacc = jax.lax.dot_general(jx_q, jw_q, (((1,), (0,)), ((), ())),
                                       preferred_element_type=jnp.int32)
            x_q, _ = tq._quantize_rows(_t(h))
            assert np.array_equal(x_q.numpy(), np.asarray(jx_q))
            assert np.array_equal(tq.int_mm(x_q, w_q).numpy(), np.asarray(jacc))
            np.testing.assert_allclose(
                tq.qdense(_t(h), w_q, sw, b).numpy(),
                np.asarray(jq.qdense(jnp.asarray(h), jw_q, jsw, jb)), rtol=QDENSE_RTOL,
                atol=QDENSE_RTOL)


def test_int8_cycle_within_one_last_layer_step_of_jax(trio, small_ds):
    (_, _, gv, fv), (tg, tf), _ = trio
    x = np.asarray(small_ds.spectra[:64])
    jpn, jspec, jmet = (np.asarray(a) for a in jq.make_int8_cycle_fn(gv, fv, 250)(
        jnp.asarray(x)))
    pn, spec, met = (a.numpy() for a in tq.make_int8_cycle_fn(tg, tf, 250)(_t(x)))
    (g_layers, g_head), (f_layers, f_head) = jq.quantize_generator(gv), jq.quantize_forward(fv)

    def last_input(apply, chain, inp):
        """The JAX chain's input row to its head: (its scale sx, (B, 1))."""
        layers, head = chain
        h = inp
        for layer in layers:
            h = apply(layer, h)
        return np.asarray(jq._quantize_rows(h)[1])

    relu_layer = lambda l, h: jnp.maximum(jq.qdense(h, *l), 0.0)  # noqa: E731

    def ln_layer(l, h):
        w_q, sw, b, scale, bias = l
        h = jq.qdense(h, w_q, sw, b)
        mean = jnp.mean(h, -1, keepdims=True)
        var = jnp.mean((h - mean) ** 2, -1, keepdims=True)
        h = (h - mean) * jax.lax.rsqrt(var + 1e-6) * scale + bias
        return jnp.where(h >= 0, h, 0.2 * h)

    g_step = last_input(relu_layer, (g_layers, g_head), jnp.asarray(x)) * np.abs(
        np.asarray(g_head[0], np.float32) * np.asarray(g_head[1])).max(axis=0)
    f_step = last_input(ln_layer, (f_layers, f_head), jnp.asarray(jpn)) * np.abs(
        np.asarray(f_head[0], np.float32) * np.asarray(f_head[1])).max(axis=0)
    out = np.concatenate([spec, met], -1) - np.concatenate([jspec, jmet], -1)
    print(f"int8 cycle vs JAX: params_norm {np.abs(pn - jpn).max():.3e} "
          f"({(np.abs(pn - jpn) / g_step).max():.3f} of the bound), spectrum and metrics "
          f"{np.abs(out).max():.3e} ({(np.abs(out) / f_step).max():.3f} of the bound)")
    assert (np.abs(pn - jpn) <= g_step).all()
    assert (np.abs(out) <= f_step).all()


@pytest.mark.parametrize("b, k, n", [(1, 4, 256), (64, 256, 4), (1, 250, 512),
                                     (3, 256, 258), (17, 8, 8), (1, 4, 4), (33, 16, 8), (64, 1024, 512)])
def test_int_mm_padding_equals_unpadded_product(b, k, n):
    gen = torch.Generator().manual_seed(b * 1000 + k + n)
    x = torch.randint(-127, 128, (b, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    got = tq.int_mm(x, w)
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, n)
    assert torch.equal(got, (x.long() @ w.long()).to(torch.int32))


def test_int8_envelope_against_fp32(trio, small_ds):
    """The JAX package's accuracy contract (tests/test_quantized.py:70-83)
    on the port's own chains: the int8 cycle against the fp32 modules."""
    _, (tg, tf), tds = trio
    x = tds.spectra[:64].contiguous()
    pn8, spec8, met8 = tq.make_int8_cycle_fn(tg, tf, 250)(x)
    with torch.no_grad():
        pn32 = tg(x)
        spec32, met32 = tf(pn32)
    assert pn8.dtype == torch.float32
    assert float((pn8 - pn32).abs().max()) < 0.05
    for got, want in ((spec8, spec32), (met8, met32)):
        assert float((got - want).abs().max()) / (float(want.abs().max()) + 1e-6) < 0.10
    p8 = make_inverse_design_fn(tg, tf, tds, compute_dtype="int8")(x[:32])
    p32 = make_inverse_design_fn(tg, tf, tds)(x[:32])
    span = float((tds.param_hi - tds.param_lo).max())
    assert float((p8[0] - p32[0]).abs().max()) < 0.05 * span
    assert [t.shape for t in p8] == [t.shape for t in p32]


def test_int8_serving_is_the_cycle(trio, small_ds):
    """serve's int8 path is the int8 cycle, denormalised, on both sides; the
    cycles' distance is held above."""
    (g, f, gv, fv), (tg, tf), tds = trio
    x = np.asarray(small_ds.spectra[:32])
    got = make_inverse_design_fn(tg, tf, tds, compute_dtype=torch.int8)(_t(x))
    pn, spec, met = tq.make_int8_cycle_fn(tg, tf, 250)(_t(x))
    for a, b in zip(got, (denormalize_params(pn, tds.param_lo, tds.param_hi), spec, met)):
        assert torch.equal(a, b)
    want = j_make_inverse_design_fn(g, f, gv, fv, small_ds, compute_dtype="int8")(
        jnp.asarray(x))
    jpn, jspec, jmet = jq.make_int8_cycle_fn(gv, fv, 250)(jnp.asarray(x))
    # the JAX package's own serve path against its cycle: the same
    # operations, fused by XLA in another order
    for a, b in zip(want, (j_denormalize(jpn, small_ds.param_lo, small_ds.param_hi),
                           jspec, jmet)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=QDENSE_RTOL, atol=1e-6)


@pytest.mark.parametrize("which", ["generator", "forward_model"])
def test_int8_rejects_other_layouts(which):
    """An enhanced or otherwise non-baseline model is refused, not mis-wired."""
    if which == "generator":
        model = build_generator(GeneratorConfig(norm="layer"), device="cpu")
        with pytest.raises(ValueError, match="baseline MLPGenerator"):
            tq.quantize_generator(model)
    else:
        model = nn.Sequential(nn.Linear(4, 8), nn.LayerNorm(8), nn.Linear(8, 258))
        with pytest.raises(ValueError, match="baseline ForwardMLP"):
            tq.quantize_forward(model)
    cfg = t_default_config()
    assert dataclasses.asdict(cfg.generator)["norm"] == "batch"
