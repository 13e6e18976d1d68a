"""The serving dtype ladder of ``pigan_thz_torch/serve.py`` against the JAX
package's (pigan_thz_tpu/serve.py), on the CPU, at the baseline trio's full
widths with JAX-initialised weights (G's BatchNorm stats perturbed):

- bf16: the cycle and the ensemble mean through the models' bf16 twins
  against the JAX package's ``compute_dtype=jnp.bfloat16`` paths run op by
  op (``jax.disable_jit``: flax's rounding after every op, which the twins
  follow), each output within MODEL_RTOL of its largest magnitude (the
  eager bf16 models' bound, tests/test_torch_bf16.py; a bf16 value carries
  8 bits, and where the two packages' fp32 sums differ by an ulp a rounding
  lands on the other neighbour).  The JAX package's jitted cycle is
  another rounding of the same function: XLA fuses the bias add into the
  product and skips a bf16 rounding, and it sits 2.3e-2 of the largest
  spectrum value from its own op-by-op cycle on these weights; it is held
  within that spread plus MODEL_RTOL;
- int8: the JAX package's ladder contract (tests/test_quantized.py:76-84)
  on the port, and the JAX package's int8 cycle within INT8_RTOL (the
  bound tests/test_torch_quantized.py derives holds far inside it);
- the dtypes' arguments: ``torch.bfloat16`` and "bfloat16", "int8" and
  ``torch.int8``; ``use_pallas`` with a dtype, an unknown dtype and int8
  ensembles raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.data import build_dataset
from pigan_thz_torch.interop import from_flax
from pigan_thz_torch.models import build_forward_model, build_generator
from pigan_thz_torch.ops import fused_kernels as fk
from pigan_thz_torch.serve import make_ensemble_inverse_design_fn, make_inverse_design_fn
from pigan_thz_tpu.models import build_trio
from pigan_thz_tpu.serve import make_ensemble_inverse_design_fn as j_make_ensemble
from pigan_thz_tpu.serve import make_inverse_design_fn as j_make_inverse_design_fn

torch.set_num_threads(1)

MODEL_RTOL = 2e-2
INT8_RTOL = 1e-5
MEMBERS = 3


def _perturbed(gv, key):
    gv = dict(gv)
    gv["batch_stats"] = jax.tree.map(
        lambda a: a + 0.1 * jax.random.normal(key, a.shape) ** 2, gv["batch_stats"])
    return gv


def _port_generator(gv):
    g = build_generator(t_default_config().generator, device="cpu")
    g.load_state_dict(from_flax(jax.tree.map(np.asarray, gv), "generator"))
    return g.eval()


@pytest.fixture(scope="module")
def trio(cfg, small_ds):
    g, _, f = build_trio(cfg)
    keys = jax.random.split(jax.random.PRNGKey(3), MEMBERS)
    gvs = [_perturbed(g.init(k, small_ds.spectra[:2], train=False), k) for k in keys]
    k = jax.random.PRNGKey(0)
    fv = f.init({"params": k, "dropout": k}, small_ds.params_norm[:2], train=False)
    tf = build_forward_model(t_default_config().forward_model, device="cpu")
    tf.load_state_dict(from_flax(jax.tree.map(np.asarray, fv), "forward_model"))
    tds = build_dataset(
        np.asarray(small_ds.spectra), np.asarray(small_ds.params),
        np.asarray(small_ds.metrics), t_default_config().data,
        frequencies=np.asarray(small_ds.frequencies), device="cpu")
    return (g, f, gvs, fv), ([_port_generator(gv) for gv in gvs], tf.eval()), tds


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, "bfloat16"])
def test_bf16_cycle_matches_jax(dtype, trio, small_ds):
    (g, f, gvs, fv), (tgs, tf), tds = trio
    x = np.asarray(small_ds.spectra[:64])
    got = make_inverse_design_fn(tgs[0], tf, tds, compute_dtype=dtype)(torch.from_numpy(x))
    jfn = j_make_inverse_design_fn(g, f, gvs[0], fv, small_ds, compute_dtype=jnp.bfloat16)
    with jax.disable_jit():
        want = jfn(jnp.asarray(x))
    jitted = jfn(jnp.asarray(x))
    for name, a, b, c in zip(("params", "spectrum", "metrics"), got, want, jitted):
        assert a.dtype == torch.float32, name
        assert _rel(a, b) <= MODEL_RTOL, (name, _rel(a, b))
        spread = _rel(torch.from_numpy(np.asarray(b, np.float32)), c)
        assert _rel(a, c) <= spread + MODEL_RTOL, (name, _rel(a, c), spread)
    # and it is bf16, not fp32: it sits off the fp32 cycle by bf16's rounding
    fp32 = make_inverse_design_fn(tgs[0], tf, tds)(torch.from_numpy(x))
    assert _rel(got[1], fp32[1].numpy()) > 1e-3


def test_bf16_ensemble_mean_matches_jax(trio, small_ds):
    (g, f, gvs, fv), (tgs, tf), tds = trio
    x = np.asarray(small_ds.spectra[:64])
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *gvs)
    with jax.disable_jit():
        want = j_make_ensemble(g, f, stacked, fv, small_ds, compute_dtype=jnp.bfloat16)(
            jnp.asarray(x))
    got = make_ensemble_inverse_design_fn(tgs, tf, tds, compute_dtype=torch.bfloat16)(
        torch.from_numpy(x))
    for name, a, b in zip(("params", "spectrum", "metrics"), got, want):
        assert a.dtype == torch.float32 and _rel(a, b) <= MODEL_RTOL, name


@pytest.mark.parametrize("dtype", ["int8", torch.int8])
def test_int8_cycle_follows_the_ladder(dtype, trio, small_ds):
    """tests/test_quantized.py:76-84 on the port, and the JAX int8 cycle."""
    (g, f, gvs, fv), (tgs, tf), tds = trio
    x = np.asarray(small_ds.spectra[:32])
    p8, s8, m8 = make_inverse_design_fn(tgs[0], tf, tds, compute_dtype=dtype)(
        torch.from_numpy(x))
    p32, s32, m32 = make_inverse_design_fn(tgs[0], tf, tds)(torch.from_numpy(x))
    span = float((tds.param_hi - tds.param_lo).max())
    assert float((p8 - p32).abs().max()) < 0.05 * span
    assert p8.shape == p32.shape and s8.shape == s32.shape and m8.shape == m32.shape
    want = j_make_inverse_design_fn(g, f, gvs[0], fv, small_ds, compute_dtype="int8")(
        jnp.asarray(x))
    for a, b in zip((p8, s8, m8), want):
        assert _rel(a, b) <= INT8_RTOL


def test_dtype_paths_launch_nothing_on_the_cpu(trio, small_ds):
    _, (tgs, tf), tds = trio
    before = dict(fk.LAUNCHES)
    for dtype in (None, torch.bfloat16, "int8"):
        make_inverse_design_fn(tgs[0], tf, tds, compute_dtype=dtype)(tds.spectra[:4])
    make_ensemble_inverse_design_fn(tgs, tf, tds, compute_dtype="bfloat16")(tds.spectra[:4])
    assert fk.LAUNCHES == before


def test_dtype_arguments_refused(trio):
    _, (tgs, tf), tds = trio
    for dtype in (torch.bfloat16, "int8"):
        with pytest.raises(ValueError, match="mutually exclusive"):
            make_inverse_design_fn(tgs[0], tf, tds, use_pallas=True, compute_dtype=dtype)
    with pytest.raises(ValueError, match="compute_dtype"):
        make_inverse_design_fn(tgs[0], tf, tds, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="int8"):
        make_ensemble_inverse_design_fn(tgs, tf, tds, compute_dtype=torch.int8)


def test_fp32_paths_agree(trio, small_ds):
    """fp32 through the kernels (their plain versions here) and through the
    modules' forward: the same function, other summation orders."""
    _, (tgs, tf), tds = trio
    x = tds.spectra[:16].contiguous()
    fused = make_inverse_design_fn(tgs[0], tf, tds)(x)
    modules = make_inverse_design_fn(tgs[0], tf, tds, use_pallas=False)(x)
    for a, b in zip(fused, modules):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
