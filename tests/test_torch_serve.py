"""The port's serving cycle against the JAX package's, on the CPU.  The
cycle on the card is in test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.config import GeneratorConfig
from pigan_thz_torch.data import build_dataset, denormalize_params
from pigan_thz_torch.interop import from_flax
from pigan_thz_torch.models import build_forward_model, build_generator
from pigan_thz_torch.ops import fused_kernels as fk
from pigan_thz_torch.serve import make_inverse_design_fn
from pigan_thz_tpu.models import build_trio
from pigan_thz_tpu.serve import make_inverse_design_fn as j_make_inverse_design_fn

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trio(cfg, small_ds):
    """JAX-initialised G (non-trivial BatchNorm stats) and F, the same
    weights in the port's modules, and the dataset in both packages."""
    g, _, f = build_trio(cfg)
    k = jax.random.PRNGKey(0)
    gv = dict(g.init(k, small_ds.spectra[:2], train=False))
    gv["batch_stats"] = jax.tree.map(
        lambda a: a + 0.1 * jax.random.normal(k, a.shape) ** 2, gv["batch_stats"]
    )
    fv = f.init({"params": k, "dropout": k}, small_ds.params_norm[:2], train=False)
    tcfg = t_default_config()
    tg = build_generator(tcfg.generator, device="cpu")
    tg.load_state_dict(from_flax(jax.tree.map(np.asarray, gv), "generator"))
    tf = build_forward_model(tcfg.forward_model, device="cpu")
    tf.load_state_dict(from_flax(jax.tree.map(np.asarray, fv), "forward_model"))
    tds = build_dataset(
        np.asarray(small_ds.spectra), np.asarray(small_ds.params),
        np.asarray(small_ds.metrics), tcfg.data,
        frequencies=np.asarray(small_ds.frequencies), device="cpu",
    )
    return (g, f, gv, fv), (tg.eval(), tf.eval()), tds


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
def test_cycle_matches_jax(use_pallas, trio, small_ds):
    (g, f, gv, fv), (tg, tf), tds = trio
    jfn = j_make_inverse_design_fn(
        g, f, gv, fv, small_ds, use_pallas=use_pallas, pallas_interpret=use_pallas
    )
    x = np.array(small_ds.spectra[:16])
    want = jfn(jnp.asarray(x))
    got = make_inverse_design_fn(tg, tf, tds)(torch.from_numpy(x))
    assert [tuple(t.shape) for t in got] == [(16, 4), (16, 250), (16, 8)]
    for name, a, b, atol in zip(("params", "spectrum", "metrics"), got, want,
                                (2e-5, 1e-4, 1e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=0,
                                   err_msg=name)


def test_cycle_equals_unfused_modules_and_launches_nothing_on_cpu(trio, small_ds):
    _, (tg, tf), tds = trio
    x = torch.from_numpy(np.array(small_ds.spectra[:40]))
    before = dict(fk.LAUNCHES)
    params, spec, met = make_inverse_design_fn(tg, tf, tds)(x)
    assert fk.LAUNCHES == before
    with torch.no_grad():
        pn = tg(x)
        ref_s, ref_m = tf(pn)
    ref_p = denormalize_params(pn, tds.param_lo, tds.param_hi)
    for got, want in ((params, ref_p), (spec, ref_s), (met, ref_m)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert float(params.min()) >= 2.2 and float(params.max()) <= 2.8


def test_compute_dtype_not_ported(trio):
    _, (tg, tf), tds = trio
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_inverse_design_fn(tg, tf, tds, compute_dtype=torch.bfloat16)


def test_non_baseline_generator_refused(trio):
    _, (_, tf), tds = trio
    g_layer = build_generator(GeneratorConfig(norm="layer"), device="cpu")
    with pytest.raises(ValueError):
        make_inverse_design_fn(g_layer, tf, tds)
