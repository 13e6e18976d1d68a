"""The port's exported serving artifacts (``serve.export_*`` and
``load_exported``: ``torch.export`` programs, ``.pt2``) on the CPU.

- Every artifact kind (generator, surrogate, designer, ensemble designer;
  fp32, bf16, int8, and the fused-kernel ``use_pallas`` surrogate and
  designer, which call the kernels' custom ops and so run their plain
  versions here) round-trips: written, loaded with ``load_exported(...,
  device="cpu")`` and run, within ROUNDTRIP_TOL of the in-process function
  on the same weights (measured: equal).  Tolerances are absolute, scaled
  by an output's largest magnitude where that exceeds 1.
- The portable artifacts (fp32 and int8) against the JAX package's
  StableHLO artifacts on the same weights (JAX-initialised, carried over),
  run with its ``load_exported`` on the CPU: within JAX_TOL (fp32 products
  summed in another order).
- A wrong batch raises; the ``use_pallas`` graph holds
  ``pigan_thz::fused_dense_chain`` and ``pigan_thz::fused_mlp_forward``;
  ``use_pallas`` with a dtype raises as the JAX package's does.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch import serve
from pigan_thz_torch.data import build_dataset
from pigan_thz_torch.interop import from_flax
from pigan_thz_torch.models import build_forward_model, build_generator
from pigan_thz_torch.ops import fused_kernels as fk
from pigan_thz_torch.ops import quantized as tq
from pigan_thz_tpu import serve as jserve
from pigan_thz_tpu.models import build_trio

torch.set_num_threads(1)

B = 8
ROUNDTRIP_TOL = 1e-5
JAX_TOL = 1e-5


@pytest.fixture(scope="module")
def trio(cfg, small_ds):
    g, _, f = build_trio(cfg)
    gvs = []
    for k in jax.random.split(jax.random.PRNGKey(5), 2):
        gv = dict(g.init(k, small_ds.spectra[:2], train=False))
        gv["batch_stats"] = jax.tree.map(
            lambda a: a + 0.1 * jax.random.normal(k, a.shape) ** 2, gv["batch_stats"])
        gvs.append(gv)
    k = jax.random.PRNGKey(0)
    fv = f.init({"params": k, "dropout": k}, small_ds.params_norm[:2], train=False)
    tcfg = t_default_config()
    tgs = []
    for gv in gvs:
        tg = build_generator(tcfg.generator, device="cpu")
        tg.load_state_dict(from_flax(jax.tree.map(np.asarray, gv), "generator"))
        tgs.append(tg.eval())
    tf = build_forward_model(tcfg.forward_model, device="cpu")
    tf.load_state_dict(from_flax(jax.tree.map(np.asarray, fv), "forward_model"))
    tds = build_dataset(
        np.asarray(small_ds.spectra), np.asarray(small_ds.params),
        np.asarray(small_ds.metrics), tcfg.data,
        frequencies=np.asarray(small_ds.frequencies), device="cpu")
    return (g, f, gvs, fv), (tgs, tf.eval()), tds


def _close(got, want, tol):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max()), np.abs(a - b).max()


# (artifact, use_pallas, compute_dtype)
KINDS = [
    ("designer", False, None), ("designer", False, torch.bfloat16), ("designer", False, "int8"),
    ("designer", True, None),
    ("generator", False, None), ("generator", False, "bfloat16"),
    ("surrogate", False, None), ("surrogate", False, torch.bfloat16),
    ("surrogate", False, "int8"), ("surrogate", True, None),
    ("ensemble", False, None), ("ensemble", False, torch.bfloat16),
]


def _in_process(kind, use_pallas, dtype, tgs, tf, tds):
    """The function each artifact bakes, run in this process."""
    if kind == "designer":
        return serve.make_inverse_design_fn(tgs[0], tf, tds, use_pallas=use_pallas,
                                            compute_dtype=dtype)
    if kind == "ensemble":
        return serve.make_ensemble_inverse_design_fn(tgs, tf, tds, compute_dtype=dtype)
    if kind == "generator":
        g = serve._designer(tgs[0], tf, tds, False, dtype).generator
        return lambda x: serve.denormalize_params(g(x), tds.param_lo, tds.param_hi)
    if serve.serving_dtype(dtype) == "int8":
        return lambda x: tq.int8_forward_apply(tq.quantize_forward(tf), x, 250)
    if use_pallas:
        packed = fk.pack_forward_model(tf)
        return lambda x: fk.forward_surrogate_fused(packed, x)
    return serve._designer(tgs[0], tf, tds, False, dtype).surrogate


def _export(kind, use_pallas, dtype, tgs, tf, tds, path):
    if kind == "designer":
        return serve.export_inverse_design(tgs[0], tf, tds, path, B, use_pallas=use_pallas,
                                           compute_dtype=dtype)
    if kind == "ensemble":
        return serve.export_ensemble_inverse_design(tgs, tf, tds, path, B, compute_dtype=dtype)
    if kind == "generator":
        return serve.export_generator(tgs[0], tds, path, B, compute_dtype=dtype)
    return serve.export_forward_surrogate(tf, tds, path, B, use_pallas=use_pallas,
                                          compute_dtype=dtype)


@pytest.mark.parametrize("kind, use_pallas, dtype", KINDS,
                         ids=[f"{k}-{'pallas' if p else d}" for k, p, d in KINDS])
def test_artifact_roundtrip(kind, use_pallas, dtype, trio, tmp_path):
    _, (tgs, tf), tds = trio
    path = _export(kind, use_pallas, dtype, tgs, tf, tds, str(tmp_path / f"{kind}.pt2"))
    assert path.endswith(".pt2") and os.path.getsize(path) > 0
    fn = serve.load_exported(path, device="cpu")
    x = (tds.params_norm if kind == "surrogate" else tds.spectra)[:B].contiguous()
    before = dict(fk.LAUNCHES)
    got = fn(x)
    assert fk.LAUNCHES == before
    with torch.inference_mode():
        want = _in_process(kind, use_pallas, dtype, tgs, tf, tds)(x)
    _close(got, want, ROUNDTRIP_TOL)
    for t in (got if isinstance(got, tuple) else (got,)):
        assert t.dtype == torch.float32 and t.device.type == "cpu"
    with pytest.raises(ValueError, match="exported for inputs"):
        fn(x[: B // 2])


def _jax_artifact(kind, dtype, g, f, gvs, fv, ds, path):
    jd = {"int8": "int8"}.get(dtype)
    if kind == "designer":
        return jserve.export_inverse_design(g, f, gvs[0], fv, ds, path, B, compute_dtype=jd)
    if kind == "generator":
        return jserve.export_generator(g, gvs[0], ds, path, B)
    if kind == "surrogate":
        return jserve.export_forward_surrogate(f, fv, ds, path, B, compute_dtype=jd)
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *gvs)
    return jserve.export_ensemble_inverse_design(g, f, stacked, fv, ds, path, B)


PORTABLE = [("designer", None), ("designer", "int8"), ("generator", None),
            ("surrogate", None), ("surrogate", "int8"), ("ensemble", None)]


@pytest.mark.parametrize("kind, dtype", PORTABLE, ids=[f"{k}-{d}" for k, d in PORTABLE])
def test_portable_artifact_matches_jax_artifact(kind, dtype, trio, small_ds, tmp_path):
    (g, f, gvs, fv), (tgs, tf), tds = trio
    mine = serve.load_exported(
        _export(kind, False, dtype, tgs, tf, tds, str(tmp_path / "mine.pt2")), device="cpu")
    theirs = jserve.load_exported(
        _jax_artifact(kind, dtype, g, f, gvs, fv, small_ds, str(tmp_path / "j.stablehlo")))
    x = np.asarray((small_ds.params_norm if kind == "surrogate" else small_ds.spectra)[:B])
    _close(mine(torch.from_numpy(x)), theirs(jnp.asarray(x)), JAX_TOL)


def test_pallas_graph_calls_the_kernels_custom_ops(trio, tmp_path):
    _, (tgs, tf), tds = trio
    path = serve.export_inverse_design(tgs[0], tf, tds, str(tmp_path / "d.pt2"), B,
                                       use_pallas=True)
    program = torch.export.load(path)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert "pigan_thz.fused_dense_chain.default" in targets
    assert "pigan_thz.fused_mlp_forward.default" in targets
    assert targets.index("pigan_thz.fused_dense_chain.default") < targets.index(
        "pigan_thz.fused_mlp_forward.default")
    portable = torch.export.load(serve.export_inverse_design(
        tgs[0], tf, tds, str(tmp_path / "p.pt2"), B))
    assert not any("pigan_thz" in str(n.target) for n in portable.graph.nodes)


def test_custom_ops_equal_the_wrappers_on_the_cpu(trio):
    _, (tgs, tf), tds = trio
    gp, fp = fk.pack_generator(tgs[0]), fk.pack_forward_model(tf)
    x = tds.spectra[:5].contiguous()
    pn = torch.ops.pigan_thz.fused_dense_chain(x, gp.weights, *fk.packed_op_args(gp))
    assert torch.equal(pn, fk.fused_dense_chain(x, gp))
    out = torch.ops.pigan_thz.fused_mlp_forward(pn, fp.weights, *fk.packed_op_args(fp),
                                                0.2, 1e-6)
    assert torch.equal(out, fk.fused_mlp_forward(pn, fp))
    # the wrappers' checks hold inside the ops
    with pytest.raises(TypeError, match="float32"):
        torch.ops.pigan_thz.fused_dense_chain(x.double(), gp.weights, *fk.packed_op_args(gp))


def test_export_refusals(trio, tmp_path):
    _, (tgs, tf), tds = trio
    path = str(tmp_path / "x.pt2")
    for dtype in ("int8", torch.bfloat16):
        with pytest.raises(ValueError, match="mutually exclusive"):
            serve.export_forward_surrogate(tf, tds, path, B, use_pallas=True, compute_dtype=dtype)
        with pytest.raises(ValueError, match="mutually exclusive"):
            serve.export_inverse_design(tgs[0], tf, tds, path, B, use_pallas=True,
                                        compute_dtype=dtype)
    with pytest.raises(ValueError, match="int8"):
        serve.export_generator(tgs[0], tds, path, B, compute_dtype="int8")
    with pytest.raises(ValueError, match="int8"):
        serve.export_ensemble_inverse_design(tgs, tf, tds, path, B, compute_dtype="int8")
    assert not os.path.exists(path)
