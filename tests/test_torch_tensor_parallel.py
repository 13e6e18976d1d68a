"""Tensor parallelism over a model axis, on the CPU: the port against one
rank and against the JAX package's (data, model) mesh program.

``tests/test_torch_tp_ranks.py`` (torch and the port only) runs on
``make_mesh(data=1, model=2)`` and ``make_mesh(data=2, model=2)`` gloo ranks
in worker processes started by the module fixture, with ``min_shard_dim``
lowered to 16 so that every hidden layer of the narrow trio is split (G
48-24, D 40-20, F 16-32-48-32-16; 128 samples, B = 32, 2 epochs of 4
steps); the same functions run here with no mesh for world 1, and the JAX
side runs here on four of the eight virtual CPU devices
(``tests/conftest.py``): ``make_parallel_multi_epoch_fn`` over
``make_mesh(data=2, model=2)`` with the state placed by ``shard_state(...,
min_shard_dim=16)``.  The placement rule is held at full width, leaf by
leaf, against the JAX package's ``param_partition_spec``.

Tolerances (float32 on every side; the split layers sum their products and
LayerNorm's rows in other orders):
- the first step: metric rows and Adam's first moments (the gradient) of
  every model within FIRST_TOL (rtol and atol) of world 1's and of JAX's;
- two epochs and the Trainer's 3 + 3 epochs: rows within EPOCHS_RTOL of
  world 1's (and the JAX mesh program's within
  tests/test_torch_gan_step.py's trajectory tolerance JAX_ROWS_RTOL);
- a clip norm that counts the replicated leaves M times moves a first
  moment by more than FAULT_SEEN times FIRST_TOL (measured ~50 at M = 2);
- FlopCounterMode on one rank: the split layers' products at 1/M, the
  replicated ones whole, exactly;
- the residual G and the spectral-norm dual-encoder D (no split path, their
  split leaves gathered a call): the first step within FIRST_TOL.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel as P
import test_torch_ranks as torch_ranks
import test_torch_tp_ranks as tp_ranks
from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.data.dataset import ThzDataset
from pigan_thz_torch.interop import _layer_map
from pigan_thz_torch.models import build_trio as t_build_trio
from pigan_thz_torch.models.registry import build_generator
from pigan_thz_torch.parallel import MODEL_AXIS, Mesh, state_shardings
from pigan_thz_torch.parallel.tensor import module_leaves, param_partition_spec
from pigan_thz_torch.train import checkpoint as ckpt
from pigan_thz_torch.train.state import init_pigan_state, make_optimizers
from pigan_thz_torch.train.trainer import Trainer
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.data.dataset import build_dataset as j_build_dataset
from pigan_thz_tpu.data.dataset import epoch_indices as j_epoch_indices
from pigan_thz_tpu.models import build_trio as j_build_trio
from pigan_thz_tpu.models.generator import ResidualGenerator as JResidualGenerator
from pigan_thz_tpu.parallel import make_mesh as j_make_mesh
from pigan_thz_tpu.parallel import make_parallel_multi_epoch_fn as j_parallel_fn
from pigan_thz_tpu.parallel.sharding import param_partition_spec as j_spec
from pigan_thz_tpu.parallel.sharding import shard_state as j_shard_state
from pigan_thz_tpu.train.state import init_pigan_state as j_init_pigan_state
from pigan_thz_tpu.train.state import make_optimizers as j_make_optimizers
from pigan_thz_tpu.train.steps import StepSettings as JSettings
from pigan_thz_tpu.train.steps import make_pigan_step as j_make_pigan_step

torch.set_num_threads(1)

WORKER = os.path.join(P.REPO, "tests", "test_torch_tp_ranks.py")
N, B, E, SPE = P.N, P.B, P.E, P.SPE
MIN_SHARD = 16
MESHES = ((1, 2), (2, 2))
FIRST_TOL = 1e-5
EPOCHS_RTOL = 1e-4
JAX_ROWS_RTOL = P.JAX_ROWS_RTOL
FAULT_SEEN = 10.0
WORKER_TIMEOUT = 240


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    tc = P._narrow(t_default_config())
    raw = synthetic_dataset(tc.data, device="cpu")
    jc = P._narrow(j_default_config())
    jds = j_build_dataset(raw.spectra.numpy(), raw.params.numpy(), raw.metrics.numpy(),
                          jc.data)
    tds = ThzDataset(*(torch.from_numpy(np.array(x, np.float32)) for x in jds))
    g, d, f = j_build_trio(jc)
    g_tx, d_tx, f_tx = j_make_optimizers(jc, SPE)
    key = jax.random.PRNGKey(11)
    idx = np.stack([np.asarray(j_epoch_indices(k, N, B)) for k in jax.random.split(key, E)])
    from pigan_thz_tpu.train.state import init_forward_state as j_init_forward_state

    fwd = P._forward_payload(j_init_forward_state(f, f_tx, jax.random.PRNGKey(2)))
    inputs = {
        "overrides": P.OVERRIDES, "ds": tuple(tds),
        "pigan": P._pigan_payload(j_init_pigan_state(g, d, f, g_tx, d_tx,
                                                     jax.random.PRNGKey(1))),
        "forward": fwd, "forward_nodrop": fwd,
        "indices": torch.from_numpy(idx).to(torch.int64),
        "seeds": torch.arange(E * SPE, dtype=torch.int64) * 7919 + 13,
        "min_shard_dim": MIN_SHARD,
    }
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    procs = {}
    for data, model in MESHES:
        d_ = root / f"mesh{data}x{model}"
        d_.mkdir()
        torch.save(inputs, d_ / "inputs.pt")
        procs[(data, model)] = subprocess.Popen(
            [sys.executable, WORKER, str(data), str(model), str(d_)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        world1 = tp_ranks.run_all(inputs, None, str(root / "models1"))
        jax_out = _jax_mesh_run(jds, key)
        logs = {m: p.communicate(timeout=WORKER_TIMEOUT)[0] for m, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for m, p in procs.items():
        assert p.returncode == 0, f"mesh {m} exited {p.returncode}:\n{logs[m][-4000:]}"
    ranks = {m: [torch.load(root / f"mesh{m[0]}x{m[1]}" / f"rank{r}.pt", weights_only=False)
                 for r in range(m[0] * m[1])] for m in procs}
    return dict(w1=world1, jax=jax_out, ranks=ranks, root=root)


def _jax_mesh_run(jds, key):
    """The JAX package's PI-GAN program over a (data 2, model 2) mesh of
    virtual devices, its state split by the same rule: two epochs."""
    jmesh = j_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    jc = P._narrow(j_default_config())
    g, d, f = j_build_trio(jc)
    g_tx, d_tx, _ = j_make_optimizers(jc, SPE)
    step = j_make_pigan_step(g, d, f, g_tx, d_tx, JSettings(detach_forward=False),
                             jds.param_lo, jds.param_hi)
    fn = j_parallel_fn(step, B, jmesh, with_scale=True, unroll=1)
    jst = j_shard_state(j_init_pigan_state(g, d, f, g_tx, d_tx, jax.random.PRNGKey(1)),
                        jmesh, min_shard_dim=MIN_SHARD)
    kernel = jst.f.params["MLPBlock_2"]["Dense_0"]["kernel"]
    assert MODEL_AXIS in str(kernel.sharding.spec)
    jst, rows = fn(jst, jds, key, jnp.ones(E))
    return {"pigan_epochs": (P._pigan_payload(jst), P._rows(rows))}


# ---------------------------------------------------------------------------
# The placement rule at full width
# ---------------------------------------------------------------------------


def _flax_leaves(module, params_tree, stats_tree=None):
    """[(torch name, flax shape)] of ``module``'s parameters and BatchNorm
    stats through its layer map (``interop.py``)."""
    out = []
    for prefix, path, kind in _layer_map(module):
        node = params_tree
        for p in path.split("/"):
            node = node[p]
        if kind in ("linear", "spectral"):
            out += [(f"{prefix}.weight", node["kernel"].shape),
                    (f"{prefix}.bias", node["bias"].shape)]
        elif kind in ("layernorm", "batchnorm"):
            out += [(f"{prefix}.weight", node["scale"].shape),
                    (f"{prefix}.bias", node["bias"].shape)]
            if kind == "batchnorm" and stats_tree is not None:
                s = stats_tree
                for p in path.split("/"):
                    s = s[p]
                out += [(f"{prefix}.running_mean", s["mean"].shape),
                        (f"{prefix}.running_var", s["var"].shape)]
    return out


def _torch_spec_of_flax(flax_spec, name, ndim):
    """The JAX spec of a leaf in the torch layout (a kernel transposed)."""
    spec = tuple(flax_spec)
    if name.endswith(".weight") and ndim == 2:
        spec = tuple(reversed(spec)) if spec else ()
    return spec


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("role", ["generator", "discriminator", "forward_model", "residual"])
def test_every_leaf_spec_equals_jax_at_full_width(role, model_size):
    """Every parameter and BatchNorm stat of the full-width trio (and of the
    residual generator, whose 512 x 512 kernels tie) gets the spec the JAX
    package's rule gives its flax leaf."""
    cfg, jcfg = t_default_config(), j_default_config()
    if role == "residual":
        import dataclasses

        cfg = cfg.replace(generator=dataclasses.replace(cfg.generator, name="residual"))
        module = build_generator(cfg.generator, 250, 4, device="cpu")
        jmod = JResidualGenerator()
        variables = jmod.init({"params": jax.random.PRNGKey(0),
                               "dropout": jax.random.PRNGKey(1)},
                              jnp.zeros((2, 250)), train=False)
    else:
        g, d, f = t_build_trio(cfg, device="cpu")
        module = {"generator": g, "discriminator": d, "forward_model": f}[role]
        jg, jd, jf = j_build_trio(jcfg)
        jmod = {"generator": jg, "discriminator": jd, "forward_model": jf}[role]
        args = {"generator": (jnp.zeros((2, 250)),),
                "discriminator": (jnp.zeros((2, 250)), jnp.zeros((2, 4))),
                "forward_model": (jnp.zeros((2, 4)),)}[role]
        variables = jmod.init({"params": jax.random.PRNGKey(0),
                               "dropout": jax.random.PRNGKey(1)}, *args, train=False)
    params, buffers = module_leaves(module, model_size, 512)
    got = {leaf.name: leaf.torch_spec for leaf in params + buffers}
    want = _flax_leaves(module, variables["params"], variables.get("batch_stats"))
    assert want and {n for n, _ in want} <= set(got)
    split = 0
    for name, shape in want:
        expect = _torch_spec_of_flax(j_spec(None, np.empty(shape), model_size, 512), name,
                                     len(shape))
        assert got[name] == expect, (name, shape, got[name], expect)
        split += bool(expect)
    assert split, "the rule splits some leaf at full width"


def test_state_shardings_cover_every_leaf_of_a_state():
    """state_shardings names every leaf of a PiGanState's state_dict (the
    flat buffers' parameters, the moments, the stats); F's 1024-wide
    kernels split, the first layer and the head replicated (M = 2)."""
    cfg = t_default_config()
    g, d, f = t_build_trio(cfg, device="cpu")
    g_tx, d_tx, _ = make_optimizers(cfg, 15)
    st = init_pigan_state(g, d, f, g_tx, d_tx, 0, device="cpu")
    mesh = Mesh(rank=0, size=2, device=torch.device("cpu"), backend="gloo", model=2)
    specs = state_shardings(st, mesh)
    for key in ("g_params", "g_opt.m", "g_opt.v", "d_params", "f_params"):
        assert key not in specs
    assert specs["f_params/model.8.weight"] == (MODEL_AXIS, None)       # 512 -> 1024: out
    assert specs["f_params/model.12.weight"] == (None, MODEL_AXIS)      # 1024 -> 512: in
    assert specs["f_params/model.0.weight"] == ()
    assert specs["f_params/model.20.weight"] == ()
    assert specs["g_opt.m/main.0.weight"] == specs["g_params/main.0.weight"] == (
        MODEL_AXIS, None)
    assert specs["g.main.1.running_mean"] == (MODEL_AXIS,)
    assert specs["step"] == () and specs["generator"] == ()
    assert param_partition_spec(None, (512, 256), 1, 512) == ()


# ---------------------------------------------------------------------------
# Over the ranks against world 1 and JAX
# ---------------------------------------------------------------------------


def _flat_rows(rows):
    return {k: v.reshape(-1) for k, v in rows.items()}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", ["pigan", "forward", "forward_nodrop"])
def test_first_step_matches_world1(case, mesh, runs):
    """The first step over the mesh: rows and every model's Adam first
    moments within FIRST_TOL of world 1's; every rank holds the same whole
    state."""
    want_state, want_rows = runs["w1"][f"{case}_first"]
    for out in runs["ranks"][mesh]:
        state, rows = out[f"{case}_first"]
        P._allclose(_flat_rows(rows), _flat_rows(want_rows), want_rows, FIRST_TOL, FIRST_TOL,
                    f"mesh {mesh} rows vs world 1")
        P._allclose(state, want_state, P._moments(want_state), FIRST_TOL, FIRST_TOL,
                    f"mesh {mesh} moments vs world 1")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", ["pigan", "forward", "forward_nodrop"])
def test_two_epochs_match_world1(case, mesh, runs):
    state, rows = runs["ranks"][mesh][0][f"{case}_epochs"]
    want_state, want_rows = runs["w1"][f"{case}_epochs"]
    P._allclose(rows, want_rows, want_rows, EPOCHS_RTOL, 1e-6, f"mesh {mesh} rows")
    for k in ("d_params", "params", "f_params"):
        if k in want_state:
            np.testing.assert_allclose(state[k].numpy(), want_state[k].numpy(), rtol=0,
                                       atol=P.EPOCHS_PARAM_ATOL, err_msg=f"{case} {k}")


def test_two_epochs_match_the_jax_mesh_program(runs):
    """(data 2, model 2): the port's rows against the JAX mesh program's."""
    _, j_rows = runs["jax"]["pigan_epochs"]
    _, rows = runs["ranks"][(2, 2)][0]["pigan_epochs"]
    for k, want in j_rows.items():
        atol = 1.0 / (SPE * B) if k in ("d_accuracy", "violation_rate") else 1e-6
        np.testing.assert_allclose(rows[k].numpy(), want.numpy(), rtol=JAX_ROWS_RTOL,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("mesh", MESHES)
def test_trainer_over_the_mesh_matches_world1(mesh, runs):
    """Trainer(mesh=make_mesh(data, model)): 3 + 3 epochs, every history row
    within EPOCHS_RTOL of world 1's; rank 0 wrote the finals and the
    checkpoints."""
    h, h1 = runs["ranks"][mesh][0]["trainer_history"], runs["w1"]["trainer_history"]
    assert set(h) == set(h1) and len(h["pigan/g_loss"]) == tp_ranks.TRAINER_EPOCHS
    for k in h1:
        np.testing.assert_allclose(h[k], h1[k], rtol=EPOCHS_RTOL, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mesh", MESHES)
def test_split_checkpoints_load_at_world1(mesh, runs):
    """The finals and the last checkpoint written over the mesh load into a
    world-1 trainer: its state is the mesh's whole state, and its evaluation
    the mesh's."""
    models = str(runs["root"] / f"mesh{mesh[0]}x{mesh[1]}" / "models")
    inp = {"overrides": P.OVERRIDES}
    cfg = torch_ranks.config(inp)
    ds = synthetic_dataset(P._narrow(t_default_config()).data, device="cpu")
    want = runs["ranks"][mesh][0]["trainer_pigan"]
    t = Trainer(cfg, ds=ds, device="cpu")
    t.init_pigan()
    mgr = ckpt.CheckpointManager(os.path.join(models, "ckpt"), save_interval=2)
    assert mgr.latest_epoch() == 2
    t.load_final(models)
    for name, p in t.pigan_state.g.named_parameters():
        assert p.shape == t.generator.get_parameter(name).shape
    assert torch.equal(t.pigan_state.g_params, want["g_params"])
    assert torch.equal(t.pigan_state.d_params, want["d_params"])
    t2 = Trainer(cfg, ds=ds, device="cpu")
    step = t2.resume_from(mgr, "pigan")
    assert step == 2 and t2.pigan_state.g_params.shape == want["g_params"].shape
    # and resumed over the mesh: every rank's blocks are the file's
    got_step, resumed = runs["ranks"][mesh][0]["resumed"]
    saved = t2.pigan_state.state_dict()
    assert got_step == 2 and resumed["step"] == saved["step"]
    for k, v in saved.items():
        if isinstance(v, torch.Tensor) and k != "generator":
            assert torch.equal(resumed[k], v), k


@pytest.mark.parametrize("mesh", MESHES)
def test_models_without_a_split_path_match_world1(mesh, runs):
    """The residual G and the spectral-norm dual-encoder D, whose leaves the
    rule splits but whose compute has no split path: stored split, gathered
    for each call; the first step's rows, moments, BatchNorm stats and
    spectral norm's u and sigma within FIRST_TOL of world 1's."""
    want_state, want_rows = runs["w1"]["enhanced_first"]
    out = runs["ranks"][mesh][0]
    state, rows = out["enhanced_first"]
    g_split, d_split, first = out["enhanced_split"]
    assert not g_split and not d_split
    assert first[0] == 512 // mesh[1]                    # G's 250 -> 512 kernel, split
    P._allclose(_flat_rows(rows), _flat_rows(want_rows), want_rows, FIRST_TOL, FIRST_TOL,
                f"mesh {mesh} rows")
    keys = P._moments(want_state) + [k for k in want_state if k.endswith(
        ("running_mean", "running_var", ".u", ".sigma"))]
    assert any(k.endswith(".u") for k in keys)
    P._allclose(state, want_state, keys, FIRST_TOL, FIRST_TOL, f"mesh {mesh} state")


@pytest.mark.parametrize("mesh", MESHES)
def test_planted_clip_double_count_fails_the_first_step_gate(mesh, runs):
    """Counting the replicated leaves once per model rank in the clip's
    norm moves the first step's moments by more than FAULT_SEEN times the
    gate."""
    w1_state, _ = runs["w1"]["pigan_first"]
    right = runs["ranks"][mesh][0]["pigan_first"][0]
    bad = runs["ranks"][mesh][0]["fault_clip"][0]
    keys = P._moments(w1_state)
    assert P._worst(right, w1_state, keys) <= 1.0
    assert P._worst(bad, w1_state, keys) > FAULT_SEEN


def _expected_flops(module, split_names, model_size, rows, passes=1):
    total = 0
    for name, p in module.named_parameters():
        if name.endswith(".weight") and p.dim() == 2:
            n = 2 * rows * p.shape[0] * p.shape[1]
            total += n // model_size if name in split_names else n
    return total * passes


@pytest.mark.parametrize("mesh", MESHES)
def test_compute_is_split(mesh, runs):
    """FlopCounterMode on one rank: F's forward and G's forward and backward
    count the split layers' products at 1/M and the replicated ones whole;
    the replicated plan (the plain module) counts every product whole and
    fails this."""
    out = runs["ranks"][mesh][0]
    g, d, f = t_build_trio(torch_ranks.config({"overrides": P.OVERRIDES}), device="cpu")
    m = mesh[1]
    f_split = {leaf.name for leaf in module_leaves(f, m, MIN_SHARD)[0] if leaf.dim is not None}
    g_split = {leaf.name for leaf in module_leaves(g, m, MIN_SHARD)[0] if leaf.dim is not None}
    assert "model.8.weight" in f_split and "main.0.weight" in g_split
    assert out["flops_f_split"] == _expected_flops(f, f_split, m, B)
    assert out["flops_f_replicated"] == _expected_flops(f, set(), m, B)
    assert out["flops_f_replicated"] != _expected_flops(f, f_split, m, B)
    # G forward (1x), backward dW (1x) and dX (1x, but the first layer's)
    first = 2 * B * g.main[0].weight.numel() // (m if "main.0.weight" in g_split else 1)
    assert out["flops_g_split"] == _expected_flops(g, g_split, m, B, passes=3) - first
    assert out["flops_g_replicated"] != out["flops_g_split"]
    assert out["local_shapes_f"]["model.8.weight"][0] == 48 // m
