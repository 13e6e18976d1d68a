"""Data parallelism over torch.distributed ranks, on the CPU: the port
against one rank and against the JAX package's global-batch mesh program.

``tests/test_torch_ranks.py`` (torch and the port only) runs on two gloo ranks
and on three, in worker processes started by the module fixture; the same
functions run here with no mesh for world 1, and the JAX side runs here on
two of the eight virtual CPU devices (``tests/conftest.py``):
``make_parallel_multi_epoch_fn`` over ``make_mesh(data=2, model=1,
devices=jax.devices()[:2])``.  The two sides exchange files under the
fixture's directory.  At narrow widths (G 48-24, D 40-20, F 16-32-48-32-16),
128 samples, B = 32 (16 rows a rank), 2 epochs of 4 steps.

Tolerances (float32 on every side; world 2 sums its rows in two halves,
JAX in XLA's order):
- the first step: metric rows and Adam's first moments (the gradient) of
  every model within FIRST_TOL (rtol and atol); G's BatchNorm running stats
  within STATS_ATOL of world 1, within FIRST_TOL of JAX (whose batch
  variance is float32's one-pass E[x²] - E[x]², the port's from float64
  sums);
- after 2 epochs: world 2 against world 1, rows within EPOCHS_RTOL, the
  parameters within EPOCHS_PARAM_ATOL outside G's two Dense biases that
  feed BatchNorm (the gauge leaves: their true gradient is zero and both
  sides' are rounding noise, so Adam moves them by up to lr a step either
  way), BatchNorm running variances within STATS_ATOL and running means
  within GAUGE_WALK, the most the gauge leaves can walk apart in 8 steps
  (a running mean carries its layer's bias); the JAX program against the
  port within tests/test_torch_gan_step.py's trajectory tolerances;
- the replicas: every rank's state equal to rank 0's, bit for bit.
A BatchNorm over each rank's own rows, or over all rows in the forward
only, moves the first step's moments by more than 100 times FIRST_TOL.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ranks as torch_ranks
from pigan_thz_torch import cli
from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.data.dataset import ThzDataset
from pigan_thz_torch.interop import load_forward_state_, load_pigan_state_
from pigan_thz_torch.models import build_trio as t_build_trio
from pigan_thz_torch.parallel import Mesh, weight_vector
from pigan_thz_torch.parallel.mesh import BatchShard
from pigan_thz_torch.train import checkpoint as ckpt
from pigan_thz_torch.train.state import init_forward_state as t_init_forward_state
from pigan_thz_torch.train.state import init_pigan_state as t_init_pigan_state
from pigan_thz_torch.train.state import make_optimizers as t_make_optimizers
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.data.dataset import build_dataset as j_build_dataset
from pigan_thz_tpu.data.dataset import epoch_indices as j_epoch_indices
from pigan_thz_tpu.models import build_trio as j_build_trio
from pigan_thz_tpu.parallel import make_mesh as j_make_mesh
from pigan_thz_tpu.parallel import make_parallel_multi_epoch_fn as j_parallel_fn
from pigan_thz_tpu.train.state import init_forward_state as j_init_forward_state
from pigan_thz_tpu.train.state import init_pigan_state as j_init_pigan_state
from pigan_thz_tpu.train.state import make_optimizers as j_make_optimizers
from pigan_thz_tpu.train.steps import ForwardStepSettings as JFSettings
from pigan_thz_tpu.train.steps import StepSettings as JSettings
from pigan_thz_tpu.train.steps import make_forward_step as j_make_forward_step
from pigan_thz_tpu.train.steps import make_pigan_step as j_make_pigan_step

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_ranks.py")
N, B, E = 128, 32, 2
SPE = N // B
NARROW = dict(g=(48, 24), d=(40, 20), f=(16, 32, 48, 32, 16))
OVERRIDES = [f"data.num_samples={N}", f"train.batch_size={B}", f"train.num_epochs={E}",
             "generator.hidden_dims=48,24", "discriminator.hidden_dims=40,20",
             "forward_model.hidden_dims=16,32,48,32,16"]
FIRST_TOL = 1e-5
EPOCHS_RTOL = 1e-4
EPOCHS_PARAM_ATOL = 1e-4
STATS_ATOL = 1e-6
GAUGE_WALK = 2 * E * SPE * t_default_config().train.lr_g
# tests/test_torch_gan_step.py: the JAX XLA step against the port over 8 steps
JAX_ROWS_RTOL, JAX_PARAM_ATOL = 2e-3, 8e-4
WORKER_TIMEOUT = 240
GAUGE = ("g.main.0.bias", "g.main.3.bias")


def _narrow(cfg, dropout=None):
    f = cfg.forward_model
    if dropout is not None:
        f = dataclasses.replace(f, dropout_rate=dropout)
    return cfg.replace(
        data=dataclasses.replace(cfg.data, num_samples=N),
        train=dataclasses.replace(cfg.train, batch_size=B, num_epochs=E),
        generator=dataclasses.replace(cfg.generator, hidden_dims=NARROW["g"]),
        discriminator=dataclasses.replace(cfg.discriminator, hidden_dims=NARROW["d"]),
        forward_model=dataclasses.replace(f, hidden_dims=NARROW["f"]))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _pigan_payload(jst) -> dict:
    """A JAX PiGanState as the port's state_dict (tensors copied out)."""
    ga, da = jst.g_opt[1][0], jst.d_opt[1][0]
    (gtx, dtx, _), st = _port_pigan()
    load_pigan_state_(st, {
        "g": {"params": _np(jst.g.params), "batch_stats": _np(jst.g.extra["batch_stats"])},
        "d": {"params": _np(jst.d.params)}, "f": {"params": _np(jst.f.params)},
        "g_mu": _np(ga.mu), "g_nu": _np(ga.nu), "g_count": int(ga.count),
        "d_mu": _np(da.mu), "d_nu": _np(da.nu), "d_count": int(da.count),
        "step": int(jst.step)})
    return torch_ranks.tensors(st.state_dict())


def _forward_payload(jfs) -> dict:
    adam = jfs.opt[1][0]
    st = _port_forward()
    load_forward_state_(st, _np(jfs.f.params), _np(adam.mu), _np(adam.nu), int(adam.count))
    return torch_ranks.tensors(st.state_dict())


def _port_pigan():
    tc = _narrow(t_default_config())
    g, d, f = t_build_trio(tc, device="cpu")
    txs = t_make_optimizers(tc, SPE)
    return txs, t_init_pigan_state(g, d, f, txs[0], txs[1], 0, device="cpu")


def _port_forward():
    tc = _narrow(t_default_config())
    _, _, f = t_build_trio(tc, device="cpu")
    return t_init_forward_state(f, t_make_optimizers(tc, SPE)[2], 0, device="cpu")


def _subset(jds, idx):
    return jds._replace(spectra=jds.spectra[idx], params=jds.params[idx],
                        params_norm=jds.params_norm[idx], metrics=jds.metrics[idx],
                        metrics_norm=jds.metrics_norm[idx])


def _jax_runs(jds, idx_first, key):
    """The JAX package's parallel program on two virtual devices: the first
    step (one epoch of a dataset that is the first batch) and 2 epochs, for
    the PI-GAN step and the forward step (dropout 0)."""
    jmesh = j_make_mesh(data=2, model=1, devices=jax.devices()[:2])
    out = {}
    jc = _narrow(j_default_config())
    g, d, f = j_build_trio(jc)
    g_tx, d_tx, _ = j_make_optimizers(jc, SPE)
    jset = JSettings(detach_forward=False)
    step = j_make_pigan_step(g, d, f, g_tx, d_tx, jset, jds.param_lo, jds.param_hi)
    fn = j_parallel_fn(step, B, jmesh, with_scale=True, unroll=1)
    for name, ds, epochs in (("first", _subset(jds, idx_first), 1), ("epochs", jds, E)):
        jst = j_init_pigan_state(g, d, f, g_tx, d_tx, jax.random.PRNGKey(1))
        jst, rows = fn(jst, ds, key, jnp.ones(epochs))
        out[f"pigan_{name}"] = (_pigan_payload(jst), _rows(rows))
    jcf = _narrow(j_default_config(), dropout=0.0)
    _, _, jf = j_build_trio(jcf)
    _, _, f_tx = j_make_optimizers(jcf, SPE)
    fn = j_parallel_fn(j_make_forward_step(jf, f_tx, JFSettings()), B, jmesh, unroll=1)
    for name, ds, epochs in (("first", _subset(jds, idx_first), 1), ("epochs", jds, E)):
        jfs = j_init_forward_state(jf, f_tx, jax.random.PRNGKey(2))
        jfs, rows = fn(jfs, ds, key, jnp.ones(epochs))
        out[f"forward_{name}"] = (_forward_payload(jfs), _rows(rows))
    return out


def _rows(rows) -> dict:
    return {k: torch.from_numpy(np.array(v, np.float32).reshape(-1)) for k, v in rows.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ranks")
    tc = _narrow(t_default_config())
    raw = synthetic_dataset(tc.data, device="cpu")
    jds = j_build_dataset(raw.spectra.numpy(), raw.params.numpy(), raw.metrics.numpy(),
                          _narrow(j_default_config()).data)
    tds = ThzDataset(*(torch.from_numpy(np.array(x, np.float32)) for x in jds))
    jc = _narrow(j_default_config())
    g, d, f = j_build_trio(jc)
    g_tx, d_tx, f_tx = j_make_optimizers(jc, SPE)
    key = jax.random.PRNGKey(11)
    idx = np.stack([np.asarray(j_epoch_indices(k, N, B)) for k in jax.random.split(key, E)])
    # JAX's one-epoch run of the first step draws its epoch from
    # split(key, 1)[0], which is split(key, E)[0]
    assert np.array_equal(np.asarray(j_epoch_indices(jax.random.split(key, 1)[0], N, B)),
                          idx[0])
    fwd = _forward_payload(j_init_forward_state(f, f_tx, jax.random.PRNGKey(2)))
    inputs = {
        "overrides": OVERRIDES, "ds": tuple(tds),
        "pigan": _pigan_payload(j_init_pigan_state(g, d, f, g_tx, d_tx,
                                                   jax.random.PRNGKey(1))),
        "forward": fwd, "forward_nodrop": fwd,
        "indices": torch.from_numpy(idx).to(torch.int64),
        "seeds": torch.arange(E * SPE, dtype=torch.int64) * 7919 + 13,
        "weights": torch.stack([weight_vector(maxwell=m, lc=lc, range_=r) for m, lc, r in
                                ((1.0, 1.0, 0.1), (5.0, 1.0, 0.1), (0.0, 0.0, 0.0),
                                 (10.0, 10.0, 0.5))]),
    }
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    procs = {}
    for world in (2, 3):
        d_ = root / f"world{world}"
        d_.mkdir()
        torch.save(inputs, d_ / "inputs.pt")
        procs[world] = subprocess.Popen([sys.executable, WORKER, str(world), str(d_)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True, env=env)
    try:
        world1 = torch_ranks.run_all(inputs, None, str(root / "models1"))
        jax_out = _jax_runs(jds, idx[0, 0], key)
        logs = {w: p.communicate(timeout=WORKER_TIMEOUT)[0] for w, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for w, p in procs.items():
        assert p.returncode == 0, f"world {w} exited {p.returncode}:\n{logs[w][-4000:]}"
    ranks = {w: [torch.load(root / f"world{w}" / f"rank{r}.pt", weights_only=False)
                 for r in range(w)] for w in procs}
    return dict(w1=world1, jax=jax_out, ranks=ranks, root=root)


def _allclose(got: dict, want: dict, keys, rtol, atol, what):
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


def _moments(payload: dict) -> list:
    return [k for k in payload if k.endswith("opt.m") or k == "opt.m"]


def _stats(payload: dict) -> list:
    return [k for k in payload if "running_" in k]


def _worst(got: dict, want: dict, keys) -> float:
    """The largest |got - want| / (atol + rtol |want|) at FIRST_TOL: above
    1 fails the first-step gate."""
    return max(float(((got[k] - want[k]).abs() / (FIRST_TOL + FIRST_TOL * want[k].abs())).max())
               for k in keys)


def _same(a, b) -> bool:
    """Equal bit for bit (NaN where NaN), through dicts, tuples and lists."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and bool(
            ((a == b) | (a != a) & (b != b)).all())
    return a == b


def test_replicas_are_equal_bit_for_bit(runs):
    """Every rank's states, rows and results equal rank 0's (the masks are
    each rank's own rows; the planted faults' BatchNorm stats each rank's)."""
    for world, outs in runs["ranks"].items():
        for key, value in outs[0].items():
            if key.startswith(("masks", "fault")):
                continue
            for r in range(1, world):
                assert _same(value, outs[r][key]), (world, r, key)


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("case", ["pigan", "forward_nodrop"])
def test_first_step_matches_the_jax_mesh_program(case, world, runs):
    """World 1's and world 2's first step against the JAX mesh program's
    on the same rows (in another order)."""
    j_state, j_rows = runs["jax"][f"{case.split('_')[0]}_first"]
    out = runs["w1"] if world == 1 else runs["ranks"][2][0]
    state, rows = out[f"{case}_first"]
    assert set(rows) == set(j_rows)
    _allclose({k: v.reshape(-1) for k, v in rows.items()}, j_rows, j_rows, FIRST_TOL,
              FIRST_TOL, f"world {world} rows vs JAX")
    _allclose(state, j_state, _moments(j_state), FIRST_TOL, FIRST_TOL,
              f"world {world} moments vs JAX")
    # JAX's BatchNorm variance is float32's one-pass E[x²] - E[x]², the
    # port's from float64 sums: its running stats are held relative
    _allclose(state, j_state, _stats(j_state), FIRST_TOL, FIRST_TOL,
              f"world {world} stats vs JAX")


@pytest.mark.parametrize("case", ["pigan", "forward", "forward_nodrop"])
def test_first_step_world2_matches_world1(case, runs):
    w2_state, w2_rows = runs["ranks"][2][0][f"{case}_first"]
    w1_state, w1_rows = runs["w1"][f"{case}_first"]
    got = {k: v.reshape(-1) for k, v in w2_rows.items()}
    want = {k: v.reshape(-1) for k, v in w1_rows.items()}
    _allclose(got, want, want, FIRST_TOL, FIRST_TOL, "world 2 rows vs world 1")
    _allclose(w2_state, w1_state, _moments(w1_state), FIRST_TOL, FIRST_TOL,
              "world 2 moments vs world 1")
    _allclose(w2_state, w1_state, _stats(w1_state), 0, STATS_ATOL, "world 2 stats vs world 1")


@pytest.mark.parametrize("case", ["pigan", "forward", "forward_nodrop"])
def test_two_epochs_world2_matches_world1(case, runs):
    w2_state, w2_rows = runs["ranks"][2][0][f"{case}_epochs"]
    w1_state, w1_rows = runs["w1"][f"{case}_epochs"]
    _allclose(w2_rows, w1_rows, w1_rows, EPOCHS_RTOL, 1e-6, "world 2 rows vs world 1")
    for k in ("g_params", "d_params", "params"):
        if k not in w1_state:
            continue
        got, want = w2_state[k].clone(), w1_state[k].clone()
        if k == "g_params":
            for name in GAUGE:
                got[_slice(name)] = want[_slice(name)]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=EPOCHS_PARAM_ATOL,
                                   err_msg=f"{case} {k}")
    stats = _stats(w1_state)
    _allclose(w2_state, w1_state, [k for k in stats if "var" in k], 0, STATS_ATOL,
              f"{case} running variances")
    _allclose(w2_state, w1_state, [k for k in stats if "mean" in k], 0, GAUGE_WALK,
              f"{case} running means")


def _slice(name: str) -> slice:
    """Where G's parameter ``name`` lies in its flat buffer."""
    _, st = _port_pigan()
    pos = 0
    for n, p in st.g.named_parameters():
        if f"g.{n}" == name:
            return slice(pos, pos + p.numel())
        pos += p.numel()
    raise KeyError(name)


@pytest.mark.parametrize("case", ["pigan", "forward_nodrop"])
def test_two_epochs_match_the_jax_mesh_program(case, runs):
    j_state, j_rows = runs["jax"][f"{case.split('_')[0]}_epochs"]
    w2_state, w2_rows = runs["ranks"][2][0][f"{case}_epochs"]
    for k, want in j_rows.items():
        atol = 1.0 / (SPE * B) if k in ("d_accuracy", "violation_rate") else 1e-6
        np.testing.assert_allclose(w2_rows[k].numpy(), want.numpy(), rtol=JAX_ROWS_RTOL,
                                   atol=atol, err_msg=k)
    for k in ("g_params", "d_params", "params"):
        if k not in j_state:
            continue
        got, want = w2_state[k].clone(), j_state[k].clone()
        if k == "g_params":
            for name in GAUGE:
                got[_slice(name)] = want[_slice(name)]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=JAX_PARAM_ATOL,
                                   err_msg=f"{case} {k}")


def test_one_epoch_fn_is_the_multi_epoch_fns_first_epoch(runs):
    one = runs["ranks"][2][0]["pigan_one_epoch"]
    _, rows = runs["ranks"][2][0]["pigan_epochs"]
    assert set(one) == set(rows)
    assert all(torch.equal(one[k], rows[k][0]) for k in rows)


def test_dropout_masks_are_the_global_batch_rows(runs):
    """Each rank's mask is its rows of the global batch's mask, in the
    forward step's call and in the D phase's doubled batch."""
    glob, glob_d = runs["w1"]["masks"], runs["w1"]["masks_d_phase"]
    for r, out in enumerate(runs["ranks"][2]):
        lo, hi = r * B // 2, (r + 1) * B // 2
        assert torch.equal(out["masks"], glob[lo:hi])
        assert torch.equal(out["masks_d_phase"], torch.cat([glob_d[lo:hi],
                                                            glob_d[B + lo:B + hi]]))
    assert not torch.equal(runs["ranks"][2][0]["masks"], runs["ranks"][2][1]["masks"])


@pytest.mark.parametrize("fault", ["fault_local", "fault_local_backward"])
def test_planted_batch_norm_faults_fail_the_first_step_gate(fault, runs):
    """Local statistics (each rank's rows), or global ones in the forward
    with a local backward: each moves the first step's moments by more than
    100 times the gate.  The backward-only fault leaves the rows alone."""
    w1_state, w1_rows = runs["w1"]["pigan_first"]
    right = runs["ranks"][2][0]["pigan_first"][0]
    bad_state, bad_rows = runs["ranks"][2][0][fault]
    keys = _moments(w1_state)
    assert _worst(right, w1_state, keys) <= 1.0
    assert _worst(bad_state, w1_state, keys) > 100.0
    if fault == "fault_local_backward":
        _allclose({k: v.reshape(-1) for k, v in bad_rows.items()},
                  {k: v.reshape(-1) for k, v in w1_rows.items()}, w1_rows, FIRST_TOL,
                  FIRST_TOL, "backward-only fault rows")


def test_trainer_over_two_ranks_matches_world1(runs):
    """Trainer(mesh=...).train(mode="full"), 3 + 3 epochs in chunks of 2:
    every history row within EPOCHS_RTOL of world 1's; rank 0 wrote the
    finals."""
    h2, h1 = runs["ranks"][2][0]["trainer_history"], runs["w1"]["trainer_history"]
    assert set(h2) == set(h1) and len(h2["pigan/g_loss"]) == 3
    for k in h1:
        np.testing.assert_allclose(h2[k], h1[k], rtol=EPOCHS_RTOL, atol=1e-6, err_msg=k)
    models = runs["root"] / "world2" / "models2"
    assert ckpt.exists(str(models), ckpt.GENERATOR_FINAL)
    with open(models / "training_history.json") as fh:
        saved = json.load(fh)
    np.testing.assert_allclose(saved["pigan/g_loss"], h2["pigan/g_loss"], rtol=1e-7)


def test_trainer_refusals_under_a_mesh(runs):
    """The kernel engine and an indivisible batch are refused; the two ranks
    as a model axis (make_mesh(data=1, model=2), F's 32 -> 48 layer split
    24 a rank) train 3 + 3 epochs within EPOCHS_RTOL of world 1."""
    out = runs["ranks"][2][0]
    assert "engine='kernel' is incompatible with mesh" in out["kernel_refused"]
    assert out["model_axis_shape"] == (24, 32)
    h1 = runs["w1"]["trainer_history"]
    for k in h1:
        np.testing.assert_allclose(out["model_axis_history"][k], h1[k], rtol=EPOCHS_RTOL,
                                   atol=1e-6, err_msg=k)
    assert "not divisible by the 3 ranks" in runs["ranks"][3][0]["indivisible"]


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("members", [4, 3])
def test_shard_ensemble_equals_world1(world, members, runs):
    """4 members split 2 + 2 over two ranks (1 each... over three: not
    divisible, so every rank keeps all); 3 over three ranks 1 each, over two
    all; every member gathered back bit for bit world 1's."""
    want = runs["w1"][f"ensemble_{members}"]
    for out in runs["ranks"][world]:
        got = out[f"ensemble_{members}"]
        assert got["local"] == (members // world if members % world == 0 else members)
        for k in ("g", "d", "g_m"):
            assert torch.equal(got[k], want[k]), k
        for a, b in zip(got["bn"], want["bn"]):
            assert torch.equal(a, b)
        for k, v in want["rows"].items():
            assert torch.equal(got["rows"][k], v), k


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", ["screen_f", "screen_ties"])
def test_screen_over_ranks_equals_world1(world, case, runs):
    """The top-k of 5 chunks of 512 (the last one padded) over 2 and 3
    ranks: every field equal to world 1's, the designs too.  The staircase
    surrogate gives exact ties and NaN spectra."""
    want = runs["w1"][case]
    for out in runs["ranks"][world]:
        got = out[case]
        for k, v in want.items():
            assert torch.equal(got[k], v) or torch.allclose(got[k], v, rtol=0, atol=0,
                                                            equal_nan=True), k
    if case == "screen_ties":
        scores = want["scores"][want["valid"]]
        assert len(set(scores.tolist())) < len(scores)       # tied winners


def test_batch_shard_rows():
    mesh = Mesh(rank=1, size=2, device=torch.device("cpu"), backend="gloo")
    shard = BatchShard(mesh, 8)
    x = torch.arange(16).reshape(16, 1)
    assert shard.take(x[:8]).reshape(-1).tolist() == [4, 5, 6, 7]
    assert shard.take(x).reshape(-1).tolist() == [4, 5, 6, 7, 12, 13, 14, 15]
    assert shard.take(x[:1]).shape == (1, 1)
    assert shard.global_shape((8, 3)) == (16, 3) and shard.global_shape((1, 3)) == (1, 3)
    with pytest.raises(ValueError, match="not divisible"):
        BatchShard(Mesh(rank=0, size=3, device=torch.device("cpu"), backend="gloo"), 8)
    with pytest.raises(ValueError, match="fewer than 2 rows"):
        BatchShard(mesh, 2)


def test_screen_command_over_two_cpu_ranks(runs, tmp_path):
    """``screen --mesh-data 2 --device cpu`` writes the JSON of
    ``--mesh-data 1``."""
    models = str(tmp_path / "models")
    shutil.copytree(runs["root"] / "models1", models)
    common = ["screen", "--models", models, "--device", "cpu", *sum(
        (["--set", o] for o in OVERRIDES), []), "--candidates", "3000", "--chunk-size",
        "1024", "--top-k", "10"]
    for n in (1, 2):
        assert cli.main([*common, "--mesh-data", str(n), "--out",
                         str(tmp_path / f"s{n}.json")]) == 0
    with open(tmp_path / "s1.json") as a, open(tmp_path / "s2.json") as b:
        one, two = json.load(a), json.load(b)
    assert one == two and len(one["designs"]) == 10
