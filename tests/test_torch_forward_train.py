"""Forward-surrogate pretraining: the port against the JAX package.

- the state carry-over (F's parameters, Adam's moments and count) both ways;
- the eager step's 2-epoch trajectory against the JAX XLA path
  (``make_multi_epoch_fn(make_forward_step)``) from one JAX-initialised
  state, on the JAX package's shuffle indices, at dropout 0, for the default
  loss and for spectrum 5 / metrics 2 / smoothness 0.5 / L1 0.5 (as
  tests/test_megakernel.py:306-350 holds K1 against XLA): per-epoch metric
  rows within 5e-4 relative, parameters within 5e-4 absolute (that test's
  tolerances; fp32 sums in another order, 4 Adam steps);
- the forward-training kernel's plain version against the eager step at
  dropout 0 and 0.2, with the shared dropout masks;
- the masks themselves: the torch hash equals a pure-Python reference and
  keeps a binomial share of the entries.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.data.dataset import ThzDataset
from pigan_thz_torch.interop import forward_state_to_flax, load_forward_state_
from pigan_thz_torch.models import build_forward_model
from pigan_thz_torch.ops import forward_train as ft
from pigan_thz_torch.train.state import init_forward_state
from pigan_thz_torch.train.state import make_optimizers as t_make_optimizers
from pigan_thz_torch.train.steps import ForwardStepSettings as TSettings
from pigan_thz_torch.train.steps import make_forward_step as t_make_forward_step
from pigan_thz_torch.train.steps import make_multi_epoch_fn as t_make_multi_epoch_fn
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.data.dataset import build_dataset as j_build_dataset
from pigan_thz_tpu.data.dataset import epoch_indices as j_epoch_indices
from pigan_thz_tpu.models import build_forward_model as j_build_forward_model
from pigan_thz_tpu.train.state import init_forward_state as j_init_forward_state
from pigan_thz_tpu.train.state import make_optimizers as j_make_optimizers
from pigan_thz_tpu.train.steps import ForwardStepSettings as JSettings
from pigan_thz_tpu.train.steps import make_forward_step as j_make_forward_step
from pigan_thz_tpu.train.steps import make_multi_epoch_fn as j_make_multi_epoch_fn

torch.set_num_threads(1)

N, B, E = 128, 64, 2
ROWS_RTOL, PARAM_ATOL = 5e-4, 5e-4
SETTINGS = [(1.0, 1.0, 0.0, 0.0), (5.0, 2.0, 0.5, 0.5)]


def _configs(rate: float):
    over = dict(num_samples=N)
    jc = j_default_config()
    jc = jc.replace(data=dataclasses.replace(jc.data, **over),
                    forward_model=dataclasses.replace(jc.forward_model, dropout_rate=rate))
    tc = t_default_config()
    tc = tc.replace(data=dataclasses.replace(tc.data, **over),
                    forward_model=dataclasses.replace(tc.forward_model, dropout_rate=rate))
    return jc, tc


@pytest.fixture(scope="module")
def datasets():
    """One dataset in both packages: the port's synthetic samples,
    normalised by the JAX package, then carried across as-is."""
    _, tc = _configs(0.0)
    raw = synthetic_dataset(tc.data, device="cpu")
    jc, _ = _configs(0.0)
    jds = j_build_dataset(raw.spectra.numpy(), raw.params.numpy(), raw.metrics.numpy(),
                          jc.data)
    tds = ThzDataset(*(torch.from_numpy(np.array(x, np.float32)) for x in jds))
    return jds, tds


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _jax_state(jc, seed=2):
    f = j_build_forward_model(jc.forward_model)
    _, _, ftx = j_make_optimizers(jc, N // B)
    return f, ftx, j_init_forward_state(f, ftx, jax.random.PRNGKey(seed))


def _port_state(tc, seed=0):
    _, _, ftx = t_make_optimizers(tc, N // B)
    return ftx, init_forward_state(build_forward_model(tc.forward_model, device="cpu"), ftx, seed)


def _carry(jstate, tstate):
    adam = jstate.opt[1][0]
    return load_forward_state_(tstate, _np(jstate.f.params), _np(adam.mu), _np(adam.nu),
                               int(adam.count), int(jstate.step))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_state_carry_over_round_trip():
    jc, tc = _configs(0.2)
    _, _, jst = _jax_state(jc)
    rng = np.random.default_rng(0)
    mu = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), jst.f.params)
    nu = jax.tree.map(lambda a: rng.uniform(size=a.shape).astype(np.float32), jst.f.params)
    _, st = _port_state(tc)
    load_forward_state_(st, _np(jst.f.params), mu, nu, 7)
    assert (st.opt.count, st.step) == (7, 7)
    # the module's parameters are views of the flat buffer: they moved too
    w = st.f.model[0].weight
    assert w.data_ptr() == st.params.data_ptr()
    np.testing.assert_array_equal(w.detach().numpy(),
                                  np.asarray(jst.f.params["MLPBlock_0"]["Dense_0"]["kernel"]).T)
    back = forward_state_to_flax(st)
    for key, want in (("params", _np(jst.f.params)), ("mu", mu), ("nu", nu)):
        assert jax.tree.structure(back[key]) == jax.tree.structure(want)
        for a, b in zip(_leaves(back[key]), _leaves(want)):
            np.testing.assert_array_equal(a, b)
    assert (back["count"], back["step"]) == (7, 7)
    # and the flax module gives the port's module's outputs
    f = j_build_forward_model(jc.forward_model)
    x = rng.uniform(-1, 1, (5, 4)).astype(np.float32)
    js, jm = f.apply({"params": back["params"]}, jnp.asarray(x), train=False)
    ts_, tm = st.f.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(ts_.detach().numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(jm), rtol=1e-5, atol=1e-5)


def test_flat_layout_is_the_kernel_layout():
    _, tc = _configs(0.2)
    _, st = _port_state(tc)
    spec = ft.forward_train_spec(tc, TSettings())
    # weights, biases, LayerNorm scales and offsets
    assert spec.num_params == st.params.numel() == 1_377_792 + 2818 + 2 * 2560
    views = [v for l in range(len(spec.dims) - 1) for v in spec.views(st.params, l)]
    params = list(st.f.parameters())
    assert len(views) == len(params)
    for v, p in zip(views, params):
        assert v.shape == p.shape and v.data_ptr() == p.data_ptr()


@pytest.mark.parametrize("weights", SETTINGS, ids=["mse", "weighted_smooth_l1"])
def test_eager_trajectory_matches_jax_xla(weights, datasets):
    jds, tds = datasets
    jc, tc = _configs(0.0)
    f, jtx, jst = _jax_state(jc)
    ttx, tst = _port_state(tc)
    _carry(jst, tst)
    key = jax.random.PRNGKey(11)
    idx = np.stack([np.asarray(j_epoch_indices(k, N, B)) for k in jax.random.split(key, E)])
    jfn = j_make_multi_epoch_fn(j_make_forward_step(f, jtx, JSettings(*weights)), B,
                                with_scale=True, unroll=1)
    scales = np.array([1.0, 0.5], np.float32)   # the second epoch at half the lr
    jst, jrows = jfn(jst, jds, key, jnp.asarray(scales))
    tfn = t_make_multi_epoch_fn(t_make_forward_step(ttx, TSettings(*weights)), B)
    tst, trows = tfn(tst, tds, torch.from_numpy(scales), indices=torch.from_numpy(idx))
    for k in ft.METRIC_KEYS:
        np.testing.assert_allclose(trows[k].numpy(), np.asarray(jrows[k]), rtol=ROWS_RTOL,
                                   err_msg=k)
    back = forward_state_to_flax(tst)
    adam = jst.opt[1][0]
    assert back["count"] == int(adam.count) == back["step"] == int(jst.step) == E * N // B
    for a, b in zip(_leaves(back["params"]), _leaves(jst.f.params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
    for a, b in zip(_leaves(back["mu"]), _leaves(adam.mu)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_plain_kernel_matches_eager_step(rate, datasets):
    """The kernel's plain version (hand-derived backward, the kernel's
    LayerNorm) against the eager autograd step (torch's LayerNorm), from one
    state, on the same indices and dropout seeds: rows within 1e-5
    relative, parameters within 5e-5 (4 steps; only the summation orders
    differ)."""
    _, tds = datasets
    _, tc = _configs(rate)
    settings = TSettings(5.0, 2.0, 0.5, 0.5)
    ttx, eager_state = _port_state(tc, seed=3)
    kernel_state = eager_state.clone()
    gen = torch.Generator().manual_seed(4)
    idx, seeds = ft.resolve_draws(gen, N, B, E)
    eager = t_make_multi_epoch_fn(t_make_forward_step(ttx, settings), B)
    kernel = ft.make_forward_epoch_fn(tc, settings)
    scales = torch.tensor([1.0, 0.25])
    before = dict(ft.LAUNCHES)
    eager_state, erows = eager(eager_state, tds, scales, indices=idx, seeds=seeds)
    kernel_state, krows = kernel(kernel_state, tds, scales, indices=idx, seeds=seeds)
    assert ft.LAUNCHES == before          # CPU tensors: the plain version
    for k in ft.METRIC_KEYS:
        torch.testing.assert_close(krows[k], erows[k], rtol=1e-5, atol=0)
    torch.testing.assert_close(kernel_state.params, eager_state.params, rtol=0, atol=5e-5)
    assert kernel_state.opt.count == eager_state.opt.count == E * N // B
    assert kernel_state.step == eager_state.step


def _mix32_reference(x: int) -> int:
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    return x ^ (x >> 16)


def test_dropout_bits_match_python_reference():
    seed, layer = 2**31 - 2, 3
    bits = ft.dropout_bits(seed, layer, 5, 7, device="cpu")
    h = _mix32_reference(_mix32_reference(seed) ^ layer)
    for r in range(5):
        rk = _mix32_reference(h ^ r)
        for c in range(7):
            assert int(bits[r, c]) == _mix32_reference(rk ^ c)


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_dropout_masks_keep_a_binomial_share(rate):
    scale = ft.dropout_scale(12345, 0, 64, 1024, rate, device="cpu")
    kept = scale > 0
    n = kept.numel()
    share = float(kept.float().mean())
    assert abs(share - (1 - rate)) <= 5 * (rate * (1 - rate) / n) ** 0.5
    assert torch.all(scale[kept] == torch.tensor(1 / (1 - rate), dtype=torch.float32))
    # other layers and seeds draw other masks
    assert not torch.equal(scale, ft.dropout_scale(12345, 1, 64, 1024, rate, device="cpu"))
    assert not torch.equal(scale, ft.dropout_scale(12346, 0, 64, 1024, rate, device="cpu"))


def test_kernel_envelope():
    tc = t_default_config()
    assert ft.supports_forward_kernel(tc) is None
    odd = tc.replace(forward_model=dataclasses.replace(tc.forward_model,
                                                       hidden_dims=(256, 256)))
    assert "baseline" in ft.supports_forward_kernel(odd)
    bf16 = tc.replace(train=dataclasses.replace(tc.train, compute_dtype="bfloat16"))
    assert ft.supports_forward_kernel(bf16) is None
    assert ft.forward_train_spec(bf16, TSettings()).bf16
    moments = tc.replace(train=dataclasses.replace(tc.train, adam_state_dtype="bfloat16"))
    assert "adam_state_dtype" in ft.supports_forward_kernel(moments)
    with pytest.raises(ValueError, match="nll_w"):
        ft.forward_train_spec(tc, TSettings(nll_w=1.0))
    with pytest.raises(ValueError, match="nll_w"):
        t_make_forward_step(None, TSettings(nll_w=1.0))


# -- bfloat16 operands against the Pallas kernel in interpret mode -------------
def _bf16_pallas_case(faults=()):
    """One epoch (2 steps, dropout 0: the TPU kernel draws its masks from the
    TPU's generator) of F in bfloat16 through the JAX package's kernel in
    interpret mode and through the port's plain version (float32 and
    float64 accumulation, and with ``faults``) from the same state on the
    kernel's own batches: {name: flat (params, m)}."""
    from pigan_thz_tpu.ops import megakernel as jmk

    jc, tc = _configs(0.0)
    jc = jc.replace(train=dataclasses.replace(jc.train, compute_dtype="bfloat16"))
    tc = tc.replace(train=dataclasses.replace(tc.train, compute_dtype="bfloat16"))
    jds, tds = _bf16_pallas_case.datasets
    f, jtx, jst = _jax_state(jc)
    _, tst = _port_state(tc)
    _carry(jst, tst)
    start = [tst.params.clone(), tst.opt.m.clone(), tst.opt.v.clone()]
    key = jax.random.PRNGKey(5)
    jst, jrows = jmk.make_pallas_forward_epoch_fn(jc, JSettings(), interpret=True)(
        jst, jds, key, jnp.ones((1,), jnp.float32))
    back = _carry_back(jst)
    idx = np.stack([np.asarray(j_epoch_indices(k, N, B)) for k in jax.random.split(key, 1)])
    spec = ft.forward_train_spec(tc, TSettings())
    assert spec.bf16
    streams = ft.build_streams(tds, torch.from_numpy(idx), torch.zeros(N // B, dtype=torch.int64),
                               torch.ones(1), 0, _schedule(tc))
    out = {"jax": back}
    for name, dbl, fl in (("port", False, ()), ("port64", True, ()),
                          *((f"fault {x}", True, (x,)) for x in faults)):
        bufs = [t.clone().double() if dbl else t.clone() for t in start]
        rows = ft.forward_train_plain(*bufs, streams, spec, faults=fl)
        out[name] = (bufs[0], bufs[1])
        if name == "port":
            out["rows"] = (rows, jrows)
    return out, spec, start


def _carry_back(jst):
    """A JAX forward state's parameters and first moments as the port's flat
    buffers."""
    _, tc = _configs(0.0)
    _, st = _port_state(tc)
    _carry(jst, st)
    return st.params.clone(), st.opt.m.clone()


def _schedule(tc):
    from pigan_thz_torch.train.schedules import make_schedule

    return make_schedule("cosine", tc.train.fwd_pretrain_lr, tc.train.fwd_pretrain_epochs,
                         N // B, schedule_alpha=0.0)


def _by_tensor(spec, flat):
    """The first moments by tensor, the head's spectrum and metrics rows
    apart."""
    out = {}
    S = spec.spectrum_dim
    for l in range(len(spec.dims) - 1):
        views = spec.views(flat, l)
        if l == spec.n_hidden:
            out["head W spectrum"], out["head W metrics"] = views[0][:S], views[0][S:]
            out["head b"] = views[1]
        else:
            for n, t in zip(("W", "b", "gamma", "beta"), views):
                out[f"{l} {n}"] = t
    return {k: t.double().reshape(-1) for k, t in out.items()}


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp(min=1e-30))


# K1 in bfloat16: rows within BF16_ROWS_RTOL (measured 5e-5); Adam's first
# moments (the steps' gradients) tensor by tensor within BF16_MOMENT_FACTOR
# times the port's own distance between float32 and float64 accumulation of
# the same rounded operands.  That distance is what a flipped rounding makes
# (an operand whose float32 upstreams differ by an ulp lands on the other
# bfloat16 neighbour, 2^-8 away): 8e-5 (the head's bias) to 1e-2 (the input
# layer, at the end of the backward).  Measured: the JAX kernel 1.1x to 1.4x
# that distance from the port on every tensor; the head's metrics columns
# rounded 10x (head W metrics) and 17x (head b); hidden layer 2 in float32
# 11x (head W spectrum) and more.
BF16_ROWS_RTOL, BF16_MOMENT_FACTOR = 1e-3, 3.0


def test_plain_kernel_bf16_matches_the_pallas_kernel_in_interpret_mode(datasets):
    _bf16_pallas_case.datasets = datasets
    out, spec, _ = _bf16_pallas_case()
    rows, jrows = out["rows"]
    for j, k in enumerate(ft.METRIC_KEYS):
        got = ft.epoch_means(rows, 1)[k].numpy()
        np.testing.assert_allclose(got, np.asarray(jrows[k]), rtol=BF16_ROWS_RTOL, err_msg=k)
    mj, mp, m64 = (_by_tensor(spec, out[n][1]) for n in ("jax", "port", "port64"))
    for k in mj:
        limit = BF16_MOMENT_FACTOR * _rel(mp[k], m64[k])
        assert _rel(mp[k], mj[k]) <= limit, (k, _rel(mp[k], mj[k]), limit)


def test_plain_kernel_bf16_faults_are_seen(datasets):
    """Each bfloat16 fault (the head's metrics columns rounded; hidden layer
    2 left in float32) moves some tensor of the first moments beyond what the
    test above allows."""
    _bf16_pallas_case.datasets = datasets
    out, spec, _ = _bf16_pallas_case(faults=ft.FAULTS)
    mj, mp, m64 = (_by_tensor(spec, out[n][1]) for n in ("jax", "port", "port64"))
    for fault in ft.FAULTS:
        mf = _by_tensor(spec, out[f"fault {fault}"][1])
        beyond = [k for k in mj
                  if _rel(mf[k], mj[k]) > 2.0 * BF16_MOMENT_FACTOR * _rel(mp[k], m64[k])]
        assert beyond, fault
    with pytest.raises(ValueError, match="unknown faults"):
        ft.forward_train_plain(*[t.clone() for t in (out["port"][0],) * 3],
                               ft.Streams(*(None,) * 5), spec, faults=["no_such_fault"])
