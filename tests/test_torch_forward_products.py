"""The batch-row products of the forward-training kernel (K1), on the CPU.

K1 (``csrc/forward_train.cu``) launches the ten products of a step whose
rows are the batch (F's forward layers 2-5 and head, the head's and layers
5-2's input gradients) through the GAN step's batch-row kernel,
``csrc/brow_gemm.cuh``: split-K over a cluster, the partial products summed
in rank order.  Here, against the JAX package where it has a counterpart:

- ``forward_train.brow_products``: ten products a step in both operand
  types and at any dropout, each with the batch as rows and bfloat16
  operands exactly where the TPU kernel rounds them
  (``megakernel.py:2644-2663``), and each one of the shapes the GAN step
  already runs through F;
- each shape's launch plan (``brow_plan``) against the split that
  ``PERF.md`` gives for it;
- each product through the wrapper's CPU path (``brow_gemm_plain`` over the
  plan's slices) against the JAX forward kernel's own product (``mm``,
  ``dotT1``) on the same numpy operands, in float32 and bfloat16;
- the first float32 step against float64, the check the card holds the
  kernel to (``chip_smoke.py`` phase 10): the JAX kernel in interpret mode
  passes it, and the planted fault ``dx_layer3_last_slice_dropped`` (a
  cluster sum that lost its last rank) fails it;
- the launch counts, one dict, and the C loops' reports (``_cuda_build``).

The kernel itself is held to these on the card in test_torch_cuda.py.
"""

import ctypes
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.data.dataset import ThzDataset
from pigan_thz_torch.interop import load_forward_state_
from pigan_thz_torch.models import build_forward_model
from pigan_thz_torch.ops import _cuda_build, brow, products
from pigan_thz_torch.ops import forward_train as ft
from pigan_thz_torch.ops import gan_train as gt
from pigan_thz_torch.train.schedules import make_schedule
from pigan_thz_torch.train.state import init_forward_state
from pigan_thz_torch.train.state import make_optimizers as t_make_optimizers
from pigan_thz_torch.train.steps import ForwardStepSettings as TSettings
from pigan_thz_torch.train.steps import StepSettings
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.data.dataset import build_dataset as j_build_dataset
from pigan_thz_tpu.data.dataset import epoch_indices as j_epoch_indices
from pigan_thz_tpu.models import build_forward_model as j_build_forward_model
from pigan_thz_tpu.train.state import init_forward_state as j_init_forward_state
from pigan_thz_tpu.train.state import make_optimizers as j_make_optimizers
from pigan_thz_tpu.train.steps import ForwardStepSettings as JSettings

torch.set_num_threads(1)

B = 64   # the published batch size
# The first step against float64 (chip_smoke.py: K2_ROUNDING, K2_STEP_FLOOR[1],
# K1_BF16_FAULT_RATIO): each tensor of Adam's first moments within 8x the
# float32 plain version's distance from float64, or 1e-6 of the tensor; a
# fault is seen where the run under test is 4x further from the faulty run
# than from the right one on some tensor.
ROUNDING, STEP_FLOOR, FAULT_RATIO = 8.0, 1e-6, 4.0
# the cluster size PERF.md gives for each of K1's products at B = 64 on an
# H100 (132 SMs): the smallest that brings the blocks to 128, at most 8
PLAN_SPLIT = {(64, 512, 256): 8, (64, 1024, 512): 4, (64, 512, 1024): 8,
              (64, 256, 512): 8, (64, 258, 256): 8, (64, 256, 258): 8,
              (64, 250, 256): 8, (64, 256, 250): 8}


def _spec(dtype="float32", rate=0.2):
    cfg = t_default_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype=dtype),
                      forward_model=dataclasses.replace(cfg.forward_model, dropout_rate=rate))
    return cfg, ft.forward_train_spec(cfg, TSettings())


def _products(dtype):
    return ft.brow_products(_spec(dtype)[1], B)


K1_PRODUCTS = sorted({(p.name, p.m, p.n, p.k, p.bnc, p.rnd)
                      for dtype in ("float32", "bfloat16") for p in _products(dtype)},
                     key=lambda p: (p[5], p[0]))


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_lists_its_batch_row_products(dtype, rate):
    """Ten products a step, the batch as rows, N and K a layer's widths (at
    least 32: never the input layer's depth 4, never a weight gradient's
    depth B), A contiguous along K; bfloat16 operands on every one under
    bfloat16 (the TPU kernel's ``mm`` / ``dotT1`` round every hidden layer
    above the first and the head's spectrum columns), on none in float32.
    The dropout rate changes no product."""
    _, spec = _spec(dtype, rate)
    prods = ft.brow_products(spec, B)
    assert len(prods) == 10 and len({p.name for p in prods}) == 10
    S, D = spec.spectrum_dim, spec.dims[-1]
    for p in prods:
        assert p.m == B and p.n >= 32 and p.k >= 32 and p.ak, p
        assert p.rnd == spec.bf16, p
        assert p.bias == (not p.bnc), p          # forward products carry the bias
    heads = [p for p in prods if "head" in p.name]
    width = S if spec.bf16 else D                # the 8 metrics columns stay on the SGEMM
    assert [(p.n, p.k) for p in heads] == [(width, spec.dims[-2]), (spec.dims[-2], width)]
    assert prods == ft.brow_products(_spec(dtype, 0.2 - rate)[1], B)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_products_are_shapes_the_gan_step_runs(dtype):
    """Every K1 product, its shape and flags, is one that K2 already runs
    through F (its forward chain and input gradient): the same products
    that ``PERF.md`` and phase 29 time."""
    cfg, spec = _spec(dtype)
    gspec = gt.gan_train_spec(cfg, StepSettings.from_config(cfg, detach_forward=False))
    k2 = {(p.m, p.n, p.k, p.ak, p.bnc, p.rnd, p.bias) for p in gt.brow_products(gspec, B)}
    for p in ft.brow_products(spec, B):
        assert (p.m, p.n, p.k, p.ak, p.bnc, p.rnd, p.bias) in k2, p


@pytest.mark.parametrize("shape", sorted(PLAN_SPLIT), ids=lambda s: "x".join(map(str, s)))
def test_plan_of_every_k1_product(shape):
    m, n, k = shape
    assert shape in {(p.m, p.n, p.k) for d in ("float32", "bfloat16") for p in _products(d)}
    plan = brow.brow_plan(m, n, k)
    assert plan.split == PLAN_SPLIT[shape]
    assert plan.slice >= brow.BROW_MIN_DEPTH and plan.slice * plan.split >= k
    assert plan.blocks <= 128 and (plan.blocks == 128 or plan.split == brow.BROW_MAX_SPLIT)


def _jax_product(x, w_in_out, dx: bool, bf16: bool):
    """The TPU forward kernel's products (megakernel.py:2648-2663): ``mm``
    (x @ W, W as (in, out)) for a forward layer, ``dotT1`` (dz @ W^T) for an
    input gradient, operands in bfloat16 or float32, float32 sums."""
    t = jnp.bfloat16 if bf16 else jnp.float32
    a, w = jnp.asarray(x).astype(t), jnp.asarray(w_in_out).astype(t)
    if dx:
        return np.asarray(jax.lax.dot_general(a, w, (((1,), (1,)), ((), ())),
                                              preferred_element_type=jnp.float32))
    return np.asarray(jnp.dot(a, w, preferred_element_type=jnp.float32))


@pytest.mark.parametrize("product", K1_PRODUCTS,
                         ids=[f"{p[0]}-{'bf16' if p[5] else 'fp32'}".replace(" ", "_")
                              .replace(",", "") for p in K1_PRODUCTS])
def test_product_against_the_jax_kernel(product):
    """One K1 product on the same numpy operands: through ``brow_gemm`` on
    the CPU (the kernel's split-K arithmetic over the plan's slices) in the
    layout the port's step gives it (W as (out, in): transposed for a
    forward layer, as it is for an input gradient) and through the JAX
    kernel's product; equal within the float32 sum bound of both (the same
    products, exact under bfloat16, summed in two orders)."""
    name, m, n, k, bnc, rnd = product
    rng = np.random.default_rng(m * n + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if bnc:      # dx = dz W, W (out, in) = (k, n); the JAX kernel holds W as (in, out)
        w = rng.standard_normal((k, n)).astype(np.float32)
        want = _jax_product(x, np.ascontiguousarray(w.T), True, rnd)
        b_op = torch.tensor(w)
    else:        # z = x W^T, W (out, in) = (n, k)
        w = rng.standard_normal((n, k)).astype(np.float32)
        want = _jax_product(x, np.ascontiguousarray(w.T), False, rnd)
        b_op = torch.tensor(w).t()
    a = torch.tensor(x)
    assert (b_op.stride(-1) <= b_op.stride(-2)) == bnc
    got = brow.brow_gemm(a, b_op, rnd=rnd)
    split = brow.brow_plan(m, n, k).split
    assert torch.equal(got, brow.brow_gemm_plain(a, b_op, rnd=rnd, split=split))
    ra, rb = (a.bfloat16().float(), b_op.bfloat16().float()) if rnd else (a, b_op)
    bound = 2 * (k + split + 2) * 2.0 ** -24 * (ra.double().abs() @ rb.double().abs())
    err = (got.double() - torch.tensor(want).double()).abs()
    assert bool((err <= bound).all()), (name, float((err / bound).max()))


# -- the first step against float64 -------------------------------------------


def _first_moments(spec, m):
    """Adam's first moments by tensor (``ForwardTrainSpec.named_tensors``)."""
    return {k: t.double().reshape(-1) for k, t in spec.named_tensors(m).items()}


def test_named_tensors_cover_the_flat_buffer():
    """``named_tensors`` gives every parameter once, as views of the flat
    buffer in its layout (the head's W split by rows at the spectrum's end)."""
    _, spec = _spec()
    flat = torch.arange(spec.num_params, dtype=torch.float64)
    named = spec.named_tensors(flat)
    assert len(named) == 4 * spec.n_hidden + 3
    got = torch.cat([t.reshape(-1) for t in named.values()])
    assert torch.equal(got, flat)
    assert named["head W metrics rows"].shape == (8, spec.dims[-2])


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp(min=1e-30))


def _one_step(n: int, rate: float, seed: int = 0):
    """A published-width F state and the streams of one step from the
    port's synthetic dataset of ``n`` samples: (spec, start, streams)."""
    cfg, spec = _spec("float32", rate)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_samples=n))
    ds = synthetic_dataset(cfg.data, device="cpu")
    _, _, ftx = t_make_optimizers(cfg, n // B)
    st = init_forward_state(build_forward_model(cfg.forward_model, device="cpu"), ftx, seed)
    idx, seeds = ft.resolve_draws(torch.Generator().manual_seed(seed), n, B, 1)
    sched = make_schedule("cosine", cfg.train.fwd_pretrain_lr, cfg.train.fwd_pretrain_epochs,
                          n // B, schedule_alpha=0.0)
    streams = ft.build_streams(ds, idx[:, :1], seeds[:1], torch.ones(1), 0, sched)
    return spec, [st.params.clone(), st.opt.m.clone(), st.opt.v.clone()], streams


def _plain(start, streams, spec, dbl=False, faults=()):
    bufs = [t.clone().double() if dbl else t.clone() for t in start]
    rows = ft.forward_train_plain(*bufs, streams, spec, faults=faults)
    return rows, _first_moments(spec, bufs[1])


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_fp32_fault_is_seen_against_float64(rate):
    """The float32 plain version stands for the kernel: its first step is
    within the gate of the float64 run (it is the yardstick: well within
    rounding), and the float64 run with the last K slice of layer 3's input
    gradient dropped is more than FAULT_RATIO times further from it than
    the right run, on some tensor below layer 3."""
    spec, start, streams = _one_step(256, rate)
    rows32, m32 = _plain(start, streams, spec)
    rows64, m64 = _plain(start, streams, spec, dbl=True)
    _, mf = _plain(start, streams, spec, dbl=True, faults=("dx_layer3_last_slice_dropped",))
    e_p = {k: _rel(m32[k], m64[k]) for k in m64}
    assert max(e_p.values()) < 1e-4, e_p
    assert float(((rows32.double() - rows64).abs() / rows64.abs()).max()) < 1e-5
    ratio = {k: _rel(m32[k], mf[k]) / max(e_p[k], 1e-9) for k in m64}
    assert max(ratio.values()) > FAULT_RATIO, ratio
    # where the fault is: below the faulty product (layers 1 and 2; above it
    # only the clip's scale moves)
    assert max(ratio, key=ratio.get).startswith(("layer 0 ", "layer 1 ")), ratio


def _jax_configs(n):
    jc = j_default_config()
    jc = jc.replace(data=dataclasses.replace(jc.data, num_samples=n),
                    forward_model=dataclasses.replace(jc.forward_model, dropout_rate=0.0))
    tc = t_default_config()
    tc = tc.replace(data=dataclasses.replace(tc.data, num_samples=n),
                    forward_model=dataclasses.replace(tc.forward_model, dropout_rate=0.0))
    return jc, tc


def _carry(jstate, tstate):
    np32 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float32), tree)  # noqa: E731
    adam = jstate.opt[1][0]
    return load_forward_state_(tstate, np32(jstate.f.params), np32(adam.mu), np32(adam.nu),
                               int(adam.count), int(jstate.step))


def test_jax_kernel_first_step_passes_the_float64_gate():
    """One float32 step (dropout 0: the TPU kernel draws its masks from the
    TPU's generator) of the JAX package's forward kernel in interpret mode,
    from the state the port starts from, on the kernel's own batch: its
    first moments pass the gate the card holds K1 to (within ROUNDING times
    the port's float32 plain version's distance from the port's float64
    run, or STEP_FLOOR, tensor by tensor), and the gate sees the planted
    fault against it."""
    from pigan_thz_tpu.ops import megakernel as jmk

    n = B   # one step an epoch
    jc, tc = _jax_configs(n)
    raw = synthetic_dataset(tc.data, device="cpu")
    jds = j_build_dataset(raw.spectra.numpy(), raw.params.numpy(), raw.metrics.numpy(),
                          jc.data)
    tds = ThzDataset(*(torch.from_numpy(np.array(x, np.float32)) for x in jds))
    f = j_build_forward_model(jc.forward_model)
    _, _, jtx = j_make_optimizers(jc, n // B)
    jst = j_init_forward_state(f, jtx, jax.random.PRNGKey(3))
    _, _, ftx = t_make_optimizers(tc, n // B)
    tst = init_forward_state(build_forward_model(tc.forward_model, device="cpu"), ftx, 0)
    _carry(jst, tst)
    start = [tst.params.clone(), tst.opt.m.clone(), tst.opt.v.clone()]
    key = jax.random.PRNGKey(5)
    jst, _ = jmk.make_pallas_forward_epoch_fn(jc, JSettings(), interpret=True)(
        jst, jds, key, jnp.ones((1,), jnp.float32))
    after = init_forward_state(build_forward_model(tc.forward_model, device="cpu"), ftx, 0)
    _carry(jst, after)
    spec = ft.forward_train_spec(tc, TSettings())
    assert not spec.bf16
    idx = np.stack([np.asarray(j_epoch_indices(k, n, B)) for k in jax.random.split(key, 1)])
    sched = make_schedule("cosine", tc.train.fwd_pretrain_lr, tc.train.fwd_pretrain_epochs,
                          n // B, schedule_alpha=0.0)
    streams = ft.build_streams(tds, torch.from_numpy(idx), torch.zeros(1, dtype=torch.int64),
                               torch.ones(1), 0, sched)
    assert streams.params_norm.shape[0] == 1
    mj = _first_moments(spec, after.opt.m)
    _, m32 = _plain(start, streams, spec)
    _, m64 = _plain(start, streams, spec, dbl=True)
    _, mf = _plain(start, streams, spec, dbl=True, faults=("dx_layer3_last_slice_dropped",))
    e_j = {k: _rel(mj[k], m64[k]) for k in m64}
    e_p = {k: _rel(m32[k], m64[k]) for k in m64}
    bad = {k: (e_j[k], e_p[k]) for k in m64 if not e_j[k] <= max(ROUNDING * e_p[k],
                                                                  STEP_FLOOR)}
    ratio = {k: _rel(mj[k], mf[k]) / max(e_j[k], e_p[k], 1e-9) for k in m64}
    worst, seen = max(e_j, key=e_j.get), max(ratio, key=ratio.get)
    print(f"JAX kernel, first float32 step against float64: worst {worst} {e_j[worst]:.3e} "
          f"(float32 plain {e_p[worst]:.3e}); the fault seen {ratio[seen]:.1f}x on {seen}")
    assert not bad, bad
    assert ratio[seen] > FAULT_RATIO, ratio


# launch_counts()'s keys at the time its counts were three dicts, in the order
# the CLI's "kernel launches:" lines print them, with the residual
# generator's kernel beside the other serving kernels
LAUNCH_KEYS = ("fused_mlp_forward", "fused_mlp_forward.wgmma", "fused_dense_chain",
               "fused_residual_chain", "dip_qualification", "forward_train", "gan_train", "gan_ensemble_train",
               "brow_gemm", "deep_narrow_gemm", "batch_depth_gemm", "sgemm")


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, so that a wrapper takes its
    launch path (with ``launch`` stubbed)."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


def _stub_launch(monkeypatch, *modules, fill=None):
    """Stub ``launch`` in ``modules`` as test_torch_profiling.py stubs it: count
    the call in LAUNCHES; ``fill`` writes a C loop's report into its last
    argument.  Returns the calls made."""
    calls = []

    def fake_launch(name, device, *args, count_as=None):
        calls.append((name, count_as))
        if fill is not None:
            args[-1][:] = fill
        _cuda_build.LAUNCHES[count_as or name] += 1

    for mod in modules:
        monkeypatch.setattr(mod, "launch", fake_launch)
        monkeypatch.setattr(mod, "check_capability", lambda index: None)
    return calls


def test_launch_counts_are_one_dict(monkeypatch):
    """Every launch count is a key of one dict, ``LAUNCHES``, in the order the
    CLI has always printed them; ``brow_gemm`` and ``product_gemm`` count
    into it under their kernel's key."""
    assert tuple(_cuda_build.launch_counts()) == LAUNCH_KEYS
    assert _cuda_build.launch_counts() == _cuda_build.LAUNCHES
    assert _cuda_build.launch_counts() is not _cuda_build.LAUNCHES
    assert set(products.LAUNCH_KEYS.values()) <= set(LAUNCH_KEYS)
    calls = _stub_launch(monkeypatch, brow, products)
    before = _cuda_build.launch_counts()
    a = torch.randn(64, 512).as_subclass(_OnCard)
    brow.brow_gemm(a, torch.randn(512, 256).as_subclass(_OnCard),
                   out=torch.empty(64, 256).as_subclass(_OnCard))
    products.product_gemm(a, torch.randn(512, 4).as_subclass(_OnCard),
                          out=torch.empty(64, 4).as_subclass(_OnCard))
    products.product_gemm(a[:, :128], torch.randn(128, 32).as_subclass(_OnCard),
                          out=torch.empty(64, 32).as_subclass(_OnCard))
    assert calls == [("brow_gemm", None), ("product_gemm", "deep_narrow_gemm"),
                     ("product_gemm", "batch_depth_gemm")]
    after = _cuda_build.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "brow_gemm": 1, "deep_narrow_gemm": 1, "batch_depth_gemm": 1}


def test_a_loop_report_counts_its_products_and_names_the_span(monkeypatch):
    """``launch_loop`` passes a C loop a report of ``LoopReport``'s 7 numbers
    just before the stream, adds the product kernels it names to LAUNCHES
    and returns it; ``span_attrs(report_of(rows))`` gives the launch span
    that report where the rows are on the card and hold a step, zeros
    elsewhere."""
    assert _cuda_build.LoopReport._fields[2:5] == products.ROUTES
    _stub_launch(monkeypatch, _cuda_build, fill=(70, 19, 5, 6, 2, 560, 1234))
    monkeypatch.setattr(_cuda_build, "_last_report", _cuda_build.NO_REPORT)
    before = _cuda_build.launch_counts()
    report = _cuda_build.launch_loop("gan_train", "cuda:0", 1, 2)
    assert report == _cuda_build.LoopReport(70, 19, 5, 6, 2, 560, 1234)
    after = _cuda_build.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "gan_train": 1, "brow_gemm": 19, "deep_narrow_gemm": 5, "batch_depth_gemm": 6,
        "sgemm": 2}
    rows = torch.zeros(3, 11).as_subclass(_OnCard)
    assert _cuda_build.span_attrs(_cuda_build.report_of(rows)) == {
        "kernels": 70, "head_kernels": 560, "head_ns": 1234,
        "deep_narrow": 5, "batch_depth": 6, "sgemm": 2}
    zeros = dict.fromkeys(("kernels", "head_kernels", "head_ns", *products.ROUTES), 0)
    assert _cuda_build.span_attrs(_cuda_build.report_of(torch.zeros(3, 11))) == zeros
    assert _cuda_build.span_attrs(_cuda_build.report_of(rows[:0])) == zeros


def _c_entry(source: str, name: str) -> list[str]:
    """The parameters of C entry point ``name`` in ``csrc/<source>``."""
    text = (_cuda_build.CSRC / source).read_text()
    (params,) = re.findall(rf"^int {name}\(([^)]*)\)\s*\{{", text, flags=re.M)
    return [" ".join(p.split()) for p in params.split(",")]


@pytest.mark.parametrize("source, name", [("forward_train.cu", "pigan_forward_train"),
                                          ("gan_train.cu", "pigan_gan_train"),
                                          ("gan_train.cu", "pigan_gan_ensemble_train")])
def test_training_entry_points_take_a_report(source, name):
    """Each training C loop writes what it enqueued into a report its caller
    passes just before the stream, ``ENTRY_POINTS`` declares as many
    arguments, and no process-wide counter or its reader is left in
    ``csrc/``."""
    params = _c_entry(source, name)
    assert params[-2:] == ["long long* report", "void* stream_ptr"]
    argtypes = _cuda_build.ENTRY_POINTS[name]
    assert len(argtypes) == len(params)
    assert argtypes[-2] is ctypes.POINTER(ctypes.c_longlong)
    for path in _cuda_build.CSRC.iterdir():
        assert not re.search(r"_kernels_enqueued|_head_ns|g_routes", path.read_text()), path


def test_wrapper_on_the_cpu_launches_nothing():
    """On CPU tensors ``forward_train`` is its plain version: no launch, no
    batch-row launch and no launch of the other products is counted."""
    spec, start, streams = _one_step(128, 0.2)
    before = dict(ft.LAUNCHES)
    bufs = [t.clone() for t in start]
    rows = ft.forward_train(*bufs, streams, spec)
    plain = [t.clone() for t in start]
    want = ft.forward_train_plain(*plain, streams, spec)
    assert torch.equal(rows, want) and all(map(torch.equal, bufs, plain))
    assert ft.LAUNCHES == before


# -- the other products: csrc/train_common.cuh's dispatch ------------------------

# launches a step by route (deep narrow, batch depth, SGEMM): the input layer
# (depth 4) on the SGEMM, the six weight gradients (depth B) batch depth;
# bfloat16 also the head's 8 metrics columns forward (depth 256, deep
# narrow), their dW rows apart (batch depth) and their 8-deep input-gradient
# term (SGEMM)
K1_PER_ROUTE = {"float32": (0, 6, 1), "bfloat16": (1, 7, 2)}


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_lists_its_dispatch_products_by_route(dtype, rate):
    """K1's other products by route as its C loop launches them
    (test_torch_cuda.py holds the two equal), none a batch-row product;
    every weight gradient's depth the batch; bfloat16 operands on hidden
    layers 2-5's and the head's spectrum rows' weight gradients only; the
    dropout rate changes none."""
    _, spec = _spec(dtype, rate)
    prods = ft.gemm_products(spec, B)
    assert tuple(products.routes_of(prods).values()) == K1_PER_ROUTE[dtype]
    assert len({p.name for p in prods}) == len(prods)
    brows = {(p.m, p.n, p.k, p.ak, p.bnc) for p in ft.brow_products(spec, B)}
    for p in prods:
        assert (p.m, p.n, p.k, p.ak, p.bnc) not in brows, p
        if p.name.startswith("dW"):
            assert p.route == "batch_depth" and p.k == B and not p.bias, p
            assert p.rnd == (spec.bf16 and p.name not in ("dW layer 1", "dW head, metrics rows"))
        else:
            assert not p.rnd, p
    assert prods == ft.gemm_products(_spec(dtype, 0.2 - rate)[1], B)


K1_DW = sorted({(p.name, p.m, p.n, p.k, p.rnd) for d in ("float32", "bfloat16")
                for p in ft.gemm_products(_spec(d)[1], B) if p.name.startswith("dW")},
               key=lambda p: (p[4], p[0]))


@pytest.mark.parametrize("product", K1_DW, ids=[f"{p[0]}-{'bf16' if p[4] else 'fp32'}"
                                                .replace(" ", "_").replace(",", "")
                                                for p in K1_DW])
def test_weight_gradient_against_the_jax_kernel(product):
    """A K1 weight gradient on the same numpy operands: through
    ``product_gemm`` on the CPU (the batch-depth kernel's FMA chain) in the
    port's layout (dW (out, in) = dt^T x) and through the JAX kernel's
    ``dotT0`` (x^T dt, W as (in, out)); equal within the float32 sum bound of
    both (the same products, exact under bfloat16, in two orders)."""
    name, m, n, k, rnd = product
    rng = np.random.default_rng(m + n + k)
    dt = rng.standard_normal((k, m)).astype(np.float32)        # (B, out)
    x = rng.standard_normal((k, n)).astype(np.float32)         # (B, in)
    t = jnp.bfloat16 if rnd else jnp.float32
    want = np.asarray(jax.lax.dot_general(jnp.asarray(x).astype(t), jnp.asarray(dt).astype(t),
                                          (((0,), (0,)), ((), ())),
                                          preferred_element_type=jnp.float32)).T
    a, b = torch.tensor(dt).t(), torch.tensor(x)               # A m-contiguous, B n-contiguous
    assert products.product_route(n, k) == "batch_depth"
    got = products.product_gemm(a, b, rnd=rnd)
    assert torch.equal(got, products.batch_depth_plain(a, b, rnd=rnd))
    ra, rb = (a.bfloat16().float(), b.bfloat16().float()) if rnd else (a, b)
    bound = 2 * (k + 2) * 2.0 ** -24 * (ra.double().abs() @ rb.double().abs())
    err = (got.double() - torch.tensor(want).double()).abs()
    assert bool((err <= bound).all()), (name, float((err / bound).max()))
