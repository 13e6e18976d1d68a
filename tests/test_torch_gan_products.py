"""The batch-row products of the GAN training kernel, on the CPU.

K2 and K3 (``csrc/gan_train.cu``) launch every product whose rows are the
batch (M = B or 2B: the forward layers and input gradients of G, D and F)
through ``csrc/brow_gemm.cuh``: cluster split-K, the partial products of S
K slices summed in rank order, fp32 FMAs or, on bfloat16 operands, bf16
``mma.sync``.  Here: the launch plan (``brow_plan``, which mirrors the C
rule) for every such product of every K2 path; the step's list of them
(``brow_products``); and the kernel's arithmetic in plain torch
(``brow_gemm_plain``) against a float64 product and against the JAX TPU
kernel's own bfloat16 products (``megakernel.py``'s ``mm`` and ``dotT1``).
The kernel itself is held against ``brow_gemm_plain`` on the card in
test_torch_cuda.py.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config
from pigan_thz_torch.ops import brow, products
from pigan_thz_torch.ops import gan_train as gt
from pigan_thz_torch.train.steps import StepSettings

torch.set_num_threads(1)

B = 64   # the published batch size
PATHS = {
    "through_f": dict(detach_forward=False),
    "detached": dict(detach_forward=True),
    "cycle_through_f": dict(detach_forward=False, cycle_w=1.0),
    "cycle_detached": dict(detach_forward=True, cycle_w=1.0),
    "stability": dict(detach_forward=False, stability_w=1.0),
    "wgan_gp_through_f": dict(detach_forward=False, gan_loss="wgan_gp"),
    "bf16_through_f": dict(detach_forward=False, compute_dtype="bfloat16"),
    "bf16_detached": dict(detach_forward=True, compute_dtype="bfloat16"),
    "bf16_wgan_gp_cycle_stability": dict(detach_forward=False, gan_loss="wgan_gp",
                                         cycle_w=1.0, stability_w=1.0,
                                         compute_dtype="bfloat16"),
}
# batch-row products a step at the published widths, D updated / gated off:
# 19 through F (G 2 forward + 1 dx, D 2 + 1 on 2B rows, the G phase's D 2 +
# 1, F 5 forward and 5 input-gradient), F's five input-gradient products
# fewer detached; a second G pass 3 more (4 with cycle's input gradient);
# WGAN-GP's penalty 6 on a D-update step
PER_STEP = {
    "through_f": (19, 18), "detached": (14, 13), "cycle_through_f": (23, 22),
    "cycle_detached": (17, 16), "stability": (22, 21), "wgan_gp_through_f": (25, 18),
    "bf16_through_f": (19, 18), "bf16_detached": (14, 13),
    "bf16_wgan_gp_cycle_stability": (32, 25),
}


def _spec(knobs):
    knobs = dict(knobs)
    cfg = default_config()
    dtype = knobs.pop("compute_dtype", "float32")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype=dtype))
    return gt.gan_train_spec(cfg, StepSettings.from_config(cfg, **knobs))


def _all_products():
    out = {}
    for knobs in PATHS.values():
        for update_d in (True, False):
            for p in gt.brow_products(_spec(knobs), B, update_d):
                out[(p.m, p.n, p.k)] = p
    return out


MNK = sorted({key[:3] for key in _all_products()})


@pytest.mark.parametrize("update_d", [True, False], ids=["d_update", "d_gated"])
@pytest.mark.parametrize("path", list(PATHS))
def test_step_lists_its_batch_row_products(path, update_d):
    """Every product ``brow_products`` lists has the batch as its rows and
    a layer's widths (at least 32) as N and K; the count a step is the one
    the C loop enqueues (test_torch_cuda.py holds the two equal)."""
    spec = _spec(PATHS[path])
    prods = gt.brow_products(spec, B, update_d)
    assert len(prods) == PER_STEP[path][0 if update_d else 1]
    assert len({p.name for p in prods}) == len(prods)
    for p in prods:
        assert p.m in (B, 2 * B) and p.n >= 32 and p.k >= 32, p
        assert p.ak, p
        # bfloat16 operands exactly where the TPU kernel rounds them: its MXU
        # products, and F's head only over the spectrum columns
        assert p.rnd == (spec.bf16 and p.n != spec.spectrum_dim + 8
                         and p.k != spec.spectrum_dim + 8), p
    if spec.bf16:
        names = {p.name for p in prods}
        assert "F head, spectrum columns" in names and "F head" not in names


@pytest.mark.parametrize("shape", MNK, ids=[f"{m}x{n}x{k}" for m, n, k in MNK])
def test_plan_of_every_product(shape):
    """At least 32 columns of depth a block, S in {1, 2, 4, 8} dividing the
    grid's x, no empty slice, the blocks at 128 on an H100 where the depth
    allows; the grid's x and y the same for 1, 2, 4 and 8 members."""
    m, n, k = shape
    plan = brow.brow_plan(m, n, k)
    assert plan.split in (1, 2, 4, 8)
    assert plan.split == 1 or plan.slice >= brow.BROW_MIN_DEPTH
    assert plan.slice * plan.split >= k and plan.slice * (plan.split - 1) < k
    assert plan.tiles_m == -(-m // 64) and plan.tiles_n == -(-n // 32)
    grids = {members: plan.grid(members) for members in (1, 2, 4, 8)}
    assert all(g[:2] == grids[1][:2] and g[2] == mm for mm, g in grids.items())
    assert grids[1][0] % plan.split == 0
    blocks = plan.blocks
    assert blocks >= 128 or plan.split == brow.BROW_MAX_SPLIT or -(-k // (2 * plan.split)) < 32
    assert blocks < 256    # the smallest S that reaches 128, never past it
    # the plan reads the SM count, nothing else of the card
    assert brow.brow_plan(m, n, k, sms=132) == brow.brow_plan(m, n, k, sms=128)


def test_plan_examples():
    assert brow.brow_plan(64, 512, 250).split == 8      # 16 tiles x 8
    assert brow.brow_plan(128, 512, 254).split == 4     # 32 tiles x 4
    assert brow.brow_plan(64, 1024, 512).split == 4
    assert brow.brow_plan(64, 4, 40).split == 1          # 40 columns: no room to split
    assert brow.brow_plan(512, 512, 1024).split == 1     # 128 tiles already
    assert brow.brow_plan(64, 512, 250, sms=64) == brow.BrowPlan(4, 1, 16, 63)
    with pytest.raises(ValueError):
        brow.brow_plan(0, 512, 250)


def _operands(m, n, k, ak, bnc, seed, members=None):
    """A (m, k) and B (k, n) in the kernel's layouts (views of contiguous
    arrays: A k-contiguous with ``ak``, else m-contiguous; B n-contiguous with
    ``bnc``, else k-contiguous), bias (n,) and C (m, n), from numpy."""
    rng = np.random.default_rng(seed)
    lead = () if members is None else (members,)
    a = rng.standard_normal((*lead, m, k)) if ak else rng.standard_normal((*lead, k, m))
    b = rng.standard_normal((*lead, k, n)) if bnc else rng.standard_normal((*lead, n, k))
    a = torch.tensor(a, dtype=torch.float32)
    b = torch.tensor(b, dtype=torch.float32)
    a = a if ak else a.transpose(-1, -2)
    b = b if bnc else b.transpose(-1, -2)
    bias = torch.tensor(rng.standard_normal((*lead, n)), dtype=torch.float32)
    c = torch.tensor(rng.standard_normal((*lead, m, n)), dtype=torch.float32)
    return a, b, bias, c


def _sum_bound(a, b, c, bias, k, split):
    """The worst-case error of a float32 sum of the K products, the S - 1
    partial sums, C and the bias, in any order: (K + S + 2) u times the sum
    of the magnitudes (Higham, Accuracy and Stability, eq. 3.5), u = 2^-24."""
    mag = a.double().abs() @ b.double().abs()
    if c is not None:
        mag = mag + c.double().abs()
    if bias is not None:
        mag = mag + bias.double().abs()
    return (k + split + 2) * 2.0 ** -24 * mag


def _want64(a, b, c, bias, rnd):
    if rnd:
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    out = a.double() @ b.double()
    if c is not None:
        out = c.double() + out
    return out if bias is None else out + bias.double()


@pytest.mark.parametrize("layout", ["nt", "nn", "tn", "tt"])
@pytest.mark.parametrize("shape", MNK, ids=[f"{m}x{n}x{k}" for m, n, k in MNK])
def test_plain_arithmetic_against_float64(shape, layout):
    """The kernel's arithmetic (split-K over the plan's slices, rank order)
    within the float32 worst-case sum bound of a float64 product, for every
    flag: AK and BNC (the layout), bfloat16 operands, ACC, bias.  With
    bfloat16 operands the float64 product is of the rounded operands: the
    products are exact in float32, so only the sums round."""
    m, n, k = shape
    ak, bnc = layout[0] == "n", layout[1] == "n"
    a, b, bias, c = _operands(m, n, k, ak, bnc, seed=m * n + k)
    split = brow.brow_plan(m, n, k).split
    for rnd, acc, with_bias in itertools.product((False, True), repeat=3):
        cc = c if acc else None
        bb = bias if with_bias else None
        got = brow.brow_gemm_plain(a, b, bb, cc, rnd, split)
        want = _want64(a, b, cc, bb, rnd)
        ra, rb = (a, b) if not rnd else (a.bfloat16().float(), b.bfloat16().float())
        err = (got.double() - want).abs()
        assert bool((err <= _sum_bound(ra, rb, cc, bb, k, split)).all()), (
            rnd, acc, with_bias, float(err.max()))
        assert got.dtype == torch.float32 and got.shape == (m, n)


@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_every_split_stays_within_the_bound(split):
    """Any cluster size computes the same product within the sum bound,
    and its partial sums are the slices' own, in rank order."""
    m, n, k = 64, 512, 250
    a, b, bias, _ = _operands(m, n, k, True, False, seed=split)
    got = brow.brow_gemm_plain(a, b, bias, split=split)
    want = _want64(a, b, None, bias, False)
    assert bool(((got.double() - want).abs() <= _sum_bound(a, b, None, bias, k, split)).all())
    w = -(-k // split)
    parts = [a[:, r * w:(r + 1) * w] @ b[r * w:(r + 1) * w] for r in range(split)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    assert torch.equal(got, total + bias)


def test_bf16_products_are_exact():
    """A product of two bfloat16 values is exact in float32 (8 + 8
    significant bits < 24): with K = 1 the bfloat16 path equals the float64
    product of the rounded operands to the bit, and the rounding is round
    to nearest even (the kernel's __float2bfloat16_rn)."""
    a, b, _, _ = _operands(64, 512, 1, True, False, seed=7)
    got = brow.brow_gemm_plain(a * 1e3, b * 1e-3, rnd=True)
    want = (a * 1e3).bfloat16().double() @ (b * 1e-3).bfloat16().double()
    assert torch.equal(got.double(), want)
    halfway = torch.tensor([[1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8]])
    assert brow.brow_gemm_plain(halfway, torch.ones(2, 1), rnd=True).item() == 1.0 + (
        1.0 + 2 * 2.0 ** -7)


def test_plain_takes_a_member_axis():
    """Members stacked on a leading axis: member m's product is the one of
    its operands alone, bit for bit."""
    a, b, bias, c = _operands(128, 256, 512, True, True, seed=3, members=4)
    got = brow.brow_gemm_plain(a, b, bias, c, split=4)
    for mm in range(4):
        assert torch.equal(got[mm], brow.brow_gemm_plain(a[mm], b[mm], bias[mm], c[mm], split=4))


def test_wrapper_on_the_cpu_is_the_plain_version():
    """For CPU tensors ``brow_gemm`` computes ``brow_gemm_plain`` with the
    plan's split (or the forced one) and launches nothing."""
    a, b, bias, c = _operands(64, 512, 250, True, False, seed=11)
    before = dict(gt.LAUNCHES)
    got = brow.brow_gemm(a, b, bias)
    assert torch.equal(got, brow.brow_gemm_plain(a, b, bias, split=8))
    out = c.clone()
    brow.brow_gemm(a, b, out=out, acc=True, rnd=True, split=2)
    assert torch.equal(out, brow.brow_gemm_plain(a, b, None, c, True, 2))
    shared = brow.brow_gemm(a.expand(3, -1, -1), b)
    assert shared.shape == (3, 64, 512) and torch.equal(shared[2], brow.brow_gemm_plain(a, b,
                                                                                      split=8))
    assert gt.LAUNCHES == before
    with pytest.raises(ValueError, match="route"):
        brow.brow_gemm(a, b, route="cublas")
    with pytest.raises(ValueError, match="acc"):
        brow.brow_gemm(a, b, acc=True)


# The JAX TPU kernel's bfloat16 products (megakernel.py:839-857): operands
# cast to bfloat16, products accumulated in float32.
def _jax_mm(a, b):
    return jnp.dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)


def _jax_dot_t1(a, b):
    return jax.lax.dot_general(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                               (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32)


@pytest.mark.parametrize("kind", ["mm", "dotT1"])
@pytest.mark.parametrize("shape", [(64, 512, 250), (128, 256, 512), (64, 256, 258)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bf16_plain_against_the_jax_kernels_products(shape, kind):
    """The same numpy operands through the TPU kernel's ``mm`` (x @ W, W as
    (in, out)) or ``dotT1`` (dz @ W^T) in JAX on the CPU and through
    ``brow_gemm_plain`` with bfloat16 operands in the layout the port's step
    gives them (W as (out, in)): equal within the float32 sum bound of both
    (the same exact products, summed in two orders)."""
    m, n, k = shape
    rng = np.random.default_rng(m + n + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if kind == "mm":
        w_in_out = rng.standard_normal((k, n)).astype(np.float32)
        want = np.asarray(_jax_mm(jnp.asarray(x), jnp.asarray(w_in_out)))
        w = torch.tensor(np.ascontiguousarray(w_in_out.T))      # (out, in): BNC false
        b_op = w.t()
    else:
        w_in_out = rng.standard_normal((n, k)).astype(np.float32)  # the layer's (in, out)
        want = np.asarray(_jax_dot_t1(jnp.asarray(x), jnp.asarray(w_in_out)))
        w = torch.tensor(np.ascontiguousarray(w_in_out.T))      # (out, in) = (k, n): BNC
        b_op = w
    a = torch.tensor(x)
    split = brow.brow_plan(m, n, k).split
    got = brow.brow_gemm_plain(a, b_op, rnd=True, split=split)
    ra, rb = a.bfloat16().float(), b_op.bfloat16().float()
    bound = 2 * _sum_bound(ra, rb, None, None, k, split)
    assert bool(((got.double() - torch.tensor(want).double()).abs() <= bound).all())


# -- the other products: csrc/train_common.cuh's dispatch ------------------------
#
# Every product of a K2 step that ``brow_products`` does not list goes through
# the dispatch, which picks a kernel from N and K: deep narrow (N <= 8, depth
# 128-1024), batch depth (depth 32-128) or the tiled SGEMM.  Launches a step
# by route (deep narrow, batch depth, SGEMM), D updated / gated off: the heads
# of G (4 wide) and of D (1 wide, on 2B and on B rows) and the adversarial
# pass's 4 parameter columns deep narrow, F's input gradient too through F;
# the weight gradients (D's three on a D-update step, depth 2B; G's three,
# depth B) batch depth; F's 4-deep input layer and G's head input gradient
# on the SGEMM; a second G pass 1 / 3 / 1 more; WGAN-GP's penalty 2 weight
# gradients more on a D-update step; bfloat16 F's 8 metrics columns forward
# (deep narrow) and, through F, their 8-deep input-gradient term (SGEMM).

PER_ROUTE = {
    "through_f": ((5, 6, 2), (5, 3, 2)), "detached": ((4, 6, 2), (4, 3, 2)),
    "cycle_through_f": ((6, 9, 3), (6, 6, 3)), "cycle_detached": ((5, 9, 3), (5, 6, 3)),
    "stability": ((6, 9, 3), (6, 6, 3)), "wgan_gp_through_f": ((5, 8, 2), (5, 3, 2)),
    "bf16_through_f": ((6, 6, 3), (6, 3, 3)), "bf16_detached": ((5, 6, 2), (5, 3, 2)),
    "bf16_wgan_gp_cycle_stability": ((8, 14, 5), (8, 9, 5)),
}


def _gemm_products():
    out = {}
    for knobs in PATHS.values():
        for update_d in (True, False):
            for p in gt.gemm_products(_spec(knobs), B, update_d):
                out.setdefault(p[1:], p)
    return [out[k] for k in sorted(out)]


GEMM_PRODUCTS = _gemm_products()


def _gemm_id(p):
    return (f"{p.m}x{p.n}x{p.k}-{p.route}-{'n' if p.ak else 't'}{'n' if p.bnc else 't'}"
            f"{'-bf16' if p.rnd else ''}{'-acc' if p.acc else ''}")


@pytest.mark.parametrize("update_d", [True, False], ids=["d_update", "d_gated"])
@pytest.mark.parametrize("path", list(PATHS))
def test_step_lists_its_dispatch_products_by_route(path, update_d):
    """The step's other products: counts by route as the C loop launches
    them (test_torch_cuda.py holds the two equal); each on its route for its
    shape (heads at most 8 wide over a deep layer, weight gradients over the
    batch, the depth-4 and depth-8 products on the SGEMM); bfloat16 operands
    exactly on the TPU kernel's MXU products (the hidden layers' weight
    gradients and the adversarial columns), never on a head."""
    spec = _spec(PATHS[path])
    prods = gt.gemm_products(spec, B, update_d)
    assert tuple(products.routes_of(prods).values()) == PER_ROUTE[path][0 if update_d else 1]
    assert len({p.name for p in prods}) == len(prods)
    brows = {(p.m, p.n, p.k, p.ak, p.bnc) for p in gt.brow_products(spec, B, update_d)}
    for p in prods:
        assert (p.m, p.n, p.k, p.ak, p.bnc) not in brows, p
        if p.route == "deep_narrow":
            assert p.n <= 8 and p.k in spec.g_hidden + spec.d_hidden + spec.f_spec.dims[1:2], p
        elif p.route == "batch_depth":
            assert p.k in (B, 2 * B) and not p.ak and p.bnc and not p.bias, p
        else:
            assert p.k in (4, 8), p
        hidden_dw = p.route == "batch_depth" and min(p.m, p.n) > 8
        assert p.rnd == (spec.bf16 and (hidden_dw or "parameter columns" in p.name)), p
        assert p.acc == ("penalty" in p.name or "metrics columns" in p.name and not p.bias), p


@pytest.mark.parametrize("n, k, route", [
    (1, 256, "deep_narrow"), (4, 512, "deep_narrow"), (8, 128, "deep_narrow"),
    (8, 1024, "deep_narrow"), (9, 256, "sgemm"), (4, 1025, "sgemm"), (4, 127, "batch_depth"),
    (256, 128, "batch_depth"), (512, 64, "batch_depth"), (4, 32, "batch_depth"),
    (256, 31, "sgemm"), (256, 4, "sgemm"), (256, 8, "sgemm"), (256, 129, "sgemm")])
def test_route_rule(n, k, route):
    """The rule reads N and K only (never M, never the members)."""
    assert products.product_route(n, k) == route
    assert products.GemmProduct("x", 7, n, k, True, True, False, False, False).route == route


def _gemm_bound(p, a, b, bias, c):
    """The float32 worst-case sum bound (Higham, eq. 3.5) of the kernel's
    longest chain of roundings, + 1: a lane's ceil(K / 32) FMAs, the five
    butterfly adds, C and the bias (deep narrow); K FMAs, C and the bias
    (batch depth and the SGEMM); times sum |a| |b| (+ |C| + |bias|)."""
    mag = a.double().abs() @ b.double().abs()
    if c is not None:
        mag = mag + c.double().abs()
    if bias is not None:
        mag = mag + (bias.double().abs().unsqueeze(-2) if bias.ndim > 1 else bias.double().abs())
    chain = (-(-p.k // 32) + 5 if p.route == "deep_narrow" else p.k) + 2 + 1
    return chain * 2.0 ** -24 * mag


@pytest.mark.parametrize("members", [1, 3])
@pytest.mark.parametrize("p", GEMM_PRODUCTS, ids=[_gemm_id(p) for p in GEMM_PRODUCTS])
def test_plain_twin_against_float64(p, members):
    """Each product's plain twin (its kernel's sum order) within the float32
    worst-case bound of float64, with and without bfloat16 operands (then
    against float64 of the rounded operands: the products are exact, only
    the sums round), C += and the bias as the step gives them; at 3
    members each member's result is its own operands' alone, bit for bit."""
    a, b, bias, c = products.step_operands(p, members, seed=p.m + p.n + p.k, device="cpu")
    for rnd in (False, True):
        got = products.product_gemm_plain(a, b, bias, c, rnd)
        ra, rb = (a.bfloat16().float(), b.bfloat16().float()) if rnd else (a, b)
        want = products.product_gemm_plain(ra.double(), rb.double(),
                                     None if bias is None else bias.double(),
                                     None if c is None else c.double())
        exact = ra.double() @ rb.double()
        if c is not None:
            exact = exact + c.double()
        if bias is not None:
            exact = exact + (bias.double().unsqueeze(-2) if members > 1 else bias.double())
        bound = _gemm_bound(p, ra, rb, bias, c)
        assert got.dtype == torch.float32 and got.shape == exact.shape
        assert bool(((got.double() - exact).abs() <= bound).all()), rnd
        assert bool(((want - exact).abs() <= 1e-12 * (1 + bound / 2.0 ** -24)).all())
    if members > 1:
        full = products.product_gemm_plain(a, b, bias, c, p.rnd)
        for m in range(members):
            solo = products.product_gemm_plain(a[m], b[m], None if bias is None else bias[m],
                                         None if c is None else c[m], p.rnd)
            assert torch.equal(full[m], solo), m


def _f32(x):
    return np.float32(x)


def _fma32(acc, x, y):
    """fmaf: x y + acc rounded once (the float64 sum of two float32 values'
    product and a float32 is exact to 2^-53, then one rounding to float32)."""
    return np.float32(np.float64(acc) + np.float64(x) * np.float64(y))


def test_deep_narrow_twin_is_the_lane_and_butterfly_order():
    """A scalar reference of the deep narrow kernel's order: lane l sums
    k = l, l + 32, ... with one rounding a term, then lane l + off is added
    to lane l at off = 16, 8, 4, 2, 1; C + that + bias.  The twin equals it
    bit for bit, at a depth that is no multiple of 32; summing the same
    terms in k order does not (the order is the twin's)."""
    rng = np.random.default_rng(5)
    m, n, k = 3, 2, 200
    a = rng.standard_normal((m, k)).astype(np.float32) * np.logspace(0, 6, k).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    want = np.empty((m, n), np.float32)
    for i in range(m):
        for j in range(n):
            lanes = [_f32(0)] * 32
            for kk in range(k):
                lanes[kk % 32] = _fma32(lanes[kk % 32], a[i, kk], b[kk, j])
            off = 16
            while off:
                lanes = [_f32(lanes[x] + lanes[x + off]) for x in range(off)]
                off //= 2
            want[i, j] = _f32(_f32(c[i, j] + lanes[0]) + bias[j])
    got = products.deep_narrow_plain(torch.tensor(a), torch.tensor(b), torch.tensor(bias),
                               torch.tensor(c))
    assert np.array_equal(got.numpy(), want)
    in_k_order = products.batch_depth_plain(torch.tensor(a), torch.tensor(b), torch.tensor(bias),
                                      torch.tensor(c))
    assert not torch.equal(in_k_order, got)


def test_batch_depth_twin_is_one_fma_chain_in_k_order():
    """A scalar reference of the batch-depth kernel's (and the SGEMM's)
    order: each output one chain of FMAs over k = 0 ... K - 1, then C +
    that + bias; bfloat16 operands rounded to nearest even first."""
    rng = np.random.default_rng(6)
    m, n, k = 4, 3, 64
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    for rnd in (False, True):
        ta, tb = torch.tensor(a), torch.tensor(b)
        ra = ta.bfloat16().float().numpy() if rnd else a
        rb = tb.bfloat16().float().numpy() if rnd else b
        want = np.empty((m, n), np.float32)
        for i in range(m):
            for j in range(n):
                s = _f32(0)
                for kk in range(k):
                    s = _fma32(s, ra[i, kk], rb[kk, j])
                want[i, j] = _f32(s + bias[j])
        got = products.batch_depth_plain(ta, tb, torch.tensor(bias), rnd=rnd)
        assert np.array_equal(got.numpy(), want), rnd


def test_product_wrapper_on_the_cpu_is_the_plain_twin():
    """For CPU tensors ``product_gemm`` computes its route's twin (the
    shape's or a forced one) and launches nothing; a forced route outside
    its limits, or an unknown one, is refused."""
    p = products.GemmProduct("x", 64, 4, 512, True, True, True, True, False)
    a, b, _, c = products.step_operands(p, seed=1, device="cpu")
    before = dict(gt.LAUNCHES)
    out = c.clone()
    products.product_gemm(a, b, out=out, acc=True, rnd=True)
    assert torch.equal(out, products.deep_narrow_plain(a, b, None, c, True))
    forced = products.product_gemm(a[:, :128], b[:128], route="batch_depth")
    assert torch.equal(forced, products.batch_depth_plain(a[:, :128], b[:128]))
    shared = products.product_gemm(a.expand(3, -1, -1), b)
    assert shared.shape == (3, 64, 4) and torch.equal(shared[1], products.deep_narrow_plain(a, b))
    assert gt.LAUNCHES == before
    with pytest.raises(ValueError, match="deep narrow"):
        products.product_gemm(torch.ones(4, 2048), torch.ones(2048, 4), route="deep_narrow")
    with pytest.raises(ValueError, match="batch-depth"):
        products.product_gemm(a, b, route="batch_depth")
    with pytest.raises(ValueError, match="route"):
        products.product_gemm(a, b, route="cublas")
    with pytest.raises(ValueError, match="acc"):
        products.product_gemm(a, b, acc=True)
